"""Runtime configuration-state cache — the dispatch-time analogue of
``passes/dedup.py``.

The compile-time dedup pass (§5.4) removes a setup field when SSA analysis
*proves* the register already holds the value. At runtime no proof is needed:
the host simply remembers what it last wrote to each device and elides any
write whose value the device demonstrably still holds (configuration
registers retain their contents between launches, §3.2 — the same hardware
property both layers exploit).

Multi-tenancy complicates retention: two streams sharing one device would
clobber each other's register file, so the cache models *per-tenant
contexts* — independent snapshots of the register state each tenant believes
the device holds — bounded by ``max_contexts`` with LRU eviction, like
hardware context slots. A context miss (first dispatch, or re-admission
after eviction) forces a full re-send; a hit sends only the delta.

Values are compared bit-exactly (``numpy.array_equal`` semantics), so the
cache works both for the cycle-approximate accfg register model (ints) and
for real launch descriptors (scalars / small arrays)."""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Mapping

import numpy as np


def _same(a: Any, b: Any) -> bool:
    """Bit-exact value equality across ints, floats and small arrays."""
    if a is b:
        return True
    try:
        return bool(np.array_equal(np.asarray(a), np.asarray(b)))
    except Exception:
        return a == b


def nbytes_of(value: Any) -> int:
    """Default byte accounting: the numpy wire size of the value."""
    return int(np.asarray(value).nbytes)


def elision_ratio(bytes_sent: float, bytes_elided: float) -> float:
    """Fraction of configuration bytes kept off the wire — the one formula
    every traffic report in this package shares."""
    total = bytes_sent + bytes_elided
    return bytes_elided / total if total else 0.0


@dataclass(frozen=True)
class WritePlan:
    """The outcome of routing one launch descriptor through the cache."""

    sent: dict[str, Any]  # fields that must cross the host→device boundary
    elided: dict[str, Any]  # fields the device already holds
    bytes_sent: int
    bytes_elided: int
    context_hit: bool  # was the tenant's context resident?

    @property
    def total_bytes(self) -> int:
        return self.bytes_sent + self.bytes_elided


@dataclass
class CacheStats:
    hits: int = 0  # context-resident dispatches
    misses: int = 0  # cold / evicted contexts
    evictions: int = 0
    bytes_sent: int = 0
    bytes_elided: int = 0
    fields_sent: int = 0
    fields_elided: int = 0

    @property
    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0

    @property
    def elision_ratio(self) -> float:
        """Fraction of configuration bytes the cache kept off the wire."""
        return elision_ratio(self.bytes_sent, self.bytes_elided)


class ConfigStateCache:
    """Last-written register values for one device, per tenant context.

    ``bytes_of(name, value)`` prices one field; the default uses the value's
    numpy size, while the scheduler substitutes the accelerator model's
    ``bytes_per_field`` so accounting matches the paper's register model.
    """

    def __init__(
        self,
        max_contexts: int = 4,
        bytes_of: Callable[[str, Any], int] | None = None,
    ):
        assert max_contexts >= 1
        self.max_contexts = max_contexts
        self._bytes_of = bytes_of or (lambda name, value: nbytes_of(value))
        self._contexts: OrderedDict[Any, dict[str, Any]] = OrderedDict()
        self.stats = CacheStats()

    # -- queries (no mutation) ----------------------------------------------

    def context(self, tenant: Any) -> dict[str, Any] | None:
        return self._contexts.get(tenant)

    def tenants(self) -> list[Any]:
        """Resident tenants, LRU-oldest first."""
        return list(self._contexts)

    def plan(self, tenant: Any, fields: Mapping[str, Any]) -> WritePlan:
        """Split ``fields`` into sent/elided against the tenant's context
        without touching cache state (used for affinity scoring)."""
        ctx = self._contexts.get(tenant)
        sent: dict[str, Any] = {}
        elided: dict[str, Any] = {}
        for name, value in fields.items():
            if ctx is not None and name in ctx and _same(ctx[name], value):
                elided[name] = value
            else:
                sent[name] = value
        return WritePlan(
            sent=sent,
            elided=elided,
            bytes_sent=sum(self._bytes_of(n, v) for n, v in sent.items()),
            bytes_elided=sum(self._bytes_of(n, v) for n, v in elided.items()),
            context_hit=ctx is not None,
        )

    def elidable_bytes(self, tenant: Any, fields: Mapping[str, Any]) -> int:
        """Affinity metric: bytes this device would keep off the wire."""
        return self.plan(tenant, fields).bytes_elided

    # -- dispatch ------------------------------------------------------------

    def dispatch(self, tenant: Any, fields: Mapping[str, Any]) -> WritePlan:
        """Route one launch's configuration through the cache: compute the
        write delta, commit it to the tenant's context, update LRU + stats."""
        plan = self.plan(tenant, fields)
        if plan.context_hit:
            self.stats.hits += 1
            self._contexts.move_to_end(tenant)
        else:
            self.stats.misses += 1
            while len(self._contexts) >= self.max_contexts:
                self._contexts.popitem(last=False)  # LRU out
                self.stats.evictions += 1
            self._contexts[tenant] = {}
        self._contexts[tenant].update(fields)
        self.stats.bytes_sent += plan.bytes_sent
        self.stats.bytes_elided += plan.bytes_elided
        self.stats.fields_sent += len(plan.sent)
        self.stats.fields_elided += len(plan.elided)
        return plan

    # -- migration / restore -------------------------------------------------

    def install_context(self, tenant: Any, fields: Mapping[str, Any]) -> None:
        """Adopt a register context captured elsewhere (a migration
        hand-off or a checkpoint restore, ``fabric.snapshot``): the
        tenant's next dispatch here is a context hit and pays only its
        delta. Counts neither hit nor miss — no dispatch happened — but
        evictions it forces are recorded, and LRU order treats the install
        as a use."""
        if tenant in self._contexts:
            self._contexts.move_to_end(tenant)
        else:
            while len(self._contexts) >= self.max_contexts:
                self._contexts.popitem(last=False)
                self.stats.evictions += 1
            self._contexts[tenant] = {}
        self._contexts[tenant].update(fields)

    # -- invalidation --------------------------------------------------------

    def invalidate(self, tenant: Any | None = None) -> None:
        """Drop cached state — one tenant's context, or everything (the
        runtime mirror of ``effects = "all"`` clobbering calls, §5.1)."""
        if tenant is None:
            self._contexts.clear()
        else:
            self._contexts.pop(tenant, None)
