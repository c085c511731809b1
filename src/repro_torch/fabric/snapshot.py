"""Register-context snapshots — the tenant-migration hand-off primitive.

The port's own copy of ``repro/fabric/snapshot.py``: the code is the
reference's, unchanged.

A tenant's warmth lives in one place: the register values its
``sched.ConfigStateCache`` context says the device still holds. Moving the
tenant to another host today means losing that context and paying a cold
full re-send. A :class:`ContextSnapshot` makes the context itself portable:

* :func:`capture` lifts a tenant's context out of a device cache,
* :meth:`ContextSnapshot.to_bytes` / :meth:`~ContextSnapshot.from_bytes`
  give it a CRC-guarded wire format (shippable over a fabric link, or
  persisted through ``checkpoint.CheckpointStore`` for cross-run warmth),
* :func:`install` adopts it into the destination cache, so the tenant's
  next dispatch there is a context *hit* and pays only its delta.

The cost asymmetry that makes hand-off worthwhile: a snapshot carries raw
register **values**, so shipping it is one DMA burst with no per-field
parameter recalculation — whereas a cold re-send pays the full T_calc +
T_set of Eq. 4 through the destination's config port. ``fabric.migrate``
prices both and picks the cheaper.
"""

from __future__ import annotations

import json
import struct
import zlib
from dataclasses import dataclass
from typing import Any, Mapping

from .link import LinkModel

_MAGIC = b"CTX1"


@dataclass(frozen=True)
class ContextSnapshot:
    """One tenant's cached register file, portable across hosts and runs."""

    tenant: str
    accel: str  # device kind the register file belongs to
    bytes_per_field: int
    fields: dict[str, Any]  # register name -> last-written value

    @property
    def n_fields(self) -> int:
        return len(self.fields)

    @property
    def context_bytes(self) -> int:
        """Register payload a hand-off must move (model-unit bytes — the
        same accounting the state cache and telemetry use)."""
        return self.n_fields * self.bytes_per_field

    # -- wire format ---------------------------------------------------------

    def to_bytes(self) -> bytes:
        """``CTX1 | crc32(payload) | payload`` — JSON payload with sorted
        keys so identical contexts serialize identically."""
        payload = json.dumps(
            {
                "tenant": self.tenant,
                "accel": self.accel,
                "bytes_per_field": self.bytes_per_field,
                "fields": {k: int(v) for k, v in self.fields.items()},
            },
            sort_keys=True,
        ).encode()
        return _MAGIC + struct.pack("<I", zlib.crc32(payload)) + payload

    @classmethod
    def from_bytes(cls, raw: bytes) -> "ContextSnapshot":
        if raw[:4] != _MAGIC:
            raise ValueError("not a context snapshot (bad magic)")
        (crc,) = struct.unpack("<I", raw[4:8])
        payload = raw[8:]
        if zlib.crc32(payload) != crc:
            raise ValueError("context snapshot corruption: CRC mismatch")
        d = json.loads(payload)
        return cls(tenant=d["tenant"], accel=d["accel"],
                   bytes_per_field=int(d["bytes_per_field"]),
                   fields=dict(d["fields"]))


def capture(cache, tenant: str, model) -> ContextSnapshot | None:
    """Lift ``tenant``'s resident context out of a device's
    ``ConfigStateCache`` (``None`` when the context is cold/evicted)."""
    ctx = cache.context(tenant)
    if ctx is None:
        return None
    return ContextSnapshot(tenant=tenant, accel=model.name,
                           bytes_per_field=model.bytes_per_field,
                           fields=dict(ctx))


def install(cache, snap: ContextSnapshot) -> None:
    """Adopt a snapshot into a destination cache: the tenant's next
    dispatch there is a context hit paying only its register delta."""
    cache.install_context(snap.tenant, dict(snap.fields))


def ship_cycles(snap: ContextSnapshot, link: LinkModel, *,
                kickoff_cycles: float = 8.0) -> float:
    """Cycles to move a snapshot over ``link``: raw register values go as
    one DMA burst (no per-field parameter recalculation — the hand-off's
    whole advantage); links without DMA fall back to per-field writes."""
    if link.supports_dma:
        return kickoff_cycles + link.burst_cycles(snap.context_bytes)
    return kickoff_cycles + link.mmio_cycles(snap.n_fields, snap.bytes_per_field)


def delta_fields(snap: ContextSnapshot | None,
                 regs: Mapping[str, Any]) -> dict[str, Any]:
    """The register fields of ``regs`` a snapshot does *not* already hold —
    what the tenant's next launch would still have to send after a warm
    hand-off (bit-exact comparison, mirroring the state cache)."""
    if snap is None:
        return dict(regs)
    return {name: value for name, value in regs.items()
            if name not in snap.fields or snap.fields[name] != value}
