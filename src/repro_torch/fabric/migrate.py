"""Tenant migration: warm register-snapshot hand-off vs. cold resend.

The port's own copy of ``repro/fabric/migrate.py``: the code is the
reference's, unchanged.

When the router wants to move a tenant off a saturated host, there are two
ways to pay for it:

* **cold** — drop the tenant's source context; its first launch at the
  destination re-sends the full register file through the destination's
  config port (full T_calc + T_set of Eq. 4).
* **warm** — capture the tenant's :class:`~.snapshot.ContextSnapshot` at
  the source, ship it host-to-host over a fabric link (one DMA burst of
  raw register values, no per-field recalculation), install it into the
  destination cache; the first launch there pays only its delta.

:class:`MigrationPlanner` prices both against the migration link and the
destination's config fabric and executes the cheaper one (``policy="auto"``;
``"warm"``/``"cold"`` force a mode for A/B benchmarks). Warm wins when the
context is large relative to the link's per-transfer overhead — big
register files over a NoC win easily; over PCIe the double latency (ship +
delta) needs a much larger context to amortize. Concurrent migrations share
one :class:`~.link.LinkPort`, so hand-offs contend for wire bandwidth like
any other transfer.

:class:`ContextStore` persists snapshots through
``checkpoint.CheckpointStore`` (atomic, CRC-checked), so recurring tenants
restore warm across runs: capture at shutdown, install at boot, and the
returning tenant's first dispatch is already a context hit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

from .link import LinkModel, LinkPort, Transfer, resolve_link
from .snapshot import ContextSnapshot, capture, delta_fields, install, ship_cycles
from .transport import plan_fields

POLICIES = ("auto", "warm", "cold")


def _sched(host):
    """Accept either a ``cluster.Host`` or a bare ``sched.Scheduler``."""
    return getattr(host, "sched", host)


def _devices(host, accel: str | None):
    devs = [d for d in _sched(host).devices
            if accel is None or d.model.name == accel]
    assert devs, f"host carries no {accel!r} device"
    return devs


def context_device(host, tenant: str, accel: str | None = None):
    """The device whose cache holds the tenant's richest context, or
    ``None`` when the tenant is cold everywhere on this host."""
    best, best_n = None, 0
    for dev in _sched(host).devices:
        if accel is not None and dev.model.name != accel:
            continue
        ctx = dev.cache.context(tenant)
        if ctx is not None and len(ctx) >= best_n:
            best, best_n = dev, len(ctx)
    return best


@dataclass(frozen=True)
class MigrationEstimate:
    """Both prices for moving one tenant, and the chosen mode."""

    tenant: str
    src: str
    dst: str
    mode: str  # "warm" | "cold" — the cheaper (or forced) choice
    warm_cycles: float  # ship snapshot + delta T_set at the destination
    cold_cycles: float  # full-resend T_set at the destination
    context_fields: int
    context_bytes: int  # register payload the hand-off ships
    warm_port_bytes: int  # dst config-port bytes of the next launch, warm
    cold_port_bytes: int  # ... and cold (full register file)

    @property
    def savings_cycles(self) -> float:
        """Positive when the warm hand-off is the cheaper move."""
        return self.cold_cycles - self.warm_cycles


@dataclass(frozen=True)
class MigrationRecord:
    """One executed migration."""

    estimate: MigrationEstimate
    snapshot: ContextSnapshot | None  # shipped context (None for cold)
    transfer: Transfer | None  # link occupancy (None for cold)

    @property
    def done_at(self) -> float:
        return self.transfer.end if self.transfer else 0.0


class MigrationPlanner:
    """Prices and executes tenant moves over one shared migration link."""

    def __init__(self, link: LinkModel | str = "noc", *, policy: str = "auto",
                 kickoff_cycles: float = 8.0):
        assert policy in POLICIES, policy
        self.link = resolve_link(link)
        self.policy = policy
        self.kickoff_cycles = kickoff_cycles
        self.port = LinkPort(self.link, name=f"migrate[{self.link.name}]")
        self.migrations: list[MigrationRecord] = []

    # -- pricing -------------------------------------------------------------

    def estimate(self, tenant: str, src, dst, probe) -> MigrationEstimate:
        """Price both moves. ``probe`` is the tenant's next launch (a
        ``sched.LaunchRequest``) — its register file is what the first
        post-migration dispatch must convey."""
        src_id = getattr(src, "id", "src")
        dst_id = getattr(dst, "id", "dst")
        src_dev = context_device(src, tenant, getattr(probe, "accel", None))
        snap = (capture(src_dev.cache, tenant, src_dev.model)
                if src_dev is not None else None)
        # both prices must describe the same move: the destination device is
        # of the snapshot's kind when one exists (where migrate() installs),
        # else whatever the probe restricts to — least backlog breaks ties
        kind = snap.accel if snap is not None else getattr(probe, "accel", None)
        dst_sched = _sched(dst)
        dst_dev = min(_devices(dst, kind),
                      key=lambda d: (d.queue.backlog(dst_sched.host), d.id))
        regs = probe.regs_for(dst_dev.model)
        dst_link = dst_sched.link
        cold = plan_fields(len(regs), dst_dev.model, dst_link)
        delta = delta_fields(snap, regs)
        warm_delta = plan_fields(len(delta), dst_dev.model, dst_link)
        if snap is None:
            warm_cycles = float("inf")  # nothing to hand off
        else:
            warm_cycles = (ship_cycles(snap, self.link,
                                       kickoff_cycles=self.kickoff_cycles)
                           + warm_delta.t_set)
        mode = self.policy
        if mode == "auto":
            mode = "warm" if warm_cycles < cold.t_set else "cold"
        if snap is None:
            mode = "cold"
        return MigrationEstimate(
            tenant=tenant,
            src=src_id,
            dst=dst_id,
            mode=mode,
            warm_cycles=warm_cycles,
            cold_cycles=cold.t_set,
            context_fields=snap.n_fields if snap else 0,
            context_bytes=snap.context_bytes if snap else 0,
            warm_port_bytes=warm_delta.nbytes,
            cold_port_bytes=cold.nbytes,
        )

    # -- execution -----------------------------------------------------------

    def migrate(self, tenant: str, src, dst, probe, *,
                now: float = 0.0) -> MigrationRecord:
        """Move the tenant: execute the estimate's cheaper mode. Warm moves
        occupy the shared migration link (concurrent hand-offs serialize);
        either way the source context is dropped — the tenant has left."""
        est = self.estimate(tenant, src, dst, probe)
        snap: ContextSnapshot | None = None
        xfer: Transfer | None = None
        if est.mode == "warm":
            src_dev = context_device(src, tenant, getattr(probe, "accel", None))
            snap = capture(src_dev.cache, tenant, src_dev.model)
            xfer = self.port.acquire(
                now,
                ship_cycles(snap, self.link, kickoff_cycles=self.kickoff_cycles),
                nbytes=snap.context_bytes,
                tag=tenant,
                mode="burst" if self.link.supports_dma else "mmio",
            )
            dst_sched = _sched(dst)
            dst_dev = min(_devices(dst, snap.accel),
                          key=lambda d: (d.queue.backlog(dst_sched.host), d.id))
            install(dst_dev.cache, snap)
        _sched(src).invalidate(tenant)
        rec = MigrationRecord(estimate=est, snapshot=snap, transfer=xfer)
        self.migrations.append(rec)
        return rec


# -- cross-run persistence ---------------------------------------------------


def capture_contexts(host, tenants: Iterable[str] | None = None
                     ) -> list[ContextSnapshot]:
    """Snapshot every resident tenant context on a host (one snapshot per
    tenant — the richest across its devices), e.g. at shutdown."""
    wanted = set(tenants) if tenants is not None else None
    best: dict[str, ContextSnapshot] = {}
    for dev in _sched(host).devices:
        for tenant in dev.cache.tenants():
            if wanted is not None and tenant not in wanted:
                continue
            snap = capture(dev.cache, tenant, dev.model)
            if snap and (tenant not in best
                         or snap.n_fields > best[tenant].n_fields):
                best[tenant] = snap
    return [best[t] for t in sorted(best)]


def install_contexts(host, snapshots: Iterable[ContextSnapshot]) -> int:
    """Adopt snapshots onto a host (each on the least-loaded device of its
    kind); returns how many were installed. Snapshots for device kinds the
    host does not carry are skipped."""
    sched = _sched(host)
    n = 0
    for snap in snapshots:
        devs = [d for d in sched.devices if d.model.name == snap.accel]
        if not devs:
            continue
        dev = min(devs, key=lambda d: (d.queue.backlog(sched.host), d.id))
        install(dev.cache, snap)
        n += 1
    return n


class ContextStore:
    """Persist tenant contexts across runs through the checkpoint layer:
    atomic step directories, per-array CRCs, async save — so a recurring
    tenant's warmth survives restarts. Snapshots go in as their CRC-guarded
    wire bytes (one ``uint8`` leaf per tenant)."""

    def __init__(self, directory: str, keep: int = 3):
        # lazy import: the fabric cost models stay usable without torch
        from ..checkpoint.store import CheckpointStore

        self._store = CheckpointStore(directory, keep=keep)

    def save(self, step: int, snapshots: Iterable[ContextSnapshot], *,
             blocking: bool = True) -> None:
        import numpy as np

        tree = {
            s.tenant: np.frombuffer(s.to_bytes(), dtype=np.uint8).copy()
            for s in snapshots
        }
        assert tree, "nothing to persist: no resident contexts captured"
        self._store.save(step, tree, blocking=blocking)

    def restore(self, step: int | None = None) -> dict[str, ContextSnapshot]:
        """Tenant → snapshot at ``step`` (default: latest; empty dict when
        nothing was ever saved). Corruption fails loudly twice over: the
        checkpoint layer checks file CRCs, the snapshot its payload CRC."""
        import numpy as np

        if step is None:
            step = self._store.latest_step()
            if step is None:
                return {}
        like = {k: np.zeros(0, np.uint8) for k in self._store.keys(step)}
        tree = self._store.restore(step, like)
        return {
            tenant: ContextSnapshot.from_bytes(bytes(np.asarray(arr)))
            for tenant, arr in tree.items()
        }
