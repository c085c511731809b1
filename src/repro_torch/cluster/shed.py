"""Migration *trigger* policy: decide when a hot host sheds a tenant.

The port's own copy of ``repro/cluster/shed.py``: the code is the
reference's, unchanged.

``fabric.migrate.MigrationPlanner`` prices and executes a move (warm
register-snapshot hand-off vs. cold resend), but nothing decided *when* a
move should happen — the ROADMAP gap this module closes. The rule is a
deliberately simple threshold:

    a host whose ``port_wait_estimate`` stays above ``k ×`` the cluster
    median for ``sustain`` consecutive observations sheds its hottest
    tenant to the least-backlogged host that can serve it.

``port_wait_estimate`` is the *single* backlog signal routers and the SLO
report already share (the engine's resource-interval query), so the
trigger, the router, and telemetry can never disagree about which host is
hot. The median — not the mean — is the baseline so one runaway host
cannot drag the threshold up after itself; ``sustain`` debounces transient
spikes (one deep macro-op should not trigger a hand-off that costs real
wire cycles).

The victim is the hot host's most-launched resident tenant (its heaviest
stream — moving it sheds the most future port pressure), priced with the
tenant's last dispatched request as the probe. The planner then executes
whichever of warm/cold is cheaper over the shared migration link, and the
tenant's slot context (KV-cache residency, ``repro.bridge``) follows it so
a sticky router immediately routes the stream to its new home.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from ..fabric.migrate import MigrationPlanner, MigrationRecord
from ..obs.monitor import SustainedThreshold
from .host import Host
from .slo import percentile


@dataclass(frozen=True)
class ShedDecision:
    """One executed shed: why it fired and what it moved."""

    tenant: str
    src: str
    dst: str
    now: float
    src_wait: float  # the hot host's port wait when the trigger fired
    median_wait: float  # the cluster median it was judged against
    record: MigrationRecord  # the planner's executed move (warm or cold)


class ShedTrigger:
    """Threshold rule driving the migration planner.

    Call :meth:`observe` periodically (each admission epoch, each bridge
    step, ...). Debouncing is the obs layer's
    :class:`~repro.obs.monitor.SustainedThreshold` keyed by host: a host
    must stay hot for ``sustain`` consecutive observations before it
    sheds, and the key is acknowledged (reset) after a shed — give the
    move time to drain — or whenever it dips back under the threshold.
    A failed shed attempt (no viable victim or destination) leaves the
    alert fired, so it retries next epoch.

    ``monitor`` (an :class:`~repro.obs.monitor.StreamMonitor`) optionally
    receives every observation under ``cluster.port_wait`` keyed by host,
    so dashboards window the same pressure signal the trigger acts on.
    """

    def __init__(self, planner: MigrationPlanner, *, k: float = 1.5,
                 sustain: int = 2, monitor=None):
        assert k > 1.0, "threshold must exceed the median or every host is hot"
        assert sustain >= 1
        self.planner = planner
        self.k = k
        self.sustain = sustain
        self.decisions: list[ShedDecision] = []
        self.pressure = SustainedThreshold(sustain=sustain)
        self.monitor = monitor

    # -- the rule -------------------------------------------------------------

    def hot_hosts(self, waits: dict[str, float]) -> tuple[list[str], float]:
        """(hosts above k×median right now, the median). A host is hot
        when its wait exceeds k× the cluster median *and* is nonzero: an
        idle cluster (all waits 0) has nothing to rebalance, but one
        backlogged host among idle peers — where the median itself is 0 —
        is exactly the case that must shed."""
        median = percentile(list(waits.values()), 50)
        return ([h for h, w in waits.items()
                 if w > self.k * median and w > 0.0], median)

    def observe(self, hosts: Sequence[Host], now: float) -> list[ShedDecision]:
        """One observation epoch: update streaks, shed where sustained.
        When several hosts run hot in one epoch, each shed takes a
        *distinct* destination — the epoch's backlog numbers are stale the
        moment the first hand-off is committed, so piling every victim
        onto the single coldest host would just mint the next hot host."""
        waits = {h.id: h.port_wait_estimate(now=now) for h in hosts}
        if self.monitor is not None:
            for host_id, wait in waits.items():
                self.monitor.observe("cluster.port_wait", now, wait,
                                     host=host_id)
        hot, median = self.hot_hosts(waits)
        fired: list[ShedDecision] = []
        used_dsts: set[str] = set()
        for host in hosts:
            if not self.pressure.update(host.id, host.id in hot):
                continue
            decision = self._shed(host, hosts, waits, now, median, used_dsts)
            if decision is not None:
                fired.append(decision)
                used_dsts.add(decision.dst)
                self.pressure.reset(host.id)
        self.decisions.extend(fired)
        return fired

    # -- execution ------------------------------------------------------------

    def _victim(self, src: Host) -> tuple[str, object] | None:
        """The hot host's heaviest stream that is still *resident* here
        (most launches, ties to the tenant name for determinism). Launch
        counts are cumulative, so residency is the filter that keeps an
        already-shed tenant — whose context the migration invalidated —
        from being 'moved' again on the strength of its history."""
        resident = {t for dev in src.devices for t in dev.cache.tenants()}
        for tenant, _ in sorted(src.tenant_launches().items(),
                                key=lambda kv: (-kv[1], kv[0])):
            if tenant not in resident:
                continue
            probe = src.last_request(tenant)
            if probe is not None:
                return tenant, probe
        return None

    def _shed(self, src: Host, hosts: Sequence[Host],
              waits: dict[str, float], now: float, median: float,
              used_dsts: set[str] = frozenset()) -> ShedDecision | None:
        picked = self._victim(src)
        if picked is None:
            return None
        tenant, probe = picked
        targets = [h for h in hosts
                   if h is not src and h.id not in used_dsts
                   and h.can_serve(probe)]
        if not targets:
            return None
        dst = min(targets, key=lambda h: (waits[h.id], h.id))
        if waits[dst.id] >= waits[src.id]:
            return None  # nowhere meaningfully colder to shed to
        record = self.planner.migrate(tenant, src, dst, probe, now=now)
        if src.hosts_context(tenant):
            # slot residency (KV cache) follows the register context, so a
            # sticky router re-homes the stream immediately
            src.drop_context(tenant)
            dst.adopt_context(tenant)
        decision = ShedDecision(
            tenant=tenant,
            src=src.id,
            dst=dst.id,
            now=now,
            src_wait=waits[src.id],
            median_wait=median,
            record=record,
        )
        return decision
