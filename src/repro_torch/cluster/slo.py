"""SLO-percentile telemetry for open-loop cluster runs.

The port's own copy of ``repro/cluster/slo.py``: the code is the
reference's, unchanged.

Closed-loop reports end at makespan and utilization; an open-loop serving
system is judged on its *tails*: the p99 of the queueing delay (arrival →
device start) and the fraction of launches finishing inside each tenant's
latency target. This module folds every host's
:class:`~repro.sched.telemetry.SchedulerReport` — specifically the
per-launch :class:`~repro.sched.telemetry.LaunchRecord` logs — into one
:class:`ClusterReport`:

* per-tenant p50/p95/p99 queueing delay and latency,
* SLO attainment (fraction of launches with ``latency ≤ slo_cycles``) and
  **goodput** (ops of SLO-meeting launches per cycle — work that was worth
  doing),
* config-byte traffic and preemption counts summed across hosts,
* per-host ``interp.Trace`` timelines on one shared time axis and per-host
  configuration-roofline points (serialized-port effective bandwidth), so a
  cluster run lands on the same plots as a single compiled program.

Percentiles use deterministic linear interpolation (no numpy dependency at
this layer, bit-stable across platforms) — the shared implementation lives
in :mod:`repro.obs.metrics` and is re-exported here unchanged.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping, Sequence

from ..core.interp import Trace
from ..core.roofline import RooflinePoint
from ..obs.metrics import MetricsRegistry, percentile
from ..sched.state_cache import elision_ratio
from ..sched.telemetry import (
    LaunchRecord,
    LinkTelemetry,
    ResourceTelemetry,
    SchedulerReport,
)

__all__ = [
    "ClusterReport",
    "TenantSLO",
    "TenantServing",
    "build_report",
    "percentile",
]


@dataclass(frozen=True)
class TenantSLO:
    """One tenant's open-loop service quality over a run."""

    tenant: str
    launches: int
    p50_queue: float
    p95_queue: float
    p99_queue: float
    p50_latency: float
    p95_latency: float
    p99_latency: float
    slo_cycles: float | None  # None = best effort, attainment vacuously 1
    attainment: float  # fraction of launches with latency <= slo_cycles
    total_ops: int
    good_ops: int  # ops of launches that met the SLO

    @classmethod
    def from_records(cls, tenant: str, records: Sequence[LaunchRecord],
                     slo_cycles: float | None) -> "TenantSLO":
        queues = [r.queue_delay for r in records]
        lats = [r.latency for r in records]
        if slo_cycles is None:
            met = list(records)
        else:
            met = [r for r in records if r.latency <= slo_cycles]
        return cls(
            tenant=tenant,
            launches=len(records),
            p50_queue=percentile(queues, 50),
            p95_queue=percentile(queues, 95),
            p99_queue=percentile(queues, 99),
            p50_latency=percentile(lats, 50),
            p95_latency=percentile(lats, 95),
            p99_latency=percentile(lats, 99),
            slo_cycles=slo_cycles,
            attainment=len(met) / len(records) if records else 1.0,
            total_ops=sum(r.ops for r in records),
            good_ops=sum(r.ops for r in met),
        )


@dataclass(frozen=True)
class TenantServing:
    """One bridged tenant's token-level service quality (``repro.bridge``):
    the closed-loop observables a serving SLO is written against — decode
    step latency percentiles (arrival of the step's first launch to
    retirement of its last) and token goodput over the run's makespan.
    Sits beside :class:`TenantSLO`, which speaks per-*launch*; this speaks
    per-*decode-step*, the unit a user-visible token corresponds to."""

    tenant: str
    tokens: int
    steps: int
    p50_decode: float
    p95_decode: float
    p99_decode: float
    tokens_per_kcycle: float  # token goodput normalized to the run makespan

    @classmethod
    def from_steps(cls, tenant: str, latencies: Sequence[float],
                   tokens: int, makespan: float) -> "TenantServing":
        return cls(
            tenant=tenant,
            tokens=tokens,
            steps=len(latencies),
            p50_decode=percentile(latencies, 50),
            p95_decode=percentile(latencies, 95),
            p99_decode=percentile(latencies, 99),
            tokens_per_kcycle=1000.0 * tokens / makespan if makespan else 0.0,
        )


@dataclass
class ClusterReport:
    """Aggregate of one open-loop cluster run."""

    makespan: float
    hosts: dict[str, SchedulerReport]
    tenants: dict[str, TenantSLO]
    records: list[LaunchRecord]
    port_utilization: dict[str, float]  # host -> config-port duty cycle
    roofline: list[RooflinePoint]  # one point per host (serialized port)
    # host -> residual port wait when the run's last request arrived — the
    # same Host.port_wait_estimate the router probes, so telemetry and
    # routing can never disagree about backlog
    port_wait: dict[str, float]
    fabric_roofline: list[RooflinePoint]  # one point per host (link-effective BW)
    # one point per host with runtime overlap priced in: BW_cfg over the
    # *exposed* config cycles only (== `roofline` on serialized hosts)
    overlap_roofline: list[RooflinePoint] = field(default_factory=list)
    # tenant -> token-level serving stats, attached by the closed-loop
    # bridge (empty for plain open-loop runs)
    serving: dict[str, TenantServing] = field(default_factory=dict)
    # every host's scheduler registry absorbed under a host=<id> label plus
    # the cluster-level series build_report adds; the traffic properties
    # below are views over it (repro.obs.metrics), falling back to summing
    # host reports when a report was assembled without a registry
    metrics: MetricsRegistry | None = None

    def attach_serving(self, stats: Mapping[str, TenantServing]) -> None:
        """Fold bridged token-level stats in (``repro.bridge.report``)."""
        self.serving = dict(stats)

    # -- traffic -------------------------------------------------------------

    def _total(self, name: str, fallback: float) -> float:
        if self.metrics is not None and self.metrics.has(name):
            return self.metrics.total(name)
        return fallback

    @property
    def bytes_sent(self) -> int:
        return int(self._total("sched.bytes_sent",
                               sum(rep.bytes_sent for rep in self.hosts.values())))

    @property
    def bytes_elided(self) -> int:
        return int(self._total("sched.bytes_elided",
                               sum(rep.bytes_elided for rep in self.hosts.values())))

    @property
    def elision_ratio(self) -> float:
        return elision_ratio(self.bytes_sent, self.bytes_elided)

    @property
    def preemptions(self) -> int:
        return int(self._total("sched.preemptions",
                               sum(rep.preemptions for rep in self.hosts.values())))

    @property
    def launches(self) -> int:
        return len(self.records)

    @property
    def deadline_misses(self) -> int:
        """Deadline-carrying launches that retired late, cluster-wide."""
        return sum(1 for r in self.records if r.missed_deadline)

    @property
    def tokens(self) -> int:
        """Tokens produced by bridged tenants (0 for open-loop GEMM runs)."""
        return sum(s.tokens for s in self.serving.values())

    @property
    def tokens_per_kcycle(self) -> float:
        """Cluster token goodput — the closed-loop analogue of ``goodput``:
        tokens the bridged engines actually produced per 1000 cycles of the
        run (queueing delay throttles this directly, unlike open-loop)."""
        if not self.makespan:
            return 0.0
        return 1000.0 * self.tokens / self.makespan

    def descriptor_timeline(
        self, tenant: str | None = None
    ) -> list[tuple[float, int, int]]:
        """Per-launch ``(issue, bytes_sent, bytes_elided)`` across every
        host, in arrival order — the cluster-wide descriptor-byte timeline
        (cf. ``SchedulerReport.descriptor_timeline``)."""
        return [(r.issue, r.bytes_sent, r.bytes_elided)
                for r in self.records
                if tenant is None or r.tenant == tenant]

    def links(self) -> dict[str, LinkTelemetry]:
        """Per-host fabric config-port telemetry (busy/occupancy timelines),
        keyed ``host/port`` so merged cluster views stay unambiguous. Hosts
        behind one shared cluster LinkPort each report the same underlying
        wire (the key's port name carries the ``:shared`` suffix)."""
        return {
            f"{host_id}/{name}": tel
            for host_id, rep in self.hosts.items()
            for name, tel in rep.links.items()
        }

    def resources(self) -> dict[str, ResourceTelemetry]:
        """Per-host engine-resource telemetry (host control thread, config
        wire, per-device compute busy timelines), keyed ``host/resource``."""
        return {
            f"{host_id}/{name}": tel
            for host_id, rep in self.hosts.items()
            for name, tel in rep.resources.items()
        }

    @property
    def config_cycles(self) -> float:
        return self._total("sched.config_cycles",
                           sum(rep.config_cycles for rep in self.hosts.values()))

    @property
    def exposed_config_cycles(self) -> float:
        """Config cycles the cluster's hosts actually saw (T_set minus
        what the overlapped engines streamed behind compute)."""
        return self._total(
            "sched.exposed_config_cycles",
            sum(rep.exposed_config_cycles for rep in self.hosts.values()))

    @property
    def hidden_config_cycles(self) -> float:
        return self.config_cycles - self.exposed_config_cycles

    # -- tails ---------------------------------------------------------------

    def queue_delay_percentile(self, q: float) -> float:
        """Cluster-wide queueing-delay percentile over every launch."""
        return percentile([r.queue_delay for r in self.records], q)

    def latency_percentile(self, q: float) -> float:
        return percentile([r.latency for r in self.records], q)

    @property
    def attainment(self) -> float:
        """Launch-weighted SLO attainment across tenants with targets."""
        bound = [t for t in self.tenants.values() if t.slo_cycles is not None]
        total = sum(t.launches for t in bound)
        if not total:
            return 1.0
        return sum(t.attainment * t.launches for t in bound) / total

    @property
    def goodput(self) -> float:
        """Ops per cycle delivered *within* SLO — throughput that counts."""
        if not self.makespan:
            return 0.0
        return sum(t.good_ops for t in self.tenants.values()) / self.makespan

    # -- plots ---------------------------------------------------------------

    def traces(self) -> dict[str, Trace]:
        """Per-device timelines across every host on one shared time axis
        (device ids are host-namespaced), for ``timeline.compare``."""
        return {
            dev_id: tel.trace(self.makespan)
            for rep in self.hosts.values()
            for dev_id, tel in rep.devices.items()
        }

    def placements(self) -> dict[str, dict[str, int]]:
        """tenant -> host -> launches (how hard each router shuffles)."""
        out: dict[str, dict[str, int]] = {}
        for host_id, rep in self.hosts.items():
            for tenant, devs in rep.placements.items():
                n = sum(devs.values())
                out.setdefault(tenant, {})
                out[tenant][host_id] = out[tenant].get(host_id, 0) + n
        return out


def build_report(hosts, *, slo: Mapping[str, float] | None = None) -> ClusterReport:
    """Fold a list of :class:`~repro.cluster.host.Host` into one report."""
    slo = dict(slo or {})
    reports = {h.id: h.report() for h in hosts}
    makespan = max([rep.makespan for rep in reports.values()] + [0.0])
    records: list[LaunchRecord] = []
    for rep in reports.values():
        records.extend(rep.launch_log())
    records.sort(key=lambda r: (r.arrival, r.issue, r.tenant))
    by_tenant: dict[str, list[LaunchRecord]] = {}
    for rec in records:
        by_tenant.setdefault(rec.tenant, []).append(rec)
    tenants = {
        t: TenantSLO.from_records(t, recs, slo.get(t))
        for t, recs in sorted(by_tenant.items())
    }
    last_arrival = max([r.arrival for r in records], default=0.0)
    # one cluster registry: every host's sched.* series folded in under a
    # host=<id> label, plus the cluster-level tail/backlog series — so the
    # traffic properties above and cluster dashboards read one store
    metrics = MetricsRegistry()
    for host_id, rep in reports.items():
        if rep.metrics is not None:
            metrics.absorb(rep.metrics, host=host_id)
    for rec in records:
        metrics.histogram("cluster.queue_delay",
                          tenant=rec.tenant).observe(rec.queue_delay)
        metrics.histogram("cluster.latency",
                          tenant=rec.tenant).observe(rec.latency)
    metrics.gauge("cluster.makespan").set(makespan)
    for h in hosts:
        metrics.gauge("cluster.port_wait",
                      host=h.id).set(h.port_wait_estimate(now=last_arrival))
    return ClusterReport(
        makespan=makespan,
        hosts=reports,
        tenants=tenants,
        records=records,
        port_utilization={h.id: h.port_utilization(makespan) for h in hosts},
        roofline=[h.roofline_point(makespan) for h in hosts],
        port_wait={h.id: h.port_wait_estimate(now=last_arrival) for h in hosts},
        fabric_roofline=[h.fabric_roofline_point(makespan) for h in hosts],
        overlap_roofline=[h.overlap_roofline_point(makespan) for h in hosts],
        metrics=metrics,
    )
