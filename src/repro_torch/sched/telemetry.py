"""Scheduler telemetry — config traffic, cache effectiveness, device busy/idle.

The port's own copy of ``repro/sched/telemetry.py``: the code is the
reference's, unchanged.

Counters accumulate per device while the scheduler runs and export into the
repo's existing observability vocabulary: each device yields an
``interp.Trace`` (so `timeline.compare` renders scheduler runs exactly like
compiled-program runs — Figure 2/7 gantts) and a ``RooflinePoint`` (so a
scheduled workload lands on the same configuration-roofline plots as §4's
worked examples, with I_OC computed from the bytes *actually sent* — cache
elision moves the point rightward, the runtime mirror of Figure 12)."""

from __future__ import annotations

from dataclasses import dataclass, field

from ..core.accelerators import AcceleratorModel
from ..core.interp import Invocation, Trace
from ..core.roofline import RooflinePoint
from ..core.stats import geomean  # the one shared definition, re-exported
from ..engine.resources import overlap_cycles
from ..obs.metrics import MetricsRegistry
from .state_cache import CacheStats, elision_ratio

__all__ = [
    "DeviceTelemetry",
    "LaunchRecord",
    "LinkTelemetry",
    "ResourceTelemetry",
    "SchedulerReport",
    "geomean",
]


@dataclass(frozen=True)
class LaunchRecord:
    """One launch's end-to-end life: arrival → issue → start → retire.

    The per-request substrate for open-loop telemetry: ``cluster.slo``
    computes queueing-delay/latency percentiles and SLO attainment from
    these records, merged across every device of every host."""

    tenant: str
    device: str
    arrival: float  # open-loop arrival time (0.0 for closed-loop streams)
    issue: float  # host clock when config writes for this launch began
    start: float  # device begins the macro-op
    end: float  # macro-op retires
    ops: int
    config_cycles: float
    bytes_sent: int
    priority: int = 0
    deadline: float | None = None  # absolute EDF deadline (None = best effort)
    bytes_elided: int = 0  # config bytes the device already held (resident)
    # engine overlap observables: when the register image was fully
    # on-device (compute may never start earlier — the conservation
    # invariant), and how much of T_set the host actually saw (serialized
    # configuration exposes everything; an async burst DMA exposes only
    # the host instruction time plus wire cycles compute failed to cover)
    config_done: float = 0.0
    exposed_config: float = 0.0
    # attribution substrate (repro.obs): how the launch's T_set split
    # across the engine lanes — host instruction cycles, where its wire
    # transfer began (== its LinkPort reservation, so obs.attribution can
    # match the two exactly), when the host was released (captive through
    # the wire when serialized, descriptor enqueue when async), and how
    # long the host then blocked on the device (ring-full / sequential)
    host_cycles: float = 0.0
    wire_start: float = 0.0
    host_release: float = 0.0
    stall: float = 0.0

    @property
    def queue_delay(self) -> float:
        """Arrival to device-start: the tail-latency term open-loop traffic
        adds on top of service time."""
        return self.start - self.arrival

    @property
    def latency(self) -> float:
        """Arrival to retirement — what a tenant's SLO is written against."""
        return self.end - self.arrival

    @property
    def missed_deadline(self) -> bool:
        """Deadline-carrying launches that retired late (best-effort
        launches never miss)."""
        return self.deadline is not None and self.end > self.deadline

    @property
    def hidden_config(self) -> float:
        """Config cycles runtime overlap kept off the host's critical path
        (wire time that streamed behind this device's compute)."""
        return self.config_cycles - self.exposed_config


class DeviceTelemetry:
    """Everything observed about one device instance during a run.

    The counters live in a :class:`~repro.obs.metrics.MetricsRegistry`
    (one per scheduler, shared across its devices, labelled ``device=``);
    the historical scalar fields (``config_cycles``, ``bytes_sent``, ...)
    are properties — thin views over the registry — so every existing
    report and benchmark reads identically while the registry is what
    exports, folds across hosts, and feeds the obs layer."""

    _COUNTERS = (
        ("config_cycles", "sched.config_cycles"),
        ("exposed_config_cycles", "sched.exposed_config_cycles"),
        ("stall_cycles", "sched.stall_cycles"),
        ("busy_cycles", "sched.busy_cycles"),
        ("total_ops", "sched.total_ops"),
        ("bytes_sent", "sched.bytes_sent"),
        ("bytes_elided", "sched.bytes_elided"),
        ("launches", "sched.launches"),
        ("preemptions", "sched.preemptions"),
        ("preempted_config_cycles", "sched.preempted_config_cycles"),
    )

    def __init__(self, device: str, model: AcceleratorModel,
                 metrics: MetricsRegistry | None = None):
        self.device = device
        self.model = model
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.invocations: list[Invocation] = []
        self.launch_log: list[LaunchRecord] = []
        # launches cancelled before starting: their device-side accounting
        # is rolled back, but their host/wire occupancy happened — the obs
        # attribution classifies those cycles as preempted, not idle
        self.preempted_log: list[LaunchRecord] = []
        self._c = {attr: self.metrics.counter(name, device=device)
                   for attr, name in self._COUNTERS}

    # registry views: the historical scalar fields, now reading the shared
    # registry (int-valued counters surface as ints, as before)
    @property
    def config_cycles(self) -> float:
        return self._c["config_cycles"].value

    @property
    def exposed_config_cycles(self) -> float:
        return self._c["exposed_config_cycles"].value

    @property
    def stall_cycles(self) -> float:
        return self._c["stall_cycles"].value

    @property
    def busy_cycles(self) -> float:
        return self._c["busy_cycles"].value

    @property
    def total_ops(self) -> int:
        return int(self._c["total_ops"].value)

    @property
    def bytes_sent(self) -> int:
        return int(self._c["bytes_sent"].value)

    @property
    def bytes_elided(self) -> int:
        return int(self._c["bytes_elided"].value)

    @property
    def launches(self) -> int:
        return int(self._c["launches"].value)

    @property
    def preemptions(self) -> int:
        return int(self._c["preemptions"].value)

    @property
    def preempted_config_cycles(self) -> float:
        return self._c["preempted_config_cycles"].value

    def record_launch(
        self,
        tenant: str,
        regs: dict,
        start: float,
        end: float,
        ops: int,
        config_cycles: float,
        stall: float,
        bytes_sent: int,
        bytes_elided: int,
        arrival: float = 0.0,
        issue: float | None = None,
        priority: int = 0,
        deadline: float | None = None,
        config_done: float | None = None,
        exposed_config: float | None = None,
        host_cycles: float | None = None,
        wire_start: float | None = None,
        host_release: float | None = None,
    ) -> None:
        if exposed_config is None:
            exposed_config = config_cycles  # serialized: nothing hides
        if config_done is None:
            config_done = (issue if issue is not None else start) + config_cycles
        self.invocations.append(Invocation(self.device, dict(regs), start, end))
        self.launch_log.append(LaunchRecord(
            tenant=tenant,
            device=self.device,
            arrival=arrival,
            issue=issue if issue is not None else start,
            start=start,
            end=end,
            ops=ops,
            config_cycles=config_cycles,
            bytes_sent=bytes_sent,
            priority=priority,
            deadline=deadline,
            bytes_elided=bytes_elided,
            config_done=config_done,
            exposed_config=exposed_config,
            # CSR semantics when the caller doesn't split T_set: all host
            # time, a zero-length wire interval at the config-done edge,
            # host captive through it — attribution still conserves
            host_cycles=(host_cycles if host_cycles is not None
                         else config_cycles),
            wire_start=wire_start if wire_start is not None else config_done,
            host_release=(host_release if host_release is not None
                          else config_done),
            stall=stall,
        ))
        c = self._c
        c["busy_cycles"].add(end - start)
        c["total_ops"].add(ops)
        c["config_cycles"].add(config_cycles)
        c["exposed_config_cycles"].add(exposed_config)
        c["stall_cycles"].add(stall)
        c["bytes_sent"].add(bytes_sent)
        c["bytes_elided"].add(bytes_elided)
        c["launches"].inc()

    def record_preemption(self) -> None:
        """Undo the newest launch's *device-side* accounting: the staged
        macro-op never ran. Its config writes stay counted — that host work
        happened and was wasted (``exposed_config_cycles`` keeps them for
        the same reason), which is exactly what the preemption counters
        should expose. The popped record moves to ``preempted_log`` so the
        obs attribution can still classify its host/wire occupancy."""
        assert self.invocations, "preemption with no recorded launch"
        inv = self.invocations.pop()
        rec = self.launch_log.pop()
        self.preempted_log.append(rec)
        c = self._c
        c["busy_cycles"].add(-(inv.end - inv.start))
        c["total_ops"].add(-rec.ops)
        c["launches"].add(-1)
        c["preemptions"].inc()
        c["preempted_config_cycles"].add(rec.config_cycles)

    # -- derived -------------------------------------------------------------

    def utilization(self, makespan: float) -> float:
        return self.busy_cycles / makespan if makespan else 0.0

    def idle_cycles(self, makespan: float) -> float:
        return max(0.0, makespan - self.busy_cycles)

    @property
    def elision_ratio(self) -> float:
        return elision_ratio(self.bytes_sent, self.bytes_elided)

    # -- exports into the core observability vocabulary ----------------------

    def trace(self, makespan: float) -> Trace:
        """An ``interp.Trace`` over this device's invocations, renderable via
        ``timeline.render`` / ``timeline.compare``. ``total_cycles`` is the
        run's makespan so gantts of pool members share one time axis."""
        t = Trace(
            invocations=list(self.invocations),
            host_cycles=makespan,
            total_cycles=makespan,
            config_cycles=self.config_cycles,
            stall_cycles=self.stall_cycles,
            total_ops=self.total_ops,
            accel_busy_cycles=self.busy_cycles,
        )
        t._config_bytes = self.bytes_sent  # I_OC reflects elision
        return t

    def roofline_point(self, makespan: float) -> RooflinePoint:
        bytes_sent = max(self.bytes_sent, 1)
        return RooflinePoint(
            name=self.device,
            i_oc=self.total_ops / bytes_sent,
            performance=self.total_ops / makespan if makespan else 0.0,
            p_peak=self.model.p_peak,
            bw_config=self.model.bw_config,
        )


@dataclass(frozen=True)
class ResourceTelemetry:
    """Everything observed about one engine resource during a run: the
    busy-interval timeline of the host control thread, the config wire, or
    one device's compute datapath (``repro.engine.resources``). The
    per-resource analogue of a device gantt — and the substrate for the
    overlap observables: wire∩compute is the config time runtime overlap
    kept off the critical path."""

    resource: str  # e.g. "host", "cfg[pcie]", "compute[opengemm:0]"
    kind: str  # "host" | "wire" | "compute"
    busy_cycles: float
    makespan: float
    intervals: tuple = ()  # (start, end, tag) per reservation
    # the resource's repro.power.EnergyModel when a PowerSpec was attached,
    # else None — carried so the energy meter works offline from a report
    energy: object = None

    @classmethod
    def from_resource(cls, res, makespan: float) -> "ResourceTelemetry":
        return cls(
            resource=res.name,
            kind=res.kind,
            busy_cycles=res.busy_cycles,
            makespan=makespan,
            intervals=tuple(res.intervals()),
            energy=getattr(res, "energy", None),
        )

    @property
    def utilization(self) -> float:
        """Fraction of the run this resource was busy (→1.0 names the
        configuration bottleneck: host pipeline, wire, or datapath)."""
        return self.busy_cycles / self.makespan if self.makespan else 0.0

    @property
    def idle_cycles(self) -> float:
        return max(0.0, self.makespan - self.busy_cycles)

    def overlap_with(self, other: "ResourceTelemetry") -> float:
        """Cycles both resources were busy at once (union semantics — no
        double counting within either side)."""
        return overlap_cycles(self.intervals, other.intervals)

    def timeline(self) -> list[tuple[float, float, str]]:
        """(start, end, tag) busy intervals — renderable beside device
        gantts and link timelines on one time axis."""
        return [(s, e, tag) for s, e, tag in self.intervals]


@dataclass(frozen=True)
class LinkTelemetry:
    """Everything observed about one fabric link during a run: busy cycles,
    bytes moved, occupancy, and the per-transfer timeline (the link-level
    analogue of a device gantt). Built from a ``fabric.link.LinkPort``'s
    transfer log (duck-typed, so this layer stays fabric-import-free)."""

    link: str  # port name, e.g. "cfg[noc]"
    kind: str  # link class: "csr" | "noc" | "pcie"
    transfers: int
    nbytes: int
    busy_cycles: float
    makespan: float
    log: tuple = ()  # (start, end, nbytes, tag, mode, energy) per transfer
    # the wire's idle/wake EnergyModel when a PowerSpec was attached
    energy: object = None

    @classmethod
    def from_port(cls, port, makespan: float) -> "LinkTelemetry":
        return cls(
            link=port.name,
            kind=port.link.kind,
            transfers=len(port.log),
            nbytes=port.bytes_moved,
            busy_cycles=port.busy_cycles,
            makespan=makespan,
            log=tuple((t.start, t.end, t.nbytes, t.tag, t.mode,
                       getattr(t, "energy", 0.0))
                      for t in port.log),
            energy=getattr(port.res, "energy", None),
        )

    @property
    def occupancy(self) -> float:
        """Fraction of the run the wire was busy — the link-saturation
        observable (→1.0 means the interconnect, not any host or device,
        is the configuration bottleneck)."""
        return self.busy_cycles / self.makespan if self.makespan else 0.0

    @property
    def effective_bandwidth(self) -> float:
        """Bytes per busy cycle actually sustained on the wire."""
        return self.nbytes / self.busy_cycles if self.busy_cycles else 0.0

    def timeline(self) -> list[tuple[float, float, str]]:
        """(start, end, tag) busy intervals, transfer order — renderable
        beside device gantts on the same time axis."""
        return [(entry[0], entry[1], entry[3]) for entry in self.log]

    @property
    def transfer_joules(self) -> float:
        """Total wire energy (pJ) of every logged transfer."""
        return sum(entry[5] for entry in self.log if len(entry) > 5)


@dataclass
class SchedulerReport:
    """Aggregate of one scheduler run."""

    makespan: float
    devices: dict[str, DeviceTelemetry]
    cache_stats: dict[str, CacheStats]
    placements: dict[str, dict[str, int]]  # tenant -> {device: launches}
    links: dict[str, LinkTelemetry] = field(default_factory=dict)
    # engine occupancy: host / wire / per-device compute busy timelines
    resources: dict[str, ResourceTelemetry] = field(default_factory=dict)
    overlap_mode: str = "serialized"
    # the run's knob settings, recorded so obs.whatif can replay the run
    # under its *actual* configuration before flipping one knob
    staging_buffers: int = 2
    transport: str = "auto"
    # how compute was priced: "flat" (the legacy per-launch constant) or
    # "calibrated" (engine.costmodel predictions per kernel shape)
    compute_model: str = "flat"
    # the run's repro.power.PowerSpec (None = cycle-only run) and the
    # transport objective, recorded so repro.power.meter can attribute a
    # report's joules offline and whatif can replay under the same spec
    power: object = None
    objective: str = "cycles"
    # the scheduler's label-set registry (repro.obs.metrics): the aggregate
    # properties below are views over it; None only for hand-built reports
    metrics: MetricsRegistry | None = None

    def _total(self, name: str, fallback) -> float:
        if self.metrics is not None and self.metrics.has(name):
            return self.metrics.total(name)
        return sum(fallback(d) for d in self.devices.values())

    @property
    def bytes_sent(self) -> int:
        return int(self._total("sched.bytes_sent", lambda d: d.bytes_sent))

    @property
    def bytes_elided(self) -> int:
        return int(self._total("sched.bytes_elided", lambda d: d.bytes_elided))

    @property
    def preemptions(self) -> int:
        return int(self._total("sched.preemptions", lambda d: d.preemptions))

    @property
    def config_cycles(self) -> float:
        """Host cycles this run spent writing configuration — on one host
        these serialize through a single control thread (the config port)."""
        return self._total("sched.config_cycles", lambda d: d.config_cycles)

    @property
    def exposed_config_cycles(self) -> float:
        """Config cycles the host actually saw: T_set minus whatever the
        overlapped engine streamed behind compute. Serialized runs expose
        everything (``exposed == config_cycles``)."""
        return self._total("sched.exposed_config_cycles",
                           lambda d: d.exposed_config_cycles)

    @property
    def hidden_config_cycles(self) -> float:
        """Config cycles runtime overlap kept off the critical path — the
        §5.5 win, measured at dispatch instead of compile time."""
        return self.config_cycles - self.exposed_config_cycles

    def overlap_summary(self) -> dict[str, float]:
        """The run's configuration-overlap scoreboard."""
        total = self.config_cycles
        hidden = self.hidden_config_cycles
        return {
            "config_cycles": total,
            "exposed_config_cycles": self.exposed_config_cycles,
            "hidden_config_cycles": hidden,
            "hidden_fraction": hidden / total if total else 0.0,
        }

    def resource_timelines(self) -> dict[str, list[tuple[float, float, str]]]:
        """Per-resource busy intervals on the shared time axis."""
        return {name: tel.timeline() for name, tel in self.resources.items()}

    def launch_log(self) -> list[LaunchRecord]:
        """Every launch of the run in issue order — the substrate for
        queueing-delay/latency percentiles (``cluster.slo``)."""
        records = [r for d in self.devices.values() for r in d.launch_log]
        records.sort(key=lambda r: (r.issue, r.start, r.tenant))
        return records

    def descriptor_timeline(
        self, tenant: str | None = None
    ) -> list[tuple[float, int, int]]:
        """Per-launch ``(issue, bytes_sent, bytes_elided)`` in issue order —
        the descriptor-byte timeline of one tenant's stream (or the whole
        run): how much of each launch's configuration actually crossed the
        boundary vs. rode on device-resident state. The serving bridge
        (``repro.bridge``) plots these per decode step."""
        return [(r.issue, r.bytes_sent, r.bytes_elided)
                for r in self.launch_log()
                if tenant is None or r.tenant == tenant]

    def queue_delays(self) -> dict[str, list[float]]:
        """Per-tenant queueing delays (arrival → device start)."""
        out: dict[str, list[float]] = {}
        for rec in self.launch_log():
            out.setdefault(rec.tenant, []).append(rec.queue_delay)
        return out

    def deadline_misses(self) -> int:
        """Launches that carried a deadline and retired after it (EDF's
        objective; best-effort launches never count)."""
        return sum(1 for r in self.launch_log() if r.missed_deadline)

    def deadline_launches(self) -> int:
        """Launches that carried a deadline at all."""
        return sum(1 for r in self.launch_log() if r.deadline is not None)

    @property
    def elision_ratio(self) -> float:
        return elision_ratio(self.bytes_sent, self.bytes_elided)

    def hit_rate(self) -> float:
        hits = sum(s.hits for s in self.cache_stats.values())
        misses = sum(s.misses for s in self.cache_stats.values())
        return hits / (hits + misses) if hits + misses else 0.0

    def traces(self) -> dict[str, Trace]:
        """Per-device timelines on a shared axis, for ``timeline.compare``."""
        return {name: d.trace(self.makespan) for name, d in self.devices.items()}

    def roofline_points(self) -> list[RooflinePoint]:
        return [d.roofline_point(self.makespan) for d in self.devices.values()]

    def utilizations(self) -> dict[str, float]:
        return {name: d.utilization(self.makespan) for name, d in self.devices.items()}

    def geomean_utilization(self) -> float:
        return geomean(self.utilizations().values())
