"""Multi-accelerator runtime scheduler with config-affinity placement.

The port's own copy of ``repro/sched/scheduler.py``: the code is the
reference's, unchanged.

A fourth runtime layer: ``compile → dispatch → schedule → execute``. The
compile-time passes shrink one program's configuration traffic; the
scheduler shrinks a *pool's* — it admits streams of launch requests from
many tenants onto heterogeneous devices drawn from
``core.accelerators.REGISTRY``, and places each launch where the device's
cached register state makes the most of it.

**Config-affinity placement.** For every candidate device the scheduler
prices the *host-visible* cost of launching there now:

    cost = T_set(delta)  +  admission delay          (concurrent devices)
    cost = T_set(delta)  +  wait + macro-op duration (sequential devices)

where ``T_set(delta)`` covers only the fields the device's
:class:`~repro.sched.state_cache.ConfigStateCache` does not already hold for
this tenant. A device holding the tenant's context is cheap, so streams
naturally pin to their devices — until the staging ring backs up and the
admission-delay term spills work to a colder device. Affinity and load
balance fall out of a single scalar.

Timing uses the same cost model as ``core.interp`` (config-write cycles per
field, launch cycles, sequential-stall vs. staged-concurrent launches), so
scheduler telemetry is directly comparable with compiled-program traces.

**Engine occupancy (repro.engine).** Since the engine refactor the
scheduler no longer bumps a private scalar clock: every launch *reserves*
the three contended resources — the host control thread, the config wire
(the fabric :class:`~repro.fabric.link.LinkPort`'s resource, possibly
shared by several hosts), and the device's compute datapath (owned by its
:class:`~repro.sched.queue.LaunchQueue`). ``overlap="serialized"``
reproduces the pre-engine cycle counts bit-exactly (the host stays captive
for its transfers' wire time); ``overlap="overlapped"`` stages async
burst-DMA transfers behind compute, releasing the host at descriptor
enqueue — the runtime twin of the §5.5 compiler pass.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Iterable, Sequence

from ..core.accelerators import REGISTRY, AcceleratorModel
from ..core.interp import Trace
from ..engine.costmodel import resolve_compute_model
from ..engine.overlap import OverlapPolicy
from ..engine.resources import EngineResources, Resource
from ..fabric.link import LinkModel, LinkPort, resolve_link
from ..fabric.transport import plan_fields
from ..obs.metrics import MetricsRegistry
from .queue import AdmissionQueue, LaunchQueue, arrival_order
from .state_cache import ConfigStateCache, WritePlan
from .telemetry import (
    DeviceTelemetry,
    LinkTelemetry,
    ResourceTelemetry,
    SchedulerReport,
)

POLICIES = ("affinity", "round_robin", "least_loaded")


@dataclass(frozen=True)
class LaunchRequest:
    """One tenant macro-op: logical GEMM dims plus extra register fields
    (addresses, strides, zero-points ...). ``accel`` restricts placement to
    one device kind (a ``REGISTRY`` model name); ``None`` means any.

    ``arrival_time`` makes the request open-loop: the scheduler may not
    issue it earlier, and queueing delay is measured from it
    (``cluster.traffic`` stamps arrivals from Poisson/bursty/diurnal
    processes). ``priority`` orders same-instant admissions and lets a
    request preempt lower-priority *staged* launches (``sched.queue``).
    ``deadline`` (absolute, host cycles) opts the request into EDF
    admission (``run_open_loop(order="edf")``); ``None`` means best
    effort.

    ``kernel`` names the macro-op's kernel class for the calibrated
    compute model (``engine.costmodel.KERNELS`` or an alias — the bridge
    tags decode vs prefill); under the default flat model it is ignored,
    so every pre-costmodel stream is priced unchanged."""

    tenant: str
    dims: tuple[int, int, int]  # logical (M, K, N); ops = 2·M·K·N
    extra: dict[str, int] = field(default_factory=dict)
    accel: str | None = None
    arrival_time: float = 0.0
    priority: int = 0
    deadline: float | None = None
    kernel: str = "matmul"

    def regs_for(self, model: AcceleratorModel) -> dict[str, int]:
        """Materialize the register file for a device kind — logical dims
        land in the model's ``dim_fields`` register names."""
        regs = dict(zip(model.dim_fields, self.dims))
        regs.update(self.extra)
        return regs


class Device:
    """One pool member: an accelerator model + its cache and launch queue."""

    def __init__(self, dev_id: str, model: AcceleratorModel, *,
                 depth: int = 2, max_contexts: int = 4,
                 metrics: MetricsRegistry | None = None):
        self.id = dev_id
        self.model = model
        self.cache = ConfigStateCache(
            max_contexts=max_contexts,
            bytes_of=lambda name, value: model.bytes_per_field,
        )
        self.queue = LaunchQueue(model, depth=depth, name=dev_id)
        self.telemetry = DeviceTelemetry(dev_id, model, metrics=metrics)

    def config_cycles(self, n_fields: int) -> float:
        """Host cycles to write ``n_fields`` registers + issue the launch
        (same accounting as ``interp._exec_setup`` / ``_exec_launch``) —
        the core-local CSR special case of ``fabric.transport.plan_fields``
        (zero wire cost, MMIO always wins)."""
        m = self.model
        writes = -(-n_fields // m.fields_per_write) if n_fields else 0
        return (writes * m.instrs_per_write + m.launch_instrs) * m.host_cpi


class Scheduler:
    """Admits multi-tenant launch streams onto a heterogeneous device pool."""

    def __init__(
        self,
        pool: dict[str, AcceleratorModel] | None = None,
        *,
        depth: int = 2,
        max_contexts: int = 4,
        policy: str = "affinity",
        cache_enabled: bool = True,
        link: LinkModel | str | None = None,
        overlap: str = "serialized",
        staging_buffers: int = 2,
        transport: str = "auto",
        objective: str = "cycles",
        compute_model=None,
        power=None,
        port: LinkPort | None = None,
        tracer=None,
    ):
        assert policy in POLICIES, policy
        # how macro-op compute time is priced: ``None`` (default) keeps the
        # flat per-launch constant — ``AcceleratorModel.macro_cycles``,
        # bit-exact with every committed number; "calibrated" (or a
        # ``ComputeModel`` instance) prices each launch's kernel class and
        # shape through the fitted analytical model (engine.costmodel)
        self.compute_model = resolve_compute_model(compute_model)
        # transport discipline for config writes: "auto" lets the fabric
        # pick the cheaper of MMIO and burst DMA per plan; "mmio"/"burst"
        # force one side — the counterfactual knob obs.whatif validates
        # its burst-DMA predictions against
        self.transport = transport
        # what "cheaper" means under "auto": cycles (default, historical
        # behaviour bit-exactly), joules, or edp — the one place energy
        # rates are allowed to change *timing* (fabric.transport.OBJECTIVES)
        self.objective = objective
        # optional repro.power.PowerSpec: attaches observation-only
        # EnergyModels to the host/wire/compute resources so the energy
        # meter (repro.power.meter) and windowed power monitor can price
        # this run's busy intervals in joules; never consulted by dispatch
        self.power = power
        if pool is None:
            pool = {name: model for name, model in REGISTRY.items()}
        # one label-set registry per scheduler (repro.obs.metrics): every
        # device's counters live here, and reports aggregate through it
        self.metrics = MetricsRegistry()
        self.devices = [
            Device(dev_id, model, depth=depth, max_contexts=max_contexts,
                   metrics=self.metrics)
            for dev_id, model in pool.items()
        ]
        self.policy = policy
        self.cache_enabled = cache_enabled
        # the interconnect config writes cross: ``None``/"csr" is the
        # paper's core-local port (zero wire cost — the pre-fabric numbers
        # reproduce bit-exactly); "noc"/"pcie" price every write's T_set
        # through fabric.transport (MMIO vs. burst DMA, whichever is
        # cheaper) and log occupancy on the config LinkPort. Passing an
        # existing ``port`` shares its wire with other schedulers (the
        # cluster-level PCIe-switch topology): transfers from every sharer
        # contend FIFO on one resource, and the port's link wins.
        if port is not None:
            self.port = port
            self.link = port.link
        else:
            self.link = resolve_link(link)
            self.port = LinkPort(self.link, name=f"cfg[{self.link.name}]")
        # the three-resource occupancy model this scheduler dispatches onto
        # (repro.engine): the host clock is the host resource's committed
        # time, the wire is the port's resource, compute lives in the queues
        self.res = EngineResources(
            host=Resource("host", kind="host"),
            wire=self.port.res,
            compute={d.id: d.queue.compute for d in self.devices},
        )
        if power is not None:
            self.res.host.energy = power.host
            # a shared port keeps the first sharer's wire model: one
            # physical link, one standing burn, metered once cluster-wide
            if self.res.wire.energy is None:
                self.res.wire.energy = power.wire_model(self.link.kind)
            for d in self.devices:
                d.queue.compute.energy = power.compute_model(d.model.name)
        # serialized = pre-engine captive-host behavior (bit-exact);
        # overlapped = double-buffered async burst-DMA staging (§5.5's
        # runtime twin) — the host is released at descriptor enqueue
        self.overlap = OverlapPolicy(mode=overlap, buffers=staging_buffers)
        # observation-only span hooks (repro.obs.trace): a Tracer or a
        # host-bound view of one; never touches a clock, so traced runs
        # are bit-identical to untraced ones. The (possibly shared) wire
        # port gets the unbound root — its transfers belong to the fabric,
        # not to whichever host happened to attach first
        self.tracer = tracer
        self.overlap.tracer = tracer
        if tracer is not None and getattr(self.port, "tracer", None) is None:
            self.port.tracer = getattr(tracer, "root", tracer)
        self._rr = itertools.count()
        self._placements: dict[str, dict[str, int]] = {}
        self._last_request: dict[str, LaunchRequest] = {}

    @property
    def host(self) -> float:
        """The host control thread's committed time (the resource clock)."""
        return self.res.host.free

    @host.setter
    def host(self, value: float) -> None:
        # direct assignment (open-loop idling forward, probe save/restore)
        # moves the clock without logging busy time — reservations in
        # ``_dispatch_on`` are the only source of host busy intervals
        self.res.host.free = value

    @classmethod
    def from_registry(cls, counts: dict[str, int], **kwargs) -> "Scheduler":
        """e.g. ``Scheduler.from_registry({"gemmini": 1, "opengemm": 2})``."""
        pool: dict[str, AcceleratorModel] = {}
        for kind, n in counts.items():
            for i in range(n):
                pool[f"{kind}:{i}"] = REGISTRY[kind]
        return cls(pool, **kwargs)

    def _macro_cycles(self, dev: Device, regs: dict[str, int],
                      kernel: str) -> float:
        """One macro-op's compute duration on ``dev`` — the single seam the
        compute model replaces: ``None`` is literally the legacy call."""
        if self.compute_model is None:
            return dev.model.macro_cycles(regs)
        return self.compute_model.macro_cycles(dev.model, regs, kernel)

    # -- placement -----------------------------------------------------------

    def _candidates(self, req: LaunchRequest) -> list[Device]:
        devs = [d for d in self.devices
                if req.accel is None or d.model.name == req.accel]
        if not devs:
            raise KeyError(f"no device of kind {req.accel!r} in pool")
        return devs

    def _probe_device(self, dev: Device, req: LaunchRequest) -> tuple[float, int]:
        """(host-visible cost of launching here now, config bytes a resident
        context would elide) — one cache write-plan evaluation feeds both.
        Under runtime overlap an async burst transfer exposes only the
        host's instruction time to this scalar (the wire streams behind
        compute), so warm overlapped devices probe even cheaper."""
        regs = req.regs_for(dev.model)
        if self.cache_enabled:
            plan = dev.cache.plan(req.tenant, regs)
            n_sent, elided = len(plan.sent), plan.bytes_elided
        else:
            n_sent, elided = len(regs), 0
        xfer = plan_fields(n_sent, dev.model, self.link, self.transport,
                           objective=self.objective)
        cfg_c = self.overlap.exposed_cost(dev.model.concurrent, xfer)
        issue = self.host + cfg_c
        if dev.model.concurrent:
            delay = dev.queue.admission_delay(issue)
            if self.overlap.is_async(dev.model.concurrent, xfer):
                # overlap-aware placement: an async transfer releases the
                # host early, but compute may not start before the register
                # image lands (StagePlan.config_done) — and the wire's busy
                # window can push that transfer back. Probe the wire the
                # same way stage() would reserve it, so a device behind a
                # backlogged link prices the gate it would actually impose
                # on compute-start instead of looking free.
                earliest = max(self.host + xfer.host_cycles,
                               self.overlap.bank_free(dev.id))
                done = self.port.res.when(earliest, xfer.link_cycles).end
                delay = max(delay, done - issue)
            return cfg_c + delay, elided
        start = max(issue, dev.queue.device_free)
        return start + self._macro_cycles(dev, regs, req.kernel) - self.host, \
            elided

    def _host_cost(self, dev: Device, req: LaunchRequest) -> float:
        return self._probe_device(dev, req)[0]

    def place(self, req: LaunchRequest) -> Device:
        devs = self._candidates(req)
        if len(devs) == 1:
            return devs[0]
        if self.policy == "round_robin":
            return devs[next(self._rr) % len(devs)]
        if self.policy == "least_loaded":
            return min(devs, key=lambda d: d.queue.backlog(self.host))
        # affinity: cheapest host-visible cost; cold-cache ties (e.g. a
        # tenant's first launch) break toward the least-loaded device so
        # tenants spread across the pool before pinning
        return min(devs, key=lambda d: (self._host_cost(d, req),
                                        d.queue.backlog(self.host)))

    def probe_cost(self, req: LaunchRequest, now: float | None = None,
                   stickiness: float = 0.0) -> float:
        """Host-visible cycles to place ``req`` on this scheduler's best
        device, relative to ``max(host clock, now)`` — the clock an actual
        dispatch at wall time ``now`` would see. ``stickiness`` credits each
        device's resident-context elision (priced at its config bandwidth)
        that many launches ahead, the affinity router's hysteresis term.
        Pure query — the cross-host router's per-host term
        (``cluster.router``); one cache write-plan per device feeds both
        the cost and the residency credit."""
        saved = self.host
        if now is not None:
            self.host = max(self.host, now)
        try:
            best = float("inf")
            for dev in self._candidates(req):
                cost, elided = self._probe_device(dev, req)
                if stickiness:
                    cost -= stickiness * elided / dev.model.bw_config
                best = min(best, cost)
            return best
        finally:
            self.host = saved

    # -- dispatch ------------------------------------------------------------

    def dispatch(self, req: LaunchRequest,
                 not_before: float = 0.0) -> Device:
        # open-loop admission: the host idles until the request exists.
        # ``not_before`` is an externally-imposed release edge (a host-level
        # config-bandwidth quota deferring the launch past its arrival) —
        # the delay lands in this request's own queueing time, measured
        # from its unchanged arrival_time.
        self.host = max(self.host, req.arrival_time, not_before)
        dev = self.place(req)
        self._dispatch_on(dev, req)
        return dev

    def _dispatch_on(self, dev: Device, req: LaunchRequest) -> None:
        victim: LaunchRequest | None = None
        if req.priority and dev.model.concurrent:
            # a higher-priority arrival that would block on a full staging
            # ring cancels the newest staged-not-started launch instead
            if dev.queue.admission_delay(self.host) > 0.0:
                staged = dev.queue.preempt_tail(self.host, req.priority)
                if staged is not None and staged.token is not None:
                    victim = staged.token
                    dev.telemetry.record_preemption()
                    self.overlap.preempted(dev.id)
                    self._placements[victim.tenant][dev.id] -= 1
                    if self.tracer is not None:
                        self.tracer.instant(
                            "preempt", self.host, lane=f"compute[{dev.id}]",
                            tenant=victim.tenant, by=req.tenant)
        regs = req.regs_for(dev.model)
        if self.cache_enabled:
            plan = dev.cache.dispatch(req.tenant, regs)
        else:
            total = len(regs) * dev.model.bytes_per_field
            plan = WritePlan(sent=dict(regs), elided={}, bytes_sent=total,
                             bytes_elided=0, context_hit=False)
        issue = self.host
        xfer = plan_fields(len(plan.sent), dev.model, self.link,
                           self.transport, objective=self.objective)
        cfg_c = xfer.t_set
        # reserve host + wire through the overlap policy: serialized keeps
        # the host captive for the wire (bit-exact pre-engine behavior);
        # overlapped enqueues an async burst DMA and releases the host at
        # the descriptor — the wire then streams behind the device's compute
        stage = self.overlap.stage(
            dev_id=dev.id, concurrent=dev.model.concurrent, xfer=xfer,
            host=self.res.host, port=self.port, issue=issue, tag=req.tenant)
        # config cycles the host actually saw: its instruction time plus
        # whatever wire time did NOT hide behind this device's compute —
        # the "exposed T_set" the overlap-adjusted roofline is built from
        hidden = (dev.queue.compute.overlap_with(stage.wire_start,
                                                 stage.config_done)
                  if stage.asynchronous else 0.0)
        exposed = cfg_c - hidden
        self.res.host.advance(stage.host_release)
        timing = dev.queue.submit(self.host,
                                  self._macro_cycles(dev, regs, req.kernel),
                                  priority=req.priority, token=req,
                                  ready=stage.config_done)
        self.host = timing.host_after
        self.overlap.committed(dev.id, timing.end)
        dev.telemetry.record_launch(
            tenant=req.tenant,
            regs=regs,
            start=timing.start,
            end=timing.end,
            ops=dev.model.macro_ops(regs),
            config_cycles=cfg_c,
            stall=timing.stall,
            # the launch itself crosses the boundary too (cf. interp)
            bytes_sent=plan.bytes_sent + dev.model.bytes_per_field,
            bytes_elided=plan.bytes_elided,
            arrival=req.arrival_time,
            issue=issue,
            priority=req.priority,
            deadline=req.deadline,
            config_done=stage.config_done,
            exposed_config=exposed,
            host_cycles=stage.host_busy,
            wire_start=stage.wire_start,
            host_release=stage.host_release,
        )
        if self.tracer is not None:
            self._emit_spans(dev, req, stage, timing, issue,
                             n_fields=len(plan.sent), config_cycles=cfg_c,
                             exposed=exposed)
        self._last_request[req.tenant] = req
        self._placements.setdefault(req.tenant, {})
        self._placements[req.tenant][dev.id] = (
            self._placements[req.tenant].get(dev.id, 0) + 1
        )
        if victim is not None:
            # the victim re-enters placement behind its preemptor; each hop
            # strictly lowers the displaced priority, so this terminates
            self.dispatch(victim)

    def _emit_spans(self, dev: Device, req: LaunchRequest, stage, timing,
                    issue: float, *, n_fields: int, config_cycles: float,
                    exposed: float) -> None:
        """One launch's span taxonomy (repro.obs.trace): queued →
        config-issue → [wire-captive] → [launch-stall] on the host lane,
        config-done → compute on the device lane, launch on the tenant
        lane. The wire-transfer span itself is emitted by the LinkPort
        (the transfer belongs to the fabric, shared ports included)."""
        tr = self.tracer
        tenant_lane = f"tenant[{req.tenant}]"
        h_end = stage.host_start + stage.host_busy
        if issue > req.arrival_time:
            tr.span("queued", "queueing", req.arrival_time, issue,
                    lane=tenant_lane, device=dev.id)
        tr.span("config-issue", "config", stage.host_start, h_end,
                lane="host", tenant=req.tenant, device=dev.id,
                fields=n_fields)
        if stage.host_release > h_end:
            tr.span("wire-captive", "config", h_end, stage.host_release,
                    lane="host", tenant=req.tenant, device=dev.id)
        if timing.stall > 0.0:
            tr.span("launch-stall", "stall", stage.host_release,
                    stage.host_release + timing.stall, lane="host",
                    tenant=req.tenant, device=dev.id)
        tr.instant("config-done", stage.config_done,
                   lane=f"compute[{dev.id}]", tenant=req.tenant)
        tr.span("compute", "compute", timing.start, timing.end,
                lane=f"compute[{dev.id}]", tenant=req.tenant,
                ops=dev.model.macro_ops(req.regs_for(dev.model)))
        tr.span("launch", "launch", issue, timing.end, lane=tenant_lane,
                device=dev.id, config_cycles=config_cycles,
                exposed_config=exposed,
                asynchronous=stage.asynchronous)

    def invalidate(self, tenant: str | None = None) -> None:
        """Clobber cached device state (the runtime ``effects="all"``)."""
        for dev in self.devices:
            dev.cache.invalidate(tenant)

    def last_request(self, tenant: str) -> LaunchRequest | None:
        """The tenant's most recently dispatched request — the probe a
        migration trigger (``cluster.shed``) prices a move with."""
        return self._last_request.get(tenant)

    def tenant_launches(self) -> dict[str, int]:
        """tenant → launches dispatched here (the shed trigger's heat
        signal for choosing which stream to move)."""
        return {t: sum(devs.values()) for t, devs in self._placements.items()}

    # -- runs ----------------------------------------------------------------

    def run(self, requests: Iterable[LaunchRequest]) -> SchedulerReport:
        """Batch admission: dispatch in the given order (closed-loop)."""
        for req in requests:
            self.dispatch(req)
        return self.finish()

    def run_open_loop(self, requests: Iterable[LaunchRequest],
                      *, order: str = "arrival", warmth=None,
                      warm_slack: float = 0.0) -> SchedulerReport:
        """Event-driven drain: requests are admitted in arrival order (ties
        go to higher priority), and the host clock idles forward whenever
        the next arrival is still in the future — queueing delay percentiles
        out of ``report.launch_log()`` are meaningful only under this loop.

        ``order="edf"`` re-orders the *backlog* earliest-deadline-first
        (requests without deadlines fall back to priority order): under
        bursts, tight-deadline launches overtake loose ones they arrived
        behind, lowering deadline misses at equal work.

        ``order="warm"`` is cache-warmth-aware: a tenant whose context is
        still resident in some device cache drains ahead of cold arrivals
        (fewer context turnovers → fewer config bytes), bounded by each
        cold request's deadline slack (``warm_slack`` cycles of margin).
        ``warmth`` overrides the default predicate (any candidate device's
        cache would elide bytes for this request)."""
        if order == "warm" and warmth is None:
            warmth = self._default_warmth
        queue = AdmissionQueue(requests, mode=order, warmth=warmth,
                               warm_slack=warm_slack)
        while len(queue):
            self.dispatch(queue.pop(self.host))
        return self.finish()

    def _default_warmth(self, req: LaunchRequest) -> bool:
        """Is some candidate device still warm for this request's tenant?
        Pure: evaluates cache write-plans without dispatching them."""
        if not self.cache_enabled:
            return False
        for dev in self._candidates(req):
            plan = dev.cache.plan(req.tenant, req.regs_for(dev.model))
            if plan.context_hit and plan.bytes_elided > 0:
                return True
        return False

    def finish(self) -> SchedulerReport:
        makespan = max([self.host, *(d.queue.device_free for d in self.devices)])
        self.metrics.gauge("sched.makespan").set(makespan)
        return SchedulerReport(
            makespan=makespan,
            devices={d.id: d.telemetry for d in self.devices},
            cache_stats={d.id: d.cache.stats for d in self.devices},
            placements={t: dict(p) for t, p in self._placements.items()},
            links={self.port.name: LinkTelemetry.from_port(self.port, makespan)},
            resources={name: ResourceTelemetry.from_resource(res, makespan)
                       for name, res in self.res.all().items()},
            overlap_mode=self.overlap.mode,
            staging_buffers=self.overlap.buffers,
            transport=self.transport,
            compute_model=("flat" if self.compute_model is None
                           else self.compute_model.mode),
            power=self.power,
            objective=self.objective,
            metrics=self.metrics,
        )


def requests_from_trace(trace: Trace, tenant: str) -> list[LaunchRequest]:
    """Admit a *compiled accfg program* into the scheduler: replay its
    invocation log (the interpreter's observable, register snapshots at each
    launch) as a stream of launch requests. The compile-time passes have
    already deduplicated within the program; the scheduler's cache then
    dedups *across* programs and tenants."""
    reqs = []
    for inv in trace.invocations:
        model = REGISTRY[inv.accel]
        dims = tuple(int(inv.regs.get(f, 0)) for f in model.dim_fields)
        extra = {k: v for k, v in inv.regs.items() if k not in model.dim_fields}
        reqs.append(LaunchRequest(tenant=tenant, dims=dims, extra=extra,
                                  accel=inv.accel))
    return reqs
