"""One cluster host: a shard of the device pool behind a serialized
config-write port.

The port's own copy of ``repro/cluster/host.py``: the code is the
reference's, unchanged.

The paper measures configuration overhead for one host–accelerator pair;
Colagrande & Benini show the overhead *amplifies* when several devices hang
off one control processor — every device's ``T_set`` competes for the same
host pipeline, so config writes that could proceed in parallel across
devices serialize in time. `repro.sched`'s single host clock already *is*
that control thread: a :class:`Host` wraps one :class:`~repro.sched.Scheduler`
(its shard of the pool) and exposes the clock as the **config port** — the
resource cross-host routing must keep un-congested.

With `repro.fabric` the port is no longer core-local: each host names the
interconnect its config writes cross (CSR / NoC / PCIe), the scheduler
prices every write's T_set through it, and the wire's occupancy is logged
on the host's :class:`~repro.fabric.link.LinkPort`. With `repro.engine`
the port splits into its real resources — control thread, wire, compute —
so ``overlap="overlapped"`` hosts release the control thread at descriptor
enqueue and stream config behind compute, and ``port=`` lets several hosts
share one cluster-level LinkPort (PCIe-switch contention).

What the router reads off a host:

* :meth:`port_wait_estimate` — how far the host's control thread (and
  fabric wire) has committed beyond the cluster wall clock: arriving work
  waits at least this long before its first config write (the
  offload-amplification term). :meth:`port_backlog` is its alias; probes
  and the SLO report share this one estimate.
* :meth:`probe_cost` — the scheduler's config-affinity scalar for the best
  device of the shard (T_set of the delta + admission delay), i.e. warm
  tenant contexts make a host cheap.
* :meth:`warm_bytes` — how many of the request's config bytes this host's
  caches could elide right now (tenant-context residency).
* :meth:`hosts_context` — whether this host holds a tenant's *slot
  context* (a hosted serving-engine shard's KV cache, ``repro.bridge``):
  unlike register-cache warmth, slot residency is binding — a decode
  launch must run where the KV cache lives, so the sticky router routes
  on it before any cost comparison.
"""

from __future__ import annotations

import heapq
import itertools

from ..core.accelerators import REGISTRY, AcceleratorModel
from ..core.roofline import (
    RooflinePoint,
    fabric_roofline_point,
    host_roofline_point,
    overlap_roofline_point,
)
from ..fabric.link import LinkModel, LinkPort
from ..sched.scheduler import Device, LaunchRequest, Scheduler
from ..sched.telemetry import SchedulerReport


class ConfigQuota:
    """Per-tenant configuration-bandwidth quota at one host port.

    Caps how many config bytes a tenant may put on the host's port per
    ``window`` host cycles. A launch that would overrun its tenant's budget
    is **deferred to the next window, never dropped** — the excess lands in
    that tenant's own queueing delay (its ``arrival_time`` is unchanged, so
    the deferral is visible in its latency percentiles) while neighbors
    keep the port's residual bandwidth. ``budgets`` overrides the default
    per tenant; a budget of ``None`` exempts the tenant.

    Accounting is by window index (``t // window``): a tenant may start a
    launch in any window whose spend is still under budget, so one launch
    may overshoot its window by its own size — the cap is a rate limit, not
    an admission-control byte gate (a single launch larger than the budget
    still runs, once per window)."""

    def __init__(self, bytes_per_window: int, window: float,
                 budgets: dict[str, int | None] | None = None):
        assert bytes_per_window > 0 and window > 0
        self.bytes_per_window = int(bytes_per_window)
        self.window = float(window)
        self.budgets = dict(budgets or {})
        self._spent: dict[tuple[str, int], int] = {}

    def budget_for(self, tenant: str) -> int | None:
        return self.budgets.get(tenant, self.bytes_per_window)

    def spent(self, tenant: str, now: float) -> int:
        """Bytes the tenant has already charged to ``now``'s window."""
        return self._spent.get((tenant, int(now // self.window)), 0)

    def release_time(self, tenant: str, now: float) -> float:
        """Earliest time ≥ ``now`` the tenant may start a launch without
        overrunning a window's budget (``now`` itself while the current
        window has headroom, else the next window boundary)."""
        budget = self.budget_for(tenant)
        if budget is None:
            return now
        if self.spent(tenant, now) < budget:
            return now
        return (int(now // self.window) + 1) * self.window

    def charge(self, tenant: str, now: float, nbytes: int) -> None:
        """Record ``nbytes`` of config traffic in ``now``'s window."""
        key = (tenant, int(now // self.window))
        self._spent[key] = self._spent.get(key, 0) + int(nbytes)


class Host:
    """One control processor owning a shard of the device pool.

    ``link`` names the interconnect this host's config writes cross
    (``repro.fabric``): the default ``"csr"`` is the paper's core-local
    port (zero wire cost), ``"noc"``/``"pcie"`` price every write's T_set
    through the fabric transport — so two otherwise-identical hosts at
    different link distances probe differently to the router."""

    def __init__(
        self,
        host_id: str,
        pool: dict[str, AcceleratorModel],
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
        quota: ConfigQuota | None = None,
        port: LinkPort | None = None,
        tracer=None,
    ):
        self.id = host_id
        # bind the host id into every span this shard emits (repro.obs):
        # one cluster-wide tracer still attributes each event to its host
        self.tracer = tracer
        bound = tracer.bind(host=host_id) if tracer is not None else None
        self.sched = Scheduler(pool, depth=depth, max_contexts=max_contexts,
                               policy=policy, cache_enabled=cache_enabled,
                               link=link, overlap=overlap,
                               staging_buffers=staging_buffers,
                               transport=transport, objective=objective,
                               compute_model=compute_model,
                               power=power, port=port,
                               tracer=bound)
        # per-tenant config-bandwidth quota at this port (None = uncapped).
        # Over-budget launches park in the deferred heap until their window
        # release edge; they are flushed lazily — at the next dispatch
        # whose arrival has passed the edge, or at report() — so the host
        # clock is never idled forward past a neighbor's earlier arrival.
        self.quota = quota
        self._deferred: list[tuple[float, float, int, LaunchRequest]] = []
        self._defer_seq = itertools.count()
        self.deferred_launches = 0
        # tenants whose *slot context* (a hosted engine shard's KV cache)
        # lives on this host — the binding residency the sticky router
        # consults; distinct from register-cache warmth, which is advisory
        self._slot_contexts: set[str] = set()

    @classmethod
    def from_registry(cls, host_id: str, counts: dict[str, int],
                      **kwargs) -> "Host":
        """e.g. ``Host.from_registry("h0", {"gemmini": 1, "opengemm": 1})`` —
        device ids are namespaced ``h0/gemmini:0`` so merged cluster
        telemetry stays unambiguous."""
        pool = {
            f"{host_id}/{kind}:{i}": REGISTRY[kind]
            for kind, n in counts.items()
            for i in range(n)
        }
        return cls(host_id, pool, **kwargs)

    # -- state the router reads ---------------------------------------------

    @property
    def clock(self) -> float:
        """The host control thread's committed time (the config port)."""
        return self.sched.host

    @property
    def link(self) -> LinkModel:
        """The interconnect this host's config writes cross."""
        return self.sched.link

    @property
    def port(self):
        """The host's fabric config port (``fabric.link.LinkPort``)."""
        return self.sched.port

    @property
    def devices(self) -> list[Device]:
        return self.sched.devices

    def kinds(self) -> set[str]:
        return {d.model.name for d in self.sched.devices}

    def can_serve(self, req: LaunchRequest) -> bool:
        return req.accel is None or req.accel in self.kinds()

    @property
    def launches(self) -> int:
        """Cumulative launches dispatched here (the router's long-run
        load signal for cold-tie spreading)."""
        return sum(d.telemetry.launches for d in self.sched.devices)

    # -- slot residency (hosted engine shards, ``repro.bridge``) -------------

    def adopt_context(self, tenant: str) -> None:
        """Record that ``tenant``'s slot context (its serving-engine shard's
        KV cache) lives on this host: its decode launches are sticky here
        until the context is dropped (a finished or migrated tenant)."""
        self._slot_contexts.add(tenant)

    def drop_context(self, tenant: str) -> None:
        self._slot_contexts.discard(tenant)

    def hosts_context(self, tenant: str) -> bool:
        """Does this host hold ``tenant``'s slot context? The binding
        residency signal: a decode launch reads and writes the KV cache,
        so it cannot run anywhere else without a migration."""
        return tenant in self._slot_contexts

    @property
    def resident_tenants(self) -> set[str]:
        """Tenants whose slot contexts (engine shards) this host hosts."""
        return set(self._slot_contexts)

    def port_wait_estimate(self, req: LaunchRequest | None = None,
                           now: float = 0.0) -> float:
        """Cycles a request arriving at ``now`` waits before its first
        config write can start here — the later of the control thread's
        committed time and the fabric wire's in-flight transfer. The
        **single** backlog estimate shared by router probes
        (:meth:`probe_cost`) and the SLO report (``cluster.slo``), so the
        two can never drift apart.

        Since the engine refactor this is a *query against the resource
        intervals* (:meth:`~repro.engine.resources.EngineResources.port_wait`),
        not a bespoke formula: the max-combine (never ``+`` — a captive
        host already contains its own transfer, summing would double-count
        it) and the half-open ``[start, end)`` boundary (a transfer
        completing at exactly ``now`` holds the port for zero further
        cycles) both live in ``Resource.backlog``. Under DMA/host overlap
        the wire can outrun the control thread, and with a shared cluster
        LinkPort it carries other hosts' transfers too — both show up here
        automatically because the wire resource is the port's. With a
        per-tenant config-bandwidth ``quota``, ``req`` matters: a tenant
        that has exhausted its window waits at least until the window
        rolls over, so the router steers its launches toward hosts with
        budget left while neighbors still see only the resource wait."""
        wait = self.sched.res.port_wait(now)
        if self.quota is not None and req is not None:
            wait = max(wait,
                       self.quota.release_time(req.tenant, now) - now)
        return wait

    def port_backlog(self, now: float) -> float:
        """Cycles of config work already committed past the wall clock —
        a request routed here waits at least this long for the port."""
        return self.port_wait_estimate(now=now)

    def probe_cost(self, req: LaunchRequest, now: float,
                   stickiness: float = 0.0) -> float:
        """Host-visible cycles from ``now`` until this host would have the
        request's launch issued: port congestion first, then the scheduler's
        config-affinity cost on the shard's best device — minus the
        residency credit when the router passes its ``stickiness``. Link
        distance is priced in: the scheduler's cost term carries the
        fabric T_set (MMIO/burst over this host's link), so a host behind
        a PCIe fabric probes expensive even when idle."""
        return self.port_wait_estimate(req, now) + self.sched.probe_cost(
            req, now, stickiness)

    def _elidable_per_device(self, req: LaunchRequest):
        """(device, elidable config bytes) over the shard's eligible devices."""
        for dev in self.sched.devices:
            if req.accel is not None and dev.model.name != req.accel:
                continue
            yield dev, dev.cache.elidable_bytes(req.tenant, req.regs_for(dev.model))

    def warm_bytes(self, req: LaunchRequest) -> int:
        """Config bytes the host's caches would elide for this request —
        the tenant-context residency signal (0 on a cold host)."""
        return max((b for _, b in self._elidable_per_device(req)), default=0)

    def residency_cycles(self, req: LaunchRequest) -> float:
        """Config-write cycles a resident context saves on one launch of
        this request (elidable bytes priced at the device's configuration
        bandwidth) — the router weighs this beyond the single launch,
        since residency keeps paying on the tenant's future stream."""
        return max((b / dev.model.bw_config
                    for dev, b in self._elidable_per_device(req)), default=0.0)

    def last_request(self, tenant: str) -> LaunchRequest | None:
        """The tenant's most recent launch here — what a migration trigger
        prices a shed with (``cluster.shed``)."""
        return self.sched.last_request(tenant)

    def tenant_launches(self) -> dict[str, int]:
        """tenant → launches dispatched on this host (shed heat signal)."""
        return self.sched.tenant_launches()

    # -- dispatch ------------------------------------------------------------

    def dispatch(self, req: LaunchRequest) -> Device | None:
        """Dispatch (or, under a config-bandwidth quota, defer) one launch.

        Returns the device the launch ran on, or ``None`` when the
        tenant's quota window is exhausted and the launch was parked — it
        will run at its window's release edge (flushed lazily, or force it
        with :meth:`flush_deferred`), with queueing delay measured from
        its unchanged ``arrival_time``."""
        if self.quota is None:
            return self.sched.dispatch(req)
        # launches whose release edge has passed go first — they have been
        # waiting since before this arrival (the host clock only ever moves
        # to release points ≤ this arrival, so no neighbor is delayed)
        self._release_deferred(upto=req.arrival_time)
        start = max(req.arrival_time, self.clock)
        release = self.quota.release_time(req.tenant, start)
        if release > start:
            self._defer(req, release)
            return None
        return self._dispatch_charged(req)

    def _defer(self, req: LaunchRequest, release: float) -> None:
        heapq.heappush(self._deferred,
                       (release, req.arrival_time, next(self._defer_seq), req))
        self.deferred_launches += 1

    def _dispatch_charged(self, req: LaunchRequest,
                          not_before: float = 0.0) -> Device:
        dev = self.sched.dispatch(req, not_before=not_before)
        rec = self._record_for(dev, req)
        self.quota.charge(req.tenant, rec.issue, rec.bytes_sent)
        return dev

    @staticmethod
    def _record_for(dev: Device, req: LaunchRequest):
        """The launch record ``req`` just produced on ``dev`` — matched by
        (tenant, arrival), not ``launch_log[-1]``: a priority dispatch can
        preempt a staged launch whose victim re-dispatches afterwards."""
        for rec in reversed(dev.telemetry.launch_log):
            if rec.tenant == req.tenant and rec.arrival == req.arrival_time:
                return rec
        raise AssertionError(
            f"dispatched launch for {req.tenant!r} left no record on {dev.id}")

    def _release_deferred(self, upto: float | None = None) -> None:
        """Dispatch every parked launch whose release edge is ≤ ``upto``
        (``None`` = all of them, the report()-time flush). A window that
        filled up in the meantime (deferred siblings landed first) pushes
        the launch to the next edge instead of overrunning the budget; each
        window admits at least one launch, so the drain terminates."""
        limit = float("inf") if upto is None else upto
        while self._deferred and self._deferred[0][0] <= limit:
            release, _, _, req = heapq.heappop(self._deferred)
            actual = self.quota.release_time(req.tenant, release)
            if actual > release:
                self._defer(req, actual)
                self.deferred_launches -= 1  # same launch, not a new deferral
                continue
            self._dispatch_charged(req, not_before=release)

    def flush_deferred(self) -> None:
        """Force every quota-deferred launch through at its release edge —
        ``ClosedLoopDriver`` calls this when it must observe a deferred
        launch's completion before the tenant's next step."""
        if self.quota is not None:
            self._release_deferred()

    # -- reporting -----------------------------------------------------------

    def report(self) -> SchedulerReport:
        self.flush_deferred()
        return self.sched.finish()

    def port_utilization(self, makespan: float) -> float:
        """Fraction of the run the control thread spent writing config —
        the offload-amplification observable (→1.0 means the host pipeline,
        not any accelerator, is the bottleneck)."""
        if not makespan:
            return 0.0
        return sum(d.telemetry.config_cycles for d in self.sched.devices) / makespan

    def roofline_point(self, makespan: float) -> RooflinePoint:
        """This host on the configuration roofline: P_peak sums the shard,
        BW_cfg is the serialized port's effective bandwidth (Eq. 4)."""
        devs = self.sched.devices
        total_ops = sum(d.telemetry.total_ops for d in devs)
        config_bytes = sum(d.telemetry.bytes_sent for d in devs)
        config_cycles = sum(d.telemetry.config_cycles for d in devs)
        return host_roofline_point(
            self.id,
            total_ops=total_ops,
            config_bytes=max(config_bytes, 1),
            config_cycles=config_cycles,
            makespan=makespan,
            p_peak=sum(d.model.p_peak for d in devs),
        )

    def overlap_roofline_point(self, makespan: float) -> RooflinePoint:
        """This host with *runtime overlap* priced in: the effective T_set
        of Eq. 4 counts only the **exposed** config cycles (host
        instruction time + wire time compute failed to hide), so BW_cfg
        rises and the ridge shifts left. On a serialized host exposed ==
        total and the point coincides with :meth:`roofline_point`."""
        devs = self.sched.devices
        return overlap_roofline_point(
            f"{self.id}[{self.sched.overlap.mode}]",
            total_ops=sum(d.telemetry.total_ops for d in devs),
            config_bytes=max(sum(d.telemetry.bytes_sent for d in devs), 1),
            exposed_cycles=sum(d.telemetry.exposed_config_cycles for d in devs),
            makespan=makespan,
            p_peak=sum(d.model.p_peak for d in devs),
        )

    def fabric_roofline_point(self, makespan: float) -> RooflinePoint:
        """This host with the interconnect split out: BW_cfg is the
        *link-effective* config bandwidth — T_calc the host's instruction
        cycles, T_set the cycles its config bytes spent on the wire
        (``core.roofline.fabric_roofline_point``). On a core-local CSR
        port the wire term is ~0 and the point degenerates to the host's
        instruction-limited bandwidth."""
        devs = self.sched.devices
        config_cycles = sum(d.telemetry.config_cycles for d in devs)
        link_cycles = self.sched.port.busy_cycles
        return fabric_roofline_point(
            f"{self.id}[{self.link.name}]",
            total_ops=sum(d.telemetry.total_ops for d in devs),
            config_bytes=max(sum(d.telemetry.bytes_sent for d in devs), 1),
            host_cycles=max(config_cycles - link_cycles, 0.0),
            link_cycles=link_cycles,
            makespan=makespan,
            p_peak=sum(d.model.p_peak for d in devs),
        )
