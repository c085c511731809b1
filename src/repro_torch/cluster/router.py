"""Cross-host placement and the cluster drain loop.

The port's own copy of ``repro/cluster/router.py``: the code is the
reference's, unchanged.

The scheduler collapses device choice *within one host* to a single
scalar (T_set of the config delta + admission delay). The router lifts the
same idea one level: choose the **host**, pricing

    route cost = port congestion          (serialized config writes queued
                                           ahead on the host control thread
                                           and its fabric wire —
                                           ``Host.port_wait_estimate``)
               + config-affinity cost     (the shard's best device: T_set of
                                           the delta *over the host's fabric
                                           link* given resident tenant
                                           contexts + admission delay)

Link distance is part of the affinity scalar: a host behind a NoC hop or a
PCIe fabric carries the wire latency/bandwidth inside its T_set
(``fabric.transport``), so the router spills to a far host only once the
near one's congestion outweighs the distance — no separate tuning knob.
Tenants therefore pin to the hosts that hold their warm
:class:`~repro.sched.state_cache.ConfigStateCache` contexts until port
congestion spills them — affinity and load balance again fall out of one
number.

**Slot residency** (``sticky=True``, the serving bridge) is stronger than
either term: a hosted serving-engine shard's KV cache lives on exactly one
host (``Host.adopt_context``), and a decode launch reads *and writes* that
cache — it cannot run anywhere else without a migration. A sticky router
therefore returns the resident host before any cost comparison; the cost
model only picks the *first* home (and re-picks after an explicit
``drop_context``). Classical routers ride along for comparison,
``POLICIES``-style:

* ``round_robin`` — the naive baseline; migrating tenants across hosts
  thrashes every context cache.
* ``jsq`` — join-shortest-queue on port backlog (load-aware, cache-blind).
* ``p2c`` — power-of-two-choices: two deterministic random candidates, pick
  the lesser backlog (the classic low-coordination router).
* ``affinity`` — the cost above.

:class:`Cluster` owns the hosts and the event loop: requests are drained in
arrival order (ties to higher priority), routed, dispatched, and the merged
per-host reports become a :class:`~repro.cluster.slo.ClusterReport`.
"""

from __future__ import annotations

import itertools
import random
import zlib
from collections import Counter
from typing import Iterable, Mapping, Sequence

from ..fabric.link import LinkPort, resolve_link
from ..sched.queue import ADMISSION_MODES, AdmissionQueue
from ..sched.scheduler import LaunchRequest, arrival_order
from .host import ConfigQuota, Host
from .slo import ClusterReport, build_report

ROUTERS = ("affinity", "round_robin", "jsq", "p2c")


def _rendezvous(tenant: str, host_id: str) -> int:
    """Highest-random-weight score: a deterministic, hash-seed-independent
    per-(tenant, host) weight for breaking otherwise-symmetric ties."""
    return zlib.crc32(f"{tenant}@{host_id}".encode())


class Router:
    """Pluggable cross-host placement policy."""

    def __init__(self, hosts: Sequence[Host], policy: str = "affinity",
                 seed: int = 0, stickiness: float = 4.0,
                 sticky: bool = False):
        assert policy in ROUTERS, policy
        assert hosts, "need at least one host"
        self.hosts = list(hosts)
        self.policy = policy
        # slot-residency-aware routing: when a host holds the tenant's slot
        # context (Host.adopt_context — a hosted engine shard's KV cache),
        # route there unconditionally; the policy below only places tenants
        # that have no home yet
        self.sticky = sticky
        # affinity hysteresis: a warm context's per-launch savings are
        # credited ~stickiness launches ahead, so transient port-backlog
        # spikes (one sequential macro-op deep) don't evict a residency
        # that keeps paying — yet a saturated port still spills, because
        # backlog grows without bound while the bonus is capped
        self.stickiness = stickiness
        self._rr = itertools.count()
        self._rng = random.Random(seed)  # deterministic p2c sampling

    def _eligible(self, req: LaunchRequest) -> list[Host]:
        hosts = [h for h in self.hosts if h.can_serve(req)]
        if not hosts:
            raise KeyError(f"no host carries a {req.accel!r} device")
        return hosts

    def home(self, tenant: str) -> Host | None:
        """The host holding ``tenant``'s slot context, if any."""
        for h in self.hosts:
            if h.hosts_context(tenant):
                return h
        return None

    def route(self, req: LaunchRequest, now: float) -> Host:
        hosts = self._eligible(req)
        if self.sticky:
            home = self.home(req.tenant)
            if home is not None and home.can_serve(req):
                return home  # KV residency is binding, not advisory
        if len(hosts) == 1:
            return hosts[0]
        if self.policy == "round_robin":
            return hosts[next(self._rr) % len(hosts)]
        if self.policy == "jsq":
            return min(hosts, key=lambda h: (h.port_wait_estimate(req, now), h.id))
        if self.policy == "p2c":
            a, b = self._rng.sample(hosts, 2)
            return min((a, b), key=lambda h: (h.port_wait_estimate(req, now), h.id))
        # affinity: cheapest end-to-end host-visible cost, minus the
        # residency credit (warm contexts are worth ~stickiness launches of
        # elision, not one). Cost ties (e.g. every host cold for this
        # tenant) break toward the least-loaded host so tenants spread
        # across the cluster before pinning — the router-level twin of the
        # scheduler's cold-tie rule — and residual full ties use rendezvous
        # hashing, giving each tenant a stable deterministic home instead
        # of herding onto the first host id
        return min(hosts, key=lambda h: (
            h.probe_cost(req, now, self.stickiness),
            h.port_wait_estimate(req, now),
            h.launches,
            -_rendezvous(req.tenant, h.id),
        ))


class Cluster:
    """A pool of hosts + a router: the open-loop serving fabric."""

    def __init__(self, hosts: Sequence[Host], *, policy: str = "affinity",
                 seed: int = 0, sticky: bool = False, tracer=None):
        self.hosts = list(hosts)
        self.router = Router(self.hosts, policy=policy, seed=seed,
                             sticky=sticky)
        # the cluster-wide tracer (repro.obs): hosts hold host-bound views
        # of it; ``ClosedLoopDriver`` picks it up from here
        self.tracer = tracer

    @classmethod
    def uniform(
        cls,
        n_hosts: int,
        counts: Mapping[str, int],
        *,
        policy: str = "affinity",
        depth: int = 2,
        max_contexts: int = 4,
        host_policy: str = "affinity",
        cache_enabled: bool = True,
        seed: int = 0,
        link=None,
        sticky: bool = False,
        overlap: str = "serialized",
        staging_buffers: int = 2,
        transport: str = "auto",
        objective: str = "cycles",
        compute_model=None,
        power=None,
        quota=None,
        shared_port: bool = False,
        tracer=None,
    ) -> "Cluster":
        """``Cluster.uniform(4, {"gemmini": 1, "opengemm": 1})`` — n
        identical hosts, each carrying one shard of the mixed pool.
        ``link`` names the fabric every host's config port crosses
        (default: the paper's core-local CSR); ``sticky`` turns on
        slot-residency-aware routing (the serving bridge's decode path);
        ``overlap`` selects the engine's config-staging mode per host
        (``"overlapped"`` hides async burst-DMA T_set behind compute);
        ``shared_port=True`` puts every host behind **one** cluster-level
        :class:`~repro.fabric.link.LinkPort` — the PCIe-switch topology,
        where all hosts' config transfers contend FIFO on a single wire
        instead of each owning a private one; ``power`` attaches a
        :class:`~repro.power.model.PowerSpec` to every host's engine
        resources (observation-only joule metering) and ``objective``
        sets what "cheaper" means for the auto transport choice
        (``cycles``/``joules``/``edp``); ``compute_model`` prices each
        host's macro-ops (``None`` = the legacy flat per-launch constant,
        ``"calibrated"`` = the fitted analytical model,
        ``engine.costmodel``); ``quota`` caps per-tenant config bandwidth
        at every host port — pass ``(bytes_per_window, window)`` or a
        zero-arg factory returning a fresh
        :class:`~repro.cluster.host.ConfigQuota`; quota accounting is
        stateful, so each host gets its own instance; ``tracer`` attaches
        one :class:`~repro.obs.trace.Tracer` across every host (each shard
        binds its host id into the spans it emits)."""
        port = None
        if shared_port:
            shared = resolve_link(link)
            port = LinkPort(shared, name=f"cfg[{shared.name}]:shared")

        def host_quota() -> ConfigQuota | None:
            if quota is None:
                return None
            if callable(quota):
                return quota()
            if isinstance(quota, ConfigQuota):
                # a shared instance would pool windows across hosts;
                # clone its parameters into per-host accounting instead
                return ConfigQuota(quota.bytes_per_window, quota.window,
                                   quota.budgets)
            bytes_per_window, window = quota
            return ConfigQuota(bytes_per_window, window)

        hosts = [
            Host.from_registry(f"h{i}", dict(counts), depth=depth,
                               max_contexts=max_contexts, policy=host_policy,
                               cache_enabled=cache_enabled, link=link,
                               overlap=overlap,
                               staging_buffers=staging_buffers,
                               transport=transport, objective=objective,
                               compute_model=compute_model,
                               power=power, quota=host_quota(), port=port,
                               tracer=tracer)
            for i in range(n_hosts)
        ]
        return cls(hosts, policy=policy, seed=seed, sticky=sticky,
                   tracer=tracer)

    def dispatch(self, req: LaunchRequest) -> Host:
        host = self.router.route(req, now=req.arrival_time)
        host.dispatch(req)
        return host

    def run(
        self,
        requests: Iterable[LaunchRequest],
        *,
        slo: Mapping[str, float] | None = None,
        order: str = "arrival",
    ) -> ClusterReport:
        """Event-driven drain: route and dispatch in admission order, then
        fold every host's scheduler report into one cluster report (``slo``
        maps tenant → latency target in cycles, cf. ``traffic.slo_targets``).

        ``order="arrival"`` admits in arrival order (ties to higher
        priority) — the classic drain. ``order="edf"`` makes cross-host
        admission deadline-aware: the router's backlog is everything that
        has arrived by the time the *earliest-free eligible host control
        thread* could take new work (``min`` over the clocks of hosts that
        can serve some still-queued device kind — a host whose kind
        receives no traffic must not pin the admission clock at zero and
        silently degrade EDF to arrival order; with one host this
        degenerates exactly to ``Scheduler.run_open_loop(order="edf")``),
        and the tightest deadline in that backlog is admitted first, so a
        burst's tight-deadline launches overtake loose ones cluster-wide
        instead of only inside whichever host they landed on. Eligibility
        is by device kind, not routing policy: a sticky tenant's home may
        be busier than the admission clock suggests — stickiness binds
        *placement*, while admission models the earliest capable port.
        ``order="warm"`` is a single-scheduler feature (it needs a warmth
        predicate bound to one device pool, ``Scheduler.run_open_loop``)
        and is not accepted here."""
        assert order in ("arrival", "edf"), order
        if order == "arrival":
            for req in sorted(requests, key=arrival_order):
                self.dispatch(req)
            return build_report(self.hosts, slo=slo)
        pending = list(requests)
        kinds = Counter(req.accel for req in pending)
        queue = AdmissionQueue(pending, mode=order)
        while len(queue):
            eligible = [h for h in self.hosts
                        if None in kinds or not kinds.keys().isdisjoint(h.kinds())]
            now = min(h.clock for h in eligible) if eligible else 0.0
            req = queue.pop(now)
            kinds[req.accel] -= 1
            if not kinds[req.accel]:
                del kinds[req.accel]
            self.dispatch(req)
        return build_report(self.hosts, slo=slo)
