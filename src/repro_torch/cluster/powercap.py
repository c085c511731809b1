"""Cluster power cap: hold the pool under a watt budget in every window.

The port's own copy of ``repro/cluster/powercap.py``: the code is the
reference's, unchanged.

The serving stack so far optimizes cycles under an SLO; deployments are
provisioned in *Watts* — a rack budget, a thermal envelope — and the
paper's per-Watt motivation cuts both ways: configuration overhead burns
joules (MMIO handshakes, un-gated idle links) that a power-capped pool
cannot spend. This module enforces a hard cap with two cooperating
mechanisms, both built from existing machinery:

* **Admission delay** (:func:`run_power_capped`) — before a request is
  dispatched, the pool's worst-case committed energy in *any* window the
  request could touch is measured from the live engine logs
  (:func:`~repro.power.meter.max_window_energy` — dispatch commits future
  busy intervals into the resource logs, so "committed" includes work
  that has not nominally happened yet), and admission is pushed back
  until that worst case plus a per-request upper bound fits under
  ``budget × window``. The guarantee is inductive: every admitted request
  kept every window under the budget at its own admission, and later
  admissions only ever *add* energy after re-checking — so the capped run
  never exceeds the watt budget in any window (the CI gate asserts this
  on the bench artifact). The request's ``arrival_time`` is **not**
  rewritten: delay shows up as queueing latency, so the SLO report
  prices exactly what the cap cost.
* **Load shedding** (:class:`PowerCapTrigger`) — a
  :class:`~repro.obs.monitor.SustainedThreshold` on windowed pool power:
  when the pool draws sustained near-budget power while imbalanced, the
  hottest host sheds its heaviest tenant to the coldest host through the
  same :class:`~repro.cluster.shed.ShedTrigger` machinery (victim choice,
  migration planner, slot-context hand-off) — rebalancing heat instead
  of port backlog.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

from ..fabric.transport import plan_fields
from ..obs.monitor import StreamMonitor
from ..power.meter import (
    PoolEnergySnapshot,
    host_window_energy,
    max_window_energy,
    pool_window_energy,
)
from ..power.model import ZERO_ENERGY
from ..sched.scheduler import LaunchRequest, arrival_order
from .host import Host
from .shed import ShedDecision, ShedTrigger
from .slo import ClusterReport, build_report, percentile


def request_energy_bound(host: Host, req: LaunchRequest) -> float:
    """Upper bound (pJ) on the energy dispatching ``req`` on ``host`` can
    add to any single window: a full cold-cache config transfer (host
    issue + wire) on the worst eligible device, the macro-op at active
    power, and one wake-up on each resource. Elision, overlap, and window
    clipping only shrink the real figure — never grow it."""
    sched = host.sched
    host_model = sched.res.host.energy or ZERO_ENERGY
    wire_model = sched.res.wire.energy or ZERO_ENERGY
    worst = 0.0
    for dev in sched.devices:
        if req.accel is not None and dev.model.name != req.accel:
            continue
        regs = req.regs_for(dev.model)
        xfer = plan_fields(len(regs), dev.model, sched.link, sched.transport,
                           objective=sched.objective)
        compute_model = dev.queue.compute.energy or ZERO_ENERGY
        energy = (xfer.energy
                  + compute_model.active_energy(dev.model.macro_cycles(regs))
                  + host_model.wake_energy + wire_model.wake_energy
                  + compute_model.wake_energy)
        worst = max(worst, energy)
    return worst


@dataclass
class CapReport:
    """What the cap did to one run."""

    budget_power: float  # pJ/cycle the pool must stay under per window
    window: float  # cycles per enforcement window
    delayed: int = 0  # requests admission pushed back
    total_delay: float = 0.0  # cycles of added admission delay
    delays: list = field(default_factory=list)
    sheds: list = field(default_factory=list)  # PowerCapTrigger decisions
    max_window_power: float = 0.0  # worst measured window, post-run
    max_window_at: float = 0.0

    @property
    def held(self) -> bool:
        """Did the pool stay under budget in every window? (The CI gate's
        assertion; 1e-9 absorbs float summation order.)"""
        return self.max_window_power <= self.budget_power + 1e-9

    @property
    def p50_delay(self) -> float:
        return percentile(self.delays, 50) if self.delays else 0.0

    def to_dict(self) -> dict:
        return {
            "budget_power": self.budget_power,
            "window": self.window,
            "delayed": self.delayed,
            "total_delay": self.total_delay,
            "p50_delay": self.p50_delay,
            "sheds": len(self.sheds),
            "max_window_power": self.max_window_power,
            "max_window_at": self.max_window_at,
            "held": self.held,
        }


class PowerCapTrigger(ShedTrigger):
    """Shed tenants off the hottest host when pool power runs sustained
    above ``headroom ×`` budget. Reuses :class:`ShedTrigger`'s victim
    choice, migration execution, and slot-context hand-off; only the
    pressure signal changes — windowed joules instead of port backlog.
    ``monitor`` receives every per-host observation under the canonical
    ``power.energy`` name, so :meth:`StreamMonitor.power_draw` windows
    the exact signal the trigger acts on."""

    def __init__(self, planner, *, budget_power: float, window: float,
                 headroom: float = 0.9, sustain: int = 2,
                 monitor: StreamMonitor | None = None):
        assert budget_power > 0.0 and window > 0.0
        assert 0.0 < headroom <= 1.0
        super().__init__(planner, k=1.5, sustain=sustain, monitor=monitor)
        self.budget_power = budget_power
        self.window = window
        self.headroom = headroom

    def observe(self, hosts: Sequence[Host], now: float) -> list[ShedDecision]:
        t0 = now - self.window
        # per-host burn for ranking; a shared port belongs to no single
        # host, so it is excluded here and counted once in the pool figure
        shared = len({id(h.sched.port) for h in hosts}) < len(hosts)
        energies = {
            h.id: host_window_energy(h, t0, now, include_port=not shared)
            for h in hosts
        }
        if self.monitor is not None:
            for host_id, joules in energies.items():
                self.monitor.observe("power.energy", now, joules,
                                     host=host_id)
        pool_power = pool_window_energy(hosts, t0, now) / self.window
        hot = pool_power > self.headroom * self.budget_power
        if not self.pressure.update("pool", hot):
            return []
        # rebalance heat: hottest host sheds toward the coldest
        src = max(hosts, key=lambda h: (energies[h.id], h.id))
        decision = self._shed(src, hosts, energies, now,
                              percentile(list(energies.values()), 50))
        if decision is None:
            return []
        self.decisions.append(decision)
        self.pressure.reset("pool")
        return [decision]


def run_power_capped(
    cluster,
    requests,
    *,
    budget_power: float,
    window: float,
    slo=None,
    trigger: PowerCapTrigger | None = None,
) -> tuple[ClusterReport, CapReport]:
    """Drain ``requests`` through ``cluster`` while holding pool power
    under ``budget_power`` (pJ/cycle) in every ``window``-cycle span.

    Requests are routed normally, then admission-delayed until the
    worst committed window that the dispatch could touch has headroom for
    the request's energy upper bound (see module docstring for why this
    is a hard guarantee, not a best effort). Infeasible budgets — the
    pool's standing idle burn alone exceeding the budget — fail fast
    rather than delaying forever."""
    assert budget_power > 0.0 and window > 0.0
    hosts = cluster.hosts
    budget_energy = budget_power * window
    idle_floor = pool_window_energy(hosts, -window, 0.0)
    assert idle_floor < budget_energy, (
        f"infeasible cap: pool idle burn {idle_floor / window} pJ/cycle "
        f"already exceeds budget {budget_power}")
    cap = CapReport(budget_power=budget_power, window=window)
    last_observe = 0.0
    snap = PoolEnergySnapshot(hosts)
    for req in sorted(requests, key=arrival_order):
        host = cluster.router.route(req, now=req.arrival_time)
        bound = request_energy_bound(host, req)
        assert idle_floor + bound <= budget_energy, (
            f"infeasible cap: a single {req.accel} launch ({bound} pJ) "
            f"can never fit under {budget_energy} pJ per window")
        # find the earliest admission time at which every window the
        # dispatch could add energy to keeps the budget: every committed
        # window starting at or after admission − window must leave
        # ``bound`` of headroom. One snapshot serves the whole run — logs
        # only change at dispatch, and they grow at the frontier, so each
        # dispatch folds in incrementally
        snap.extend()
        admit = snap.earliest_admission(req.arrival_time, window,
                                        budget_energy - bound)
        if admit > req.arrival_time:
            # push the host's control thread; arrival_time stays put, so
            # the added wait is visible as queueing latency in the SLO
            host.sched.host = max(host.sched.host, admit)
            cap.delayed += 1
            cap.total_delay += admit - req.arrival_time
            cap.delays.append(admit - req.arrival_time)
        host.dispatch(req)
        if trigger is not None:
            # the pool-wide clock: per-host clocks are not monotone across
            # dispatches, and the monitor's window series require ordered
            # samples. Observing is throttled to quarter-windows — the
            # trigger thresholds windowed power, so denser sampling only
            # costs time
            now = max(h.clock for h in hosts)
            if now - last_observe >= window / 4.0:
                last_observe = now
                cap.sheds.extend(trigger.observe(hosts, now=now))
    makespan = max(h.clock for h in hosts)
    worst, at = max_window_energy(hosts, window)
    cap.max_window_power = worst / window
    cap.max_window_at = at
    # the inductive argument, re-checked empirically on the final logs
    assert cap.held, (
        f"power cap violated: {cap.max_window_power} pJ/cycle at "
        f"{at} exceeds budget {budget_power} (makespan {makespan})")
    return build_report(hosts, slo=slo), cap
