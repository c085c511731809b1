"""Joule attribution and windowed power — the energy twin of obs.attribution.

The port's own copy of ``repro/power/meter.py``: the code is the
reference's, unchanged.

:func:`attribute_energy` decomposes a finished run's total energy per
**resource lane** (host control thread, config wire(s), each device's
compute datapath) into named components under the same hard conservation
invariant the cycle attribution enforces: on every lane,

    sum(components) == lane total energy   (idle and wake included)

where the lane total is computed *independently* of the classification —
host/compute lanes from the telemetry's busy-cycle counter × the attached
:class:`~repro.power.model.EnergyModel`, wire lanes from the per-transfer
energies the fabric logged at acquire time (which are the *plan-time*
figures ``fabric.transport`` priced, threaded through
``OverlapPolicy.stage`` → ``LinkPort.acquire`` → ``Transfer.energy`` —
so metering cannot drift from planning by even a rounding step). A
residual therefore catches both a dropped transfer and a double-counted
one, exactly as in the cycle profiler; ``EnergyReport.check()`` enforces
residual ≤ 0.1% per lane and is asserted on every exported trace.

Lane components:

* ``host`` / ``compute`` — ``active`` (busy cycles × active power),
  ``wake`` (one dead-time charge per idle→busy transition: merged busy
  spans), ``idle`` ((makespan − busy union) × gated idle power).
* ``wire`` — the logged transfer energies classified with the *same*
  launch-record matching the cycle attribution uses:
  ``exposed_transfer`` vs ``overlapped_transfer`` (each launch transfer's
  joules split by its recorded hidden fraction — note overlap hides
  *time*, never joules: the split shows which joules bought exposed
  wall-clock and which streamed behind compute), ``preempted_transfer``
  (a cancelled launch's bytes crossed; the macro-op never ran),
  ``other_transfer`` (non-launch traffic, e.g. a migration snapshot —
  and zero-*cycle* CSR transfers, whose handshake energy is real even
  though they occupy no wire time and so are invisible to the cycle
  lanes), plus ``wake`` / ``idle`` for the link's standing burn.

The windowed helpers at the bottom (:func:`window_energy`,
:func:`pool_window_energy`, :func:`max_window_energy`) price *live*
resource logs over a time window — the substrate for the ``power_draw``
monitor signal and the cluster power cap (``cluster.powercap``).
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right, insort
from dataclasses import dataclass

from ..engine.resources import merge_intervals
from ..obs.attribution import launch_records
from .model import ZERO_ENERGY, EnergyModel


@dataclass(frozen=True)
class EnergyLane:
    """One resource lane's energy decomposition (pJ)."""

    lane: str  # e.g. "host", "h0/compute[h0/opengemm:0]", "cfg[pcie]:shared"
    kind: str  # "host" | "wire" | "compute"
    total: float  # independently computed lane energy
    components: dict  # category -> pJ; includes "idle" and "wake"
    residual: float  # |sum(components) - total|: gap or double-booking

    @property
    def active_energy(self) -> float:
        return sum(v for k, v in self.components.items()
                   if k not in ("idle", "wake"))

    @property
    def residual_fraction(self) -> float:
        return self.residual / self.total if self.total else 0.0


@dataclass(frozen=True)
class EnergyReport:
    """The full joule decomposition of one run."""

    makespan: float
    total_energy: float  # pJ, sum of lane totals
    lanes: dict  # lane name -> EnergyLane
    summary: dict  # run-level split (config/compute/idle/wake/...)

    @property
    def max_residual(self) -> float:
        """Worst lane residual as a fraction of that lane's energy — the
        CI gate's conservation number, joule edition."""
        return max((l.residual_fraction for l in self.lanes.values()),
                   default=0.0)

    @property
    def mean_power(self) -> float:
        """Average draw over the run, pJ/cycle (≡ mW at 1 GHz)."""
        return self.total_energy / self.makespan if self.makespan else 0.0

    def tokens_per_joule(self, tokens: float) -> float:
        return tokens / self.total_energy if self.total_energy else 0.0

    def check(self, tolerance: float = 1e-3) -> "EnergyReport":
        """Enforce conservation: per-lane components sum to the lane's
        independently computed total within ``tolerance`` (0.1%), and no
        component is negative. Chains: ``attribute_energy(rep).check()``."""
        for lane in self.lanes.values():
            assert lane.residual <= max(tolerance * lane.total, 1e-9), (
                f"lane {lane.lane}: energy residual {lane.residual} over "
                f"total {lane.total} — components {lane.components}")
            for key, val in lane.components.items():
                assert val >= -1e-9, (
                    f"lane {lane.lane}: negative {key} energy {val}")
        drift = abs(sum(l.total for l in self.lanes.values())
                    - self.total_energy)
        assert drift <= max(tolerance * self.total_energy, 1e-9), drift
        return self

    def to_dict(self) -> dict:
        return {
            "makespan": self.makespan,
            "total_energy": self.total_energy,
            "mean_power": self.mean_power,
            "max_residual": self.max_residual,
            "summary": dict(self.summary),
            "lanes": {
                name: {
                    "kind": lane.kind,
                    "total": lane.total,
                    "residual": lane.residual,
                    "residual_fraction": lane.residual_fraction,
                    "components": dict(lane.components),
                }
                for name, lane in sorted(self.lanes.items())
            },
        }


# -- lane assembly ------------------------------------------------------------


def _wakeups(intervals: list) -> tuple[int, list]:
    """(idle→busy transitions, merged busy spans). Each merged span's
    start is one wake — back-to-back reservations share one wake-up."""
    spans = merge_intervals(intervals)
    return len(spans), spans


def _occupancy_lane(name: str, kind: str, makespan: float, busy_cycles: float,
                    intervals: list, model: EnergyModel) -> EnergyLane:
    """A host or compute lane: classification walks the interval log,
    the total reads the telemetry's busy-cycle counter — independent
    enough that a log/counter mismatch shows up as residual."""
    wakes, spans = _wakeups(intervals)
    union = sum(e - s for s, e in spans)
    idle = model.idle_energy(makespan - union)
    wake = model.wake_cost(wakes)
    components = {
        "active": model.active_energy(union),
        "wake": wake,
        "idle": idle,
    }
    total = model.active_energy(busy_cycles) + wake + idle
    classified = sum(components.values())
    return EnergyLane(lane=name, kind=kind, total=total,
                      components=components,
                      residual=abs(classified - total))


def _wire_lane(link_tel, makespan: float, records: list,
               lane_name: str) -> EnergyLane:
    """Classify each logged transfer's joules by matching the launch that
    reserved it — the same (wire_start, config_done) exact-float matching
    as obs.attribution._wire_lane, extended to zero-length transfers
    (their handshake energy is real; their cycles are not)."""
    model = link_tel.energy if isinstance(link_tel.energy, EnergyModel) \
        else ZERO_ENERGY
    pending: dict[tuple, list] = {}
    for rec, alive in records:
        if rec.config_done > rec.wire_start:
            pending.setdefault((rec.wire_start, rec.config_done),
                               []).append((rec, alive))
    exposed = overlapped = preempted = other = 0.0
    logged = 0.0
    intervals = []
    for entry in link_tel.log:
        start, end = entry[0], entry[1]
        energy = entry[5] if len(entry) > 5 else 0.0
        logged += energy
        length = end - start
        if length <= 0.0:
            # zero-cycle CSR transfer: no wire occupancy to match, but the
            # handshakes happened on the host's critical path → exposed
            exposed += energy
            continue
        intervals.append((start, end))
        matches = pending.get((start, end))
        if matches:
            rec, alive = matches.pop(0)
            if not alive:
                preempted += energy
            else:
                hidden = min(max(rec.hidden_config, 0.0), length)
                hidden_e = energy * (hidden / length)
                overlapped += hidden_e
                exposed += energy - hidden_e
        else:
            other += energy
    wakes, spans = _wakeups(intervals)
    union = sum(e - s for s, e in spans)
    idle = model.idle_energy(makespan - union)
    wake = model.wake_cost(wakes)
    components = {
        "exposed_transfer": exposed,
        "overlapped_transfer": overlapped,
        "preempted_transfer": preempted,
        "other_transfer": other,
        "wake": wake,
        "idle": idle,
    }
    total = logged + wake + idle
    classified = sum(components.values())
    return EnergyLane(lane=lane_name, kind="wire", total=total,
                      components=components,
                      residual=abs(classified - total))


def _resource_model(tel) -> EnergyModel:
    return tel.energy if isinstance(tel.energy, EnergyModel) else ZERO_ENERGY


def _scheduler_lanes(rep, makespan: float, records: list,
                     prefix: str = "") -> dict:
    lanes: dict[str, EnergyLane] = {}
    for name, tel in rep.resources.items():
        if tel.kind == "wire":
            continue  # wire joules come from the transfer log, below
        intervals = [(s, e) for s, e, _ in tel.intervals]
        lanes[prefix + name] = _occupancy_lane(
            prefix + name, tel.kind, makespan, tel.busy_cycles, intervals,
            _resource_model(tel))
    return lanes


def _summary(lanes: dict) -> dict:
    def lane_sum(kind: str, comp: str) -> float:
        return sum(l.components.get(comp, 0.0) for l in lanes.values()
                   if l.kind == kind)

    return {
        "host_energy": lane_sum("host", "active"),
        "compute_energy": lane_sum("compute", "active"),
        "exposed_transfer_energy": lane_sum("wire", "exposed_transfer"),
        "overlapped_transfer_energy": lane_sum("wire", "overlapped_transfer"),
        "preempted_transfer_energy": lane_sum("wire", "preempted_transfer"),
        "other_transfer_energy": lane_sum("wire", "other_transfer"),
        "wake_energy": sum(l.components.get("wake", 0.0)
                           for l in lanes.values()),
        "idle_energy": sum(l.components.get("idle", 0.0)
                           for l in lanes.values()),
    }


def _config_energy(summary: dict) -> float:
    """The run's configuration energy: host instruction issue plus every
    launch transfer's wire joules — the joule twin of config_cycles."""
    return (summary["host_energy"] + summary["exposed_transfer_energy"]
            + summary["overlapped_transfer_energy"]
            + summary["preempted_transfer_energy"])


# -- entry points -------------------------------------------------------------


def _attribute_scheduler(rep) -> EnergyReport:
    makespan = rep.makespan
    records = launch_records(rep)
    lanes = _scheduler_lanes(rep, makespan, records)
    for name, ltel in rep.links.items():
        lanes[name] = _wire_lane(ltel, makespan, records, name)
    summary = _summary(lanes)
    summary["config_energy"] = _config_energy(summary)
    return EnergyReport(
        makespan=makespan,
        total_energy=sum(l.total for l in lanes.values()),
        lanes=lanes,
        summary=summary,
    )


def _attribute_cluster(rep) -> EnergyReport:
    makespan = rep.makespan
    lanes: dict[str, EnergyLane] = {}
    # a shared cluster port appears once per host report with the *same*
    # full transfer log; fold it into one cluster-wide lane matched against
    # every sharer's launches — metering the one physical wire once
    shared: dict[str, list] = {}
    for host_id, hrep in sorted(rep.hosts.items()):
        records = launch_records(hrep)
        lanes.update(_scheduler_lanes(hrep, makespan, records,
                                      prefix=f"{host_id}/"))
        for name, ltel in hrep.links.items():
            if name.endswith(":shared"):
                entry = shared.setdefault(name, [ltel, []])
                entry[1].extend(records)
            else:
                lanes[f"{host_id}/{name}"] = _wire_lane(
                    ltel, makespan, records, f"{host_id}/{name}")
    for name, (ltel, records) in shared.items():
        lanes[name] = _wire_lane(ltel, makespan, records, name)
    summary = _summary(lanes)
    summary["config_energy"] = _config_energy(summary)
    return EnergyReport(
        makespan=makespan,
        total_energy=sum(l.total for l in lanes.values()),
        lanes=lanes,
        summary=summary,
    )


def attribute_energy(report) -> EnergyReport:
    """Decompose a run's joules per resource lane. Accepts a
    ``SchedulerReport``, a ``ClusterReport``, or a ``BridgeReport`` (which
    delegates to its cluster view) — duck-typed like ``obs.attribute``.
    Reports from runs without a :class:`~repro.power.model.PowerSpec`
    attribute to all-zero joules (and a zero-spec run reproduces the
    cycle-only report bit-exactly — the satellite pin)."""
    cluster = getattr(report, "cluster", None)
    if cluster is not None and hasattr(cluster, "hosts"):
        report = cluster
    if hasattr(report, "hosts"):
        return _attribute_cluster(report)
    return _attribute_scheduler(report)


# -- windowed power (live engines) --------------------------------------------


def _interval_overlap(start: float, end: float, t0: float, t1: float) -> float:
    return max(0.0, min(end, t1) - max(start, t0))


def resource_window_energy(res, t0: float, t1: float) -> float:
    """Joules a live :class:`~repro.engine.resources.Resource` burns in
    ``[t0, t1)``: busy overlap × active power, the remainder at the gated
    idle rate, plus a wake charge for each merged busy span *starting*
    inside the window. Adjacent windows therefore tile: summing them
    reproduces the run total (each wake counted exactly once)."""
    model = res.energy if isinstance(res.energy, EnergyModel) else ZERO_ENERGY
    spans = merge_intervals(res.intervals())
    busy = sum(_interval_overlap(s, e, t0, t1) for s, e in spans)
    wakes = sum(1 for s, _ in spans if t0 <= s < t1)
    return (model.active_energy(busy)
            + model.idle_energy((t1 - t0) - busy)
            + model.wake_cost(wakes))


def transfers_window_energy(log, t0: float, t1: float) -> float:
    """Wire joules of logged transfers prorated into ``[t0, t1)``.
    Zero-length transfers charge fully at their start instant."""
    total = 0.0
    for t in log:
        length = t.end - t.start
        if length <= 0.0:
            if t0 <= t.start < t1:
                total += t.energy
        else:
            total += t.energy * (_interval_overlap(t.start, t.end, t0, t1)
                                 / length)
    return total


def host_window_energy(host, t0: float, t1: float, *,
                       include_port: bool = True) -> float:
    """Joules one live ``cluster.Host``'s engine burns in ``[t0, t1)``:
    every engine resource's occupancy energy plus (optionally) its port's
    transfer joules. Pass ``include_port=False`` for sharers of a cluster
    port — the pool aggregator meters the shared wire once."""
    sched = host.sched
    total = sum(resource_window_energy(res, t0, t1)
                for res in sched.res.all().values()
                if include_port or res is not sched.res.wire)
    if include_port:
        total += transfers_window_energy(sched.port.log, t0, t1)
    return total


def pool_window_energy(hosts, t0: float, t1: float) -> float:
    """Joules the whole pool burns in ``[t0, t1)``. A port shared by
    several hosts is counted exactly once (dedup by port identity)."""
    seen_ports: set[int] = set()
    total = 0.0
    for host in hosts:
        port = host.sched.port
        first = id(port) not in seen_ports
        seen_ports.add(id(port))
        total += host_window_energy(host, t0, t1, include_port=first)
    return total


def pool_window_power(hosts, t0: float, t1: float) -> float:
    """Mean pool draw over ``[t0, t1)``, pJ/cycle."""
    return pool_window_energy(hosts, t0, t1) / (t1 - t0) if t1 > t0 else 0.0


def _edge_candidates(hosts) -> list[float]:
    edges: set[float] = {0.0}
    for host in hosts:
        for res in host.sched.res.all().values():
            for s, e, _ in res.intervals():
                edges.add(s)
                edges.add(e)
        for t in host.sched.port.log:
            edges.add(t.start)
            edges.add(t.end)
    return sorted(edges)


def max_window_energy(hosts, window: float,
                      start_from: float = 0.0) -> tuple[float, float]:
    """(worst-case joules in any ``window``-cycle span starting at or
    after ``start_from``, the span's start). Candidate window positions
    are interval edges and edges − window: the window energy is piecewise
    linear in the start position, so its maximum sits at a breakpoint —
    scanning edges is exact, not a sampling approximation."""
    return PoolEnergySnapshot(hosts).max_window(window, start_from)


class _Track:
    """Sorted non-overlapping weighted spans with a prefix-summed
    integral: ``integral(t0, t1)`` in O(log n) instead of a full scan —
    the difference between the power cap's admission check being linear
    or quadratic in the number of committed launches."""

    def __init__(self, spans):  # [(start, end, density)], sorted, disjoint
        self.starts = [s for s, _, _ in spans]
        self.ends = [e for _, e, _ in spans]
        self.dens = [d for _, _, d in spans]
        self.cum = [0.0]
        for s, e, d in spans:
            self.cum.append(self.cum[-1] + (e - s) * d)

    def integral(self, t0: float, t1: float) -> float:
        i = bisect_right(self.ends, t0)  # first span ending after t0
        j = bisect_left(self.starts, t1)  # first span starting at/after t1
        if i >= j:
            return 0.0
        total = self.cum[j] - self.cum[i]
        total -= max(0.0, t0 - self.starts[i]) * self.dens[i]
        total -= max(0.0, self.ends[j - 1] - t1) * self.dens[j - 1]
        return total

    def count_starts(self, t0: float, t1: float) -> int:
        return bisect_left(self.starts, t1) - bisect_left(self.starts, t0)

    def append(self, s: float, e: float, d: float) -> bool:
        """Append a span known to start at/after every existing span
        (engine logs grow at the frontier). Returns False — caller must
        rebuild — if the new span lands out of order."""
        if e <= s:
            return True  # zero-length occupancy carries no energy or wake
        if self.starts and s < self.starts[-1]:
            return False
        if self.ends and s <= self.ends[-1]:
            if d != self.dens[-1]:
                return False
            if e > self.ends[-1]:  # same-density overlap: extend in place
                self.cum[-1] += (e - self.ends[-1]) * d
                self.ends[-1] = e
            return True
        self.starts.append(s)
        self.ends.append(e)
        self.dens.append(d)
        self.cum.append(self.cum[-1] + (e - s) * d)
        return True


class PoolEnergySnapshot:
    """Frozen O(log n)-queryable view of a pool's committed energy.

    Built from the live engine logs (merged busy spans per resource, the
    transfer log per physical port — shared resources/ports deduped by
    identity, matching :func:`pool_window_energy` exactly), then
    :meth:`window_energy` prices any ``[t0, t1)`` via prefix sums. The
    power cap builds one snapshot per run and calls :meth:`extend` after
    each dispatch: engine logs are append-only and grow at the frontier,
    so new spans merge onto the track tails in O(1) — if a log ever grows
    out of order, the snapshot falls back to a full rebuild."""

    def __init__(self, hosts):
        self._hosts = list(hosts)
        self._build()

    def _build(self) -> None:
        edges: set[float] = {0.0}
        self._res: list[tuple[EnergyModel, _Track]] = []
        self._xfer: list[_Track] = []  # streaming transfers, density pJ/cyc
        self._imp_ts: list[list[float]] = []  # zero-length transfer instants
        self._imp_cum: list[list[float]] = []
        self._res_src: list = []  # (res, track, consumed log length)
        self._port_src: list = []  # (port, slot index, consumed log length)
        seen: set[int] = set()
        for host in self._hosts:
            sched = host.sched
            for res in sched.res.all().values():
                if id(res) in seen:
                    continue  # a shared wire belongs to the pool, once
                seen.add(id(res))
                model = (res.energy if isinstance(res.energy, EnergyModel)
                         else ZERO_ENERGY)
                spans = merge_intervals(res.intervals())
                for s, e in spans:
                    edges.add(s)
                    edges.add(e)
                track = _Track([(s, e, 1.0) for s, e in spans])
                self._res.append((model, track))
                self._res_src.append((res, track, len(res.log)))
            port = sched.port
            if id(port) in seen:
                continue
            seen.add(id(port))
            streamed, impulses = [], []
            for t in port.log:
                edges.add(t.start)
                edges.add(t.end)
                length = t.end - t.start
                if length <= 0.0:
                    impulses.append((t.start, t.energy))
                else:
                    streamed.append((t.start, t.end, t.energy / length))
            self._port_src.append((port, len(self._xfer), len(port.log)))
            self._xfer.append(_Track(sorted(streamed)))
            impulses.sort()
            cum = [0.0]
            for _, en in impulses:
                cum.append(cum[-1] + en)
            self._imp_ts.append([ts for ts, _ in impulses])
            self._imp_cum.append(cum)
        self.edges: list[float] = sorted(edges)

    def extend(self) -> None:
        """Fold log entries appended since the last build/extend into the
        tracks. O(new entries) on the frontier-append fast path."""
        new_edges: list[float] = []
        for i, (res, track, done) in enumerate(self._res_src):
            log = res.log
            for iv in log[done:]:
                if not track.append(iv.start, iv.end, 1.0):
                    self._build()  # out-of-order growth: start over
                    return
                if iv.end > iv.start:
                    new_edges.append(iv.start)
                    new_edges.append(iv.end)
            self._res_src[i] = (res, track, len(log))
        for i, (port, slot, done) in enumerate(self._port_src):
            log = port.log
            for t in log[done:]:
                length = t.end - t.start
                if length <= 0.0:
                    ts, cum = self._imp_ts[slot], self._imp_cum[slot]
                    if ts and t.start < ts[-1]:
                        self._build()
                        return
                    ts.append(t.start)
                    cum.append(cum[-1] + t.energy)
                elif not self._xfer[slot].append(t.start, t.end,
                                                t.energy / length):
                    self._build()
                    return
                new_edges.append(t.start)
                new_edges.append(t.end)
            self._port_src[i] = (port, slot, len(log))
        for e in new_edges:  # near-frontier inserts: short memmove tails
            if not self.edges or e >= self.edges[-1]:
                self.edges.append(e)
            else:
                insort(self.edges, e)

    def window_energy(self, t0: float, t1: float) -> float:
        total = 0.0
        for model, track in self._res:
            busy = track.integral(t0, t1)
            total += (model.active_energy(busy)
                      + model.idle_energy((t1 - t0) - busy)
                      + model.wake_cost(track.count_starts(t0, t1)))
        for track in self._xfer:
            total += track.integral(t0, t1)
        for ts, cum in zip(self._imp_ts, self._imp_cum):
            total += cum[bisect_left(ts, t1)] - cum[bisect_left(ts, t0)]
        return total

    def max_window(self, window: float,
                   start_from: float = 0.0) -> tuple[float, float]:
        assert window > 0.0, window
        candidates = {start_from}
        for e in self.edges:
            if e >= start_from:
                candidates.add(e)
            if e - window >= start_from:
                candidates.add(e - window)
        worst, at = 0.0, start_from
        for t0 in sorted(candidates):
            energy = self.window_energy(t0, t0 + window)
            if energy > worst:
                worst, at = energy, t0
        return worst, at

    def next_breakpoint(self, admit: float, window: float) -> float | None:
        """The earliest admission time past ``admit`` at which the
        worst-window figure (over windows starting ≥ admit − window) can
        change: the next edge, or the next edge to leave the trailing
        window. None once admission is past every committed edge."""
        i = bisect_right(self.edges, admit)
        c1 = self.edges[i] if i < len(self.edges) else None
        # an edge barely above admit − window can round back to exactly
        # admit when the window is added — skip candidates that do not
        # strictly advance, or the caller's stepping loop never moves
        c2 = None
        j = bisect_right(self.edges, admit - window)
        while j < len(self.edges):
            cand = self.edges[j] + window
            if cand > admit:
                c2 = cand
                break
            j += 1
        if c1 is None:
            return c2
        if c2 is None or c1 <= c2:
            return c1
        return c2

    def _candidates_desc(self, lo: float, window: float):
        """Candidate window starts (edges and edges − window) at or after
        ``lo``, yielded in strictly descending order."""
        i = j = len(self.edges) - 1
        prev = None
        while i >= 0 or j >= 0:
            a = self.edges[i] if i >= 0 else None
            b = self.edges[j] - window if j >= 0 else None
            if b is None or (a is not None and a >= b):
                c = a
                i -= 1
            else:
                c = b
                j -= 1
            if c < lo:
                return  # merged stream is descending: nothing ≥ lo remains
            if c != prev:
                prev = c
                yield c

    def earliest_admission(self, arrival: float, window: float,
                           threshold: float) -> float:
        """Earliest time at/after ``arrival`` to admit work whose energy
        bound needs every window starting at/after admission − window to
        hold at most ``threshold`` pJ.

        Candidate windows are scanned newest-first: the scan stops at the
        *last* over-threshold window, so under a binding cap (hot windows
        sit at the commit frontier) it exits within a few evaluations
        instead of sweeping the whole backlog. Admission lands just past
        that window; the trailing window ``[admit − window, admit]`` —
        the one window whose start is not an edge — is then stepped over
        breakpoints until it, too, fits. The caller's feasibility asserts
        (idle floor + bound under budget) guarantee termination: past the
        last committed edge only idle burn remains."""
        lo = arrival - window
        last_bad = None
        for c in self._candidates_desc(lo, window):
            if self.window_energy(c, c + window) > threshold:
                last_bad = c
                break
        admit = arrival
        if last_bad is not None:
            nxt = self.next_breakpoint(last_bad + window, window)
            assert nxt is not None, "hot window past every committed edge"
            admit = max(arrival, nxt)
        while self.window_energy(admit - window, admit) > threshold:
            nxt = self.next_breakpoint(admit, window)
            assert nxt is not None, (
                "no later admission point despite a feasible cap")
            admit = nxt
        return admit


# -- trace export -------------------------------------------------------------


def power_counter_series(report) -> dict[str, list[tuple[float, float]]]:
    """Per-lane (timestamp, pJ/cycle draw) step series for the Chrome
    trace's counter lanes: each lane steps to its active power at every
    busy-interval start and back to its gated idle rate at the end —
    drawn from the same telemetry the energy attribution meters."""
    cluster = getattr(report, "cluster", None)
    if cluster is not None and hasattr(cluster, "hosts"):
        report = cluster
    host_reps = (sorted(report.hosts.items())
                 if hasattr(report, "hosts") else [("", report)])
    series: dict[str, list[tuple[float, float]]] = {}
    seen_shared: set[str] = set()
    for host_id, rep in host_reps:
        prefix = f"{host_id}/" if host_id else ""
        for name, tel in rep.resources.items():
            model = _resource_model(tel)
            if model is ZERO_ENERGY:
                continue
            lane = name if name.endswith(":shared") else prefix + name
            if name.endswith(":shared"):
                if name in seen_shared:
                    continue
                seen_shared.add(name)
            points: list[tuple[float, float]] = [(0.0, model.idle_rate)]
            for s, e in merge_intervals(tel.intervals):
                points.append((s, model.active_power))
                points.append((e, model.idle_rate))
            series[lane] = points
    return series
