"""Cycle attribution — "where did the wall go", with conservation.

The port's own copy of ``repro/obs/attribution.py``: the code is the
reference's, unchanged.

The paper's thesis is that configuration cost is invisible to profilers
that only know busy/idle: the wall appears only once setup cycles are
attributed *separately* from compute, and exposed separately from hidden.
This module decomposes a run's makespan per **resource lane** — the host
control thread, the config wire(s), each device's compute datapath — into
named components, under a hard **conservation invariant**: on every lane,

    sum(components) == makespan          (idle included), equivalently
    sum(non-idle components) == union-length of the lane's occupancy

so a component can neither be dropped (the residual shows a gap) nor
counted twice (the residual shows double-booking — idle is computed from
the *union* of occupancy intervals, not from the component sum, precisely
so overlap between two classified intervals cannot hide). The residual is
the single number the CI gate thresholds.

Lane components:

* ``host`` — ``config_issue`` (instruction time, the T_calc side of Eq. 4;
  includes instruction time wasted on later-preempted launches, which the
  separate ``preempted_config_cycles`` counter still reports in full),
  ``wire_captive`` (a serialized host held through its transfer's wire
  time — Eq. 4's worst case), ``device_stall`` (blocked on a full staging
  ring or a sequential macro-op), ``preempted_config`` (captive/stall
  cycles of launches that were cancelled), ``idle``.
* ``wire`` — ``exposed_transfer`` vs ``overlapped_transfer`` (the split of
  each transfer by the launch's recorded ``hidden_config`` — wire time
  that streamed behind its own device's compute), ``preempted_transfer``
  (a cancelled launch's transfer: the bytes crossed, the macro-op never
  ran), ``other_transfer`` (wire traffic not tied to a launch, e.g. a
  migration's register-snapshot burst), ``idle``.
* ``compute`` — ``compute``, ``idle``.

The run-level ``summary`` generalizes ``exposed_config_cycles`` into the
seven-way split {exposed_config, overlapped_config, compute,
host_occupancy, wire_contention, queueing, idle}. These are *per-launch /
per-lane* totals on different denominators (queueing sums over launches,
idle over lanes) — the conservation invariant lives on the lanes, the
summary is the scoreboard. ``exposed_config`` is recomputed from the
per-launch records and must reproduce the telemetry counter
(``DeviceTelemetry.exposed_config_cycles``) — bit-exactly on runs without
preemption, where both sides sum the same floats in the same order.

Everything here is duck-typed over the report objects (a
``SchedulerReport``, a ``ClusterReport``'s ``hosts``, or a
``BridgeReport``'s ``cluster``) so the obs layer imports nothing from the
runtime layers it observes.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..engine.resources import merge_intervals


@dataclass(frozen=True)
class LaneAttribution:
    """One resource lane's makespan decomposition."""

    lane: str  # e.g. "host", "h0/compute[h0/opengemm:0]", "cfg[pcie]:shared"
    kind: str  # "host" | "wire" | "compute"
    makespan: float
    components: dict  # category -> cycles; includes "idle"
    residual: float  # |sum(components) - makespan|: gap or double-booking

    @property
    def busy_cycles(self) -> float:
        return sum(v for k, v in self.components.items() if k != "idle")

    @property
    def residual_fraction(self) -> float:
        return self.residual / self.makespan if self.makespan else 0.0


@dataclass(frozen=True)
class AttributionReport:
    """The full decomposition of one run."""

    makespan: float
    lanes: dict  # lane name -> LaneAttribution
    summary: dict  # the seven-way run-level split
    exposed_config: float  # reproduced from per-launch records
    reported_exposed_config: float  # the telemetry counters' aggregate

    @property
    def max_residual(self) -> float:
        """Worst lane residual as a fraction of makespan — the CI gate's
        conservation number."""
        return max((l.residual_fraction for l in self.lanes.values()),
                   default=0.0)

    def check(self, tolerance: float = 1e-3) -> "AttributionReport":
        """Enforce the conservation invariant (components sum to makespan
        on every lane, within ``tolerance`` of makespan) and the
        exposed-config reproduction. Returns self so call sites can chain
        ``attribute(report).check()``."""
        for lane in self.lanes.values():
            assert lane.residual <= max(tolerance * lane.makespan, 1e-9), (
                f"lane {lane.lane}: residual {lane.residual} over makespan "
                f"{lane.makespan} — components {lane.components}")
            assert lane.components["idle"] >= -1e-9, (
                f"lane {lane.lane}: negative idle — occupancy exceeds "
                f"makespan: {lane.components}")
        drift = abs(self.exposed_config - self.reported_exposed_config)
        assert drift <= 1e-6 * max(1.0, abs(self.reported_exposed_config)), (
            f"exposed-config reproduction drifted: records say "
            f"{self.exposed_config}, counters say {self.reported_exposed_config}")
        return self

    def to_dict(self) -> dict:
        return {
            "makespan": self.makespan,
            "max_residual": self.max_residual,
            "exposed_config": self.exposed_config,
            "reported_exposed_config": self.reported_exposed_config,
            "summary": dict(self.summary),
            "lanes": {
                name: {
                    "kind": lane.kind,
                    "residual": lane.residual,
                    "residual_fraction": lane.residual_fraction,
                    "components": dict(lane.components),
                }
                for name, lane in sorted(self.lanes.items())
            },
        }


# -- lane assembly ------------------------------------------------------------


def _lane(name: str, kind: str, makespan: float, components: dict,
          intervals: list) -> LaneAttribution:
    union = sum(e - s for s, e in merge_intervals(intervals))
    comps = dict(components)
    comps["idle"] = makespan - union
    classified = sum(v for k, v in comps.items() if k != "idle")
    return LaneAttribution(lane=name, kind=kind, makespan=makespan,
                           components=comps,
                           residual=abs(classified - union))


def _launch_records(rep) -> list:
    """(record, alive) for every launch the report's devices saw —
    retired launches plus the preempted ones whose side effects (host
    instruction time, wire transfer) still occupy the lanes."""
    out = [(r, True) for d in rep.devices.values() for r in d.launch_log]
    out += [(r, False) for d in rep.devices.values()
            for r in getattr(d, "preempted_log", ())]
    return out


# public alias: repro.power.meter classifies wire-transfer *energy* with
# the same launch-record matching this module uses for wire cycles
launch_records = _launch_records


def _host_lane(rep, makespan: float, records: list,
               lane_name: str) -> LaneAttribution:
    tel = next(t for t in rep.resources.values() if t.kind == "host")
    intervals = [(s, e) for s, e, _ in tel.intervals]
    issue_cycles = sum(e - s for s, e in intervals)
    captive = stall = preempted = 0.0
    for rec, alive in records:
        h_end = rec.issue + rec.host_cycles
        cap = max(0.0, rec.host_release - h_end)
        if cap > 0.0:
            intervals.append((h_end, rec.host_release))
        if rec.stall > 0.0:
            intervals.append((rec.host_release, rec.host_release + rec.stall))
        if alive:
            captive += cap
            stall += rec.stall
        else:
            preempted += cap + rec.stall
    return _lane(lane_name, "host", makespan, {
        "config_issue": issue_cycles,
        "wire_captive": captive,
        "device_stall": stall,
        "preempted_config": preempted,
    }, intervals)


def _wire_lane(link_tel, makespan: float, records: list,
               lane_name: str) -> LaneAttribution:
    # classify each logged transfer by matching the launch that reserved it
    # — (wire_start, config_done) are the transfer's own floats, so the
    # lookup is exact; the wire is FIFO, so positive-length keys are unique
    pending: dict[tuple, list] = {}
    for rec, alive in records:
        if rec.config_done > rec.wire_start:
            pending.setdefault((rec.wire_start, rec.config_done),
                               []).append((rec, alive))
    exposed = overlapped = preempted = other = 0.0
    intervals = []
    for start, end, *_rest in link_tel.log:
        length = end - start
        if length <= 0.0:
            continue  # zero-cost CSR "transfers" occupy nothing
        intervals.append((start, end))
        matches = pending.get((start, end))
        if matches:
            rec, alive = matches.pop(0)
            if not alive:
                preempted += length
            else:
                hidden = min(max(rec.hidden_config, 0.0), length)
                overlapped += hidden
                exposed += length - hidden
        else:
            other += length
    return _lane(lane_name, "wire", makespan, {
        "exposed_transfer": exposed,
        "overlapped_transfer": overlapped,
        "preempted_transfer": preempted,
        "other_transfer": other,
    }, intervals)


def _compute_lanes(rep, makespan: float, prefix: str = "") -> list:
    lanes = []
    for name, tel in rep.resources.items():
        if tel.kind != "compute":
            continue
        intervals = [(s, e) for s, e, _ in tel.intervals]
        busy = sum(e - s for s, e in intervals)
        lanes.append(_lane(prefix + name, "compute", makespan,
                           {"compute": busy}, intervals))
    return lanes


def _summary(lanes: dict, records: list) -> dict:
    return {
        "exposed_config": sum(r.exposed_config for r, _ in records),
        "overlapped_config": sum(r.hidden_config for r, _ in records),
        "compute": sum(l.components["compute"] for l in lanes.values()
                       if l.kind == "compute"),
        "host_occupancy": sum(l.components["config_issue"]
                              for l in lanes.values() if l.kind == "host"),
        "wire_contention": sum(
            max(0.0, r.wire_start - (r.issue + r.host_cycles))
            for r, _ in records),
        "queueing": sum(max(0.0, r.issue - r.arrival) for r, _ in records),
        "idle": sum(l.components["idle"] for l in lanes.values()),
    }


def _reported_exposed(reps) -> float:
    return sum(d.exposed_config_cycles
               for rep in reps for d in rep.devices.values())


# -- entry points -------------------------------------------------------------


def _attribute_scheduler(rep) -> AttributionReport:
    makespan = rep.makespan
    records = _launch_records(rep)
    lanes: dict[str, LaneAttribution] = {}
    host = _host_lane(rep, makespan, records, "host")
    lanes[host.lane] = host
    for name, ltel in rep.links.items():
        lanes[name] = _wire_lane(ltel, makespan, records, name)
    for lane in _compute_lanes(rep, makespan):
        lanes[lane.lane] = lane
    return AttributionReport(
        makespan=makespan,
        lanes=lanes,
        summary=_summary(lanes, records),
        exposed_config=sum(r.exposed_config for r, _ in records),
        reported_exposed_config=_reported_exposed([rep]),
    )


def _attribute_cluster(rep) -> AttributionReport:
    makespan = rep.makespan
    lanes: dict[str, LaneAttribution] = {}
    all_records: list = []
    # a shared cluster port appears once per host report with the *same*
    # full transfer log; fold it into one cluster-wide lane matched against
    # every sharer's launches, while private ports stay host-prefixed
    shared: dict[str, list] = {}
    for host_id, hrep in sorted(rep.hosts.items()):
        records = _launch_records(hrep)
        all_records.extend(records)
        host = _host_lane(hrep, makespan, records, f"{host_id}/host")
        lanes[host.lane] = host
        for lane in _compute_lanes(hrep, makespan, prefix=f"{host_id}/"):
            lanes[lane.lane] = lane
        for name, ltel in hrep.links.items():
            if name.endswith(":shared"):
                entry = shared.setdefault(name, [ltel, []])
                entry[1].extend(records)
            else:
                lanes[f"{host_id}/{name}"] = _wire_lane(
                    ltel, makespan, records, f"{host_id}/{name}")
    for name, (ltel, records) in shared.items():
        lanes[name] = _wire_lane(ltel, makespan, records, name)
    return AttributionReport(
        makespan=makespan,
        lanes=lanes,
        summary=_summary(lanes, all_records),
        exposed_config=sum(r.exposed_config for r, _ in all_records),
        reported_exposed_config=_reported_exposed(rep.hosts.values()),
    )


def attribute(report) -> AttributionReport:
    """Decompose a run's makespan per resource lane. Accepts a
    ``SchedulerReport``, a ``ClusterReport``, or a ``BridgeReport`` (which
    delegates to its cluster view) — all duck-typed."""
    cluster = getattr(report, "cluster", None)
    if cluster is not None and hasattr(cluster, "hosts"):
        report = cluster
    if hasattr(report, "hosts"):
        return _attribute_cluster(report)
    return _attribute_scheduler(report)
