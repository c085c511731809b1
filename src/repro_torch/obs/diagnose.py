"""The config-wall doctor: regime classification + ranked recommendations.

The port's own copy of ``repro/obs/diagnose.py``: the code is the
reference's, unchanged.

The paper's instrument is the configuration roofline (Eq. 4): a system
whose operational configuration intensity sits left of the ridge
``I_OC = P_peak / BW_cfg`` is *configuration-bound* — adding FLOPs is
pointless until T_set shrinks. This module turns that classification into
an automated diagnosis over the repo's own telemetry:

* :func:`classify` — pure rule over run-level numbers. Precedence:

  1. **arrival-limited** — no resource lane is busy even half the run;
     the stream, not the system, is the bottleneck (queueing theory's
     underloaded regime; knobs won't move makespan).
  2. **config-bound** — host-visible (exposed) configuration is ≥ 10% of
     makespan. The threshold is deliberately low: the paper's Fig. 4
     shows double-digit config shares already flatten the roofline, and
     every serialized fabric cell of ``BENCH_config_overlap.json`` sits
     far above it while compute-dominated overlapped cells fall under.
  3. **wire-bound** — the config wire out-busies compute: transfers are
     hidden (not exposed) but the link itself saturates.
  4. **compute-bound** — the datapath dominates; the system is right of
     the ridge.

* :func:`diagnose` — classify a live run (scheduler / cluster / bridge
  report, via :mod:`~repro.obs.attribution`), per-lane regimes, and
  ranked quantified recommendations priced by :mod:`~repro.obs.whatif`
  replays (enable overlap, MMIO→burst DMA, more staging buffers) plus
  structural heuristics (cache resize, warm-migrate) the replay cannot
  price.
* :func:`diagnose_doc` — the same over a serialized ``TRACE_*.json``
  (attribution + metrics only — no launch log), so recommendations carry
  *upper bounds* instead of replayed predictions.

``python -m repro_torch.obs.doctor`` renders all of this as a transcript.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .attribution import attribute
from . import whatif as _whatif

__all__ = [
    "CONFIG_BOUND_SHARE", "ARRIVAL_BUSY_SHARE",
    "Regime", "Recommendation", "Diagnosis",
    "classify", "classify_cell", "diagnose", "diagnose_doc",
]

# exposed-config share of makespan at which a run is called config-bound
CONFIG_BOUND_SHARE = 0.10
# if no lane is busy this fraction of the run, the stream is the bottleneck
ARRIVAL_BUSY_SHARE = 0.50

LABELS = ("arrival_limited", "config_bound", "wire_bound", "compute_bound")


@dataclass(frozen=True)
class Regime:
    """One classification: where this run sits relative to the ridge."""

    label: str  # one of LABELS
    exposed_share: float  # exposed config / makespan
    exposed_fraction: float  # exposed / total config (1.0 = nothing hidden)
    shares: dict  # lane kind -> max busy share across that kind's lanes
    reason: str

    def to_dict(self) -> dict:
        return {
            "label": self.label,
            "exposed_share": self.exposed_share,
            "exposed_fraction": self.exposed_fraction,
            "shares": dict(self.shares),
            "reason": self.reason,
        }


@dataclass(frozen=True)
class Recommendation:
    """One ranked mitigation, quantified when a replay could price it.

    Priced on both axes where the replay allows: ``predicted_savings``
    (cycles) and ``predicted_joule_savings`` (configuration pJ —
    negative means the knob *costs* energy, e.g. burst-DMA descriptor
    setup below the link's joule crossover). ``axes_disagree`` marks a
    knob that wins one axis while losing the other; the doctor's
    transcript calls these out so a perf-per-Watt deployment doesn't
    apply a cycle win that regresses tokens/J."""

    action: str
    why: str
    predicted_savings: float | None  # cycles; None = unquantified heuristic
    knob: dict = field(default_factory=dict)
    whatif: object | None = None  # the backing obs.whatif.WhatIf, if any
    bound: bool = False  # savings is an upper bound, not a replay
    predicted_joule_savings: float | None = None  # config pJ; None = unpriced
    axes_disagree: bool = False

    def to_dict(self) -> dict:
        d = {
            "action": self.action,
            "why": self.why,
            "predicted_savings": self.predicted_savings,
            "knob": dict(self.knob),
            "bound": self.bound,
            "predicted_joule_savings": self.predicted_joule_savings,
            "axes_disagree": self.axes_disagree,
        }
        if self.whatif is not None:
            d["whatif"] = self.whatif.to_dict()
        return d


@dataclass(frozen=True)
class Diagnosis:
    """The doctor's full answer for one run."""

    regime: Regime
    lanes: dict  # lane name -> {"kind", "busy_share", "dominant", "label"}
    recommendations: list  # Recommendation, ranked by predicted savings
    stats: dict  # the numbers classify() saw
    notes: list = field(default_factory=list)  # cross-axis caveats

    def to_dict(self) -> dict:
        return {
            "regime": self.regime.to_dict(),
            "lanes": {k: dict(v) for k, v in self.lanes.items()},
            "recommendations": [r.to_dict() for r in self.recommendations],
            "stats": dict(self.stats),
            "notes": list(self.notes),
        }

    def render(self) -> str:
        """The doctor transcript (what the CLI prints)."""
        r = self.regime
        out = [
            f"config-wall doctor — makespan "
            f"{self.stats['makespan']:.1f} cycles",
            f"regime: {r.label.upper().replace('_', '-')} — {r.reason}",
            f"  exposed config {self.stats['exposed_config']:.1f} cycles "
            f"({r.exposed_share:.1%} of makespan, "
            f"{r.exposed_fraction:.1%} of T_set host-visible)",
            "lanes:",
        ]
        for name, lane in sorted(self.lanes.items()):
            out.append(f"  {name:<34s} {lane['kind']:<7s} "
                       f"busy {lane['busy_share']:>6.1%}  "
                       f"dominant: {lane['dominant']}")
        if self.recommendations:
            out.append("recommendations:")
            for i, rec in enumerate(self.recommendations, 1):
                if rec.predicted_savings is None:
                    quant = "(unquantified)"
                else:
                    kind = "≤" if rec.bound else "≈"
                    quant = f"{kind} {rec.predicted_savings:.1f} cycles"
                if rec.predicted_joule_savings is not None:
                    quant += f", {rec.predicted_joule_savings:+.1f} pJ config"
                flag = "  [!] axes disagree" if rec.axes_disagree else ""
                out.append(f"  {i}. {rec.action}: {quant} — {rec.why}{flag}")
        else:
            out.append("recommendations: none — nothing left to hide")
        for note in self.notes:
            out.append(f"note: {note}")
        return "\n".join(out)


# -- classification -----------------------------------------------------------


def classify(*, makespan: float, exposed_config: float, config_cycles: float,
             host_busy: float, wire_busy: float,
             compute_busy: float) -> Regime:
    """The pure rule. Inputs are cycles (busy values are per-kind maxima
    when several lanes of a kind exist — a single saturated resource is
    what binds)."""
    mk = makespan if makespan > 0.0 else 1.0
    shares = {
        "host": host_busy / mk,
        "wire": wire_busy / mk,
        "compute": compute_busy / mk,
    }
    exposed_share = exposed_config / mk
    exposed_fraction = (exposed_config / config_cycles
                        if config_cycles > 0.0 else 0.0)
    if max(shares.values()) < ARRIVAL_BUSY_SHARE:
        label, reason = "arrival_limited", (
            f"no lane is busy ≥ {ARRIVAL_BUSY_SHARE:.0%} of the run "
            f"(max {max(shares.values()):.1%}); the arrival stream is "
            f"the bottleneck")
    elif exposed_share >= CONFIG_BOUND_SHARE:
        label, reason = "config_bound", (
            f"host-visible configuration is {exposed_share:.1%} of "
            f"makespan (≥ {CONFIG_BOUND_SHARE:.0%}); the run sits left "
            f"of the Eq. 4 ridge")
    elif shares["wire"] > shares["compute"]:
        label, reason = "wire_bound", (
            f"the config wire ({shares['wire']:.1%} busy) out-busies "
            f"compute ({shares['compute']:.1%}); transfers hide but the "
            f"link saturates")
    else:
        label, reason = "compute_bound", (
            f"compute dominates ({shares['compute']:.1%} busy, exposed "
            f"config only {exposed_share:.1%}); the run sits right of "
            f"the ridge")
    return Regime(label=label, exposed_share=exposed_share,
                  exposed_fraction=exposed_fraction, shares=shares,
                  reason=reason)


def classify_cell(cell: dict) -> Regime:
    """Classify one ``BENCH_config_overlap.json`` mode cell (the dict with
    ``makespan`` / ``exposed`` / ``config_cycles`` / per-lane busy keys) —
    what ``benchmarks/doctor_gate.py`` sweeps."""
    return classify(
        makespan=cell["makespan"],
        exposed_config=cell["exposed_config_cycles"],
        config_cycles=cell["config_cycles"],
        host_busy=cell["host_busy"],
        wire_busy=cell["wire_busy"],
        compute_busy=cell["compute_busy"],
    )


# -- lane-level view ----------------------------------------------------------

_LANE_LABEL = {"host": "config_bound", "wire": "wire_bound",
               "compute": "compute_bound"}


def _lane_views(att) -> dict:
    """Per-lane summaries out of an attribution (object or dict)."""
    lanes = att["lanes"] if isinstance(att, dict) else {
        name: {"kind": l.kind, "components": l.components}
        for name, l in att.lanes.items()}
    makespan = att["makespan"] if isinstance(att, dict) else att.makespan
    mk = makespan if makespan > 0.0 else 1.0
    views = {}
    for name, lane in lanes.items():
        comps = {k: v for k, v in lane["components"].items() if k != "idle"}
        busy = sum(comps.values())
        dominant = max(comps, key=comps.get) if comps else "idle"
        views[name] = {
            "kind": lane["kind"],
            "busy_share": busy / mk,
            "dominant": dominant,
            "label": (_LANE_LABEL[lane["kind"]]
                      if busy / mk >= ARRIVAL_BUSY_SHARE else "idle"),
        }
    return views


def _kind_maxima(views: dict, makespan: float) -> dict:
    mk = makespan if makespan > 0.0 else 1.0
    out = {"host": 0.0, "wire": 0.0, "compute": 0.0}
    for lane in views.values():
        out[lane["kind"]] = max(out[lane["kind"]], lane["busy_share"] * mk)
    return out


# -- live diagnosis -----------------------------------------------------------


def _scheduler_reports(report) -> list:
    """The underlying SchedulerReports of any run report (duck-typed the
    same way attribution is): a SchedulerReport is itself, a cluster's are
    its hosts', a bridge's are its cluster's."""
    if hasattr(report, "cluster"):
        report = report.cluster
    if hasattr(report, "hosts"):
        return [rep for _, rep in sorted(report.hosts.items())]
    return [report]


def _quantified(report) -> list[Recommendation]:
    """Replay-priced recommendations, summed across the run's schedulers
    (savings on different hosts accrue independently — each host's makespan
    contribution shrinks by its own replay delta)."""
    per_action: dict[str, dict] = {}
    for rep in _scheduler_reports(report):
        buffers = getattr(rep, "staging_buffers", 2)
        candidates = [
            _whatif.predict_overlap(rep),
            _whatif.predict_burst(rep),
            _whatif.predict_staging(rep, buffers=buffers + 1),
        ]
        for wi in candidates:
            if wi is None or wi.predicted_savings <= 0.0:
                continue
            slot = per_action.setdefault(
                wi.action, {"savings": 0.0, "joules": 0.0, "priced": True,
                            "knob": wi.knob, "whatif": wi})
            slot["savings"] += wi.predicted_savings
            joules = wi.predicted_joule_savings
            if joules is None:
                slot["priced"] = False  # one unpriceable wire poisons the sum
            else:
                slot["joules"] += joules
            if wi.predicted_savings > slot["whatif"].predicted_savings:
                slot["whatif"] = wi
    why = {
        "enable_overlap": "stage async burst DMA behind compute "
                          "(runtime §5.5 overlap)",
        "burst_dma": "coalesce ≥8-field MMIO write plans into one DMA "
                     "burst descriptor",
        "staging_buffers": "one more configuration bank deepens the "
                           "config/compute pipeline",
    }
    out = []
    for action, slot in per_action.items():
        joules = slot["joules"] if slot["priced"] else None
        out.append(Recommendation(
            action=action, why=why.get(action, action),
            predicted_savings=slot["savings"],
            knob=slot["knob"], whatif=slot["whatif"],
            predicted_joule_savings=joules,
            axes_disagree=(joules is not None
                           and (slot["savings"] > 0.0 > joules
                                or joules > 0.0 > slot["savings"]))))
    return out


def _heuristics(report) -> list[Recommendation]:
    recs = []
    sched_reps = _scheduler_reports(report)
    evictions = 0
    for rep in sched_reps:
        for stats in rep.cache_stats.values():
            evictions += getattr(stats, "evictions", 0)
    if evictions:
        recs.append(Recommendation(
            action="resize_cache",
            why=f"{evictions} context evictions re-sent register state a "
                f"resident context would have elided; raise max_contexts",
            predicted_savings=None, knob={"max_contexts": "+1"}))
    if len(sched_reps) > 1:
        busiest = [(sum(d.busy_cycles for d in rep.devices.values()), i)
                   for i, rep in enumerate(sched_reps)]
        hi = max(busiest)[0]
        lo = min(busiest)[0]
        if hi > 0.0 and lo < 0.5 * hi:
            recs.append(Recommendation(
                action="warm_migrate",
                why=f"host load imbalance (busiest {hi:.0f} vs idlest "
                    f"{lo:.0f} compute cycles); warm-migrate a resident "
                    f"tenant over the fabric (register-snapshot hand-off)",
                predicted_savings=None, knob={"shed": True}))
    return recs


def diagnose(report) -> Diagnosis:
    """Classify a live run report and rank its mitigations. Accepts a
    ``SchedulerReport``, ``ClusterReport`` or ``BridgeReport`` — anything
    :func:`~repro.obs.attribution.attribute` takes."""
    att = attribute(report)
    views = _lane_views(att)
    busy = _kind_maxima(views, att.makespan)
    exposed = att.summary["exposed_config"]
    config = exposed + att.summary["overlapped_config"]
    regime = classify(
        makespan=att.makespan, exposed_config=exposed, config_cycles=config,
        host_busy=busy["host"], wire_busy=busy["wire"],
        compute_busy=busy["compute"])
    recs = _quantified(report) + _heuristics(report)
    recs.sort(key=lambda r: -(r.predicted_savings or 0.0))
    return Diagnosis(
        regime=regime, lanes=views, recommendations=recs,
        stats={
            "makespan": att.makespan,
            "exposed_config": exposed,
            "config_cycles": config,
            **{f"{k}_busy": v for k, v in busy.items()},
        },
        notes=_axis_notes(recs))


def _axis_notes(recs: list) -> list[str]:
    """Cross-axis caveats: per-knob disagreements, plus a ranking flip
    when the best cycle saver is not the best joule saver — the exact
    case where 'make it faster' and 'make it cheaper per token' pick
    different knobs."""
    notes = []
    for rec in recs:
        if rec.axes_disagree:
            notes.append(
                f"{rec.action} saves {rec.predicted_savings:.1f} cycles but "
                f"changes config energy by "
                f"{-rec.predicted_joule_savings:+.1f} pJ — a cycle win that "
                f"costs joules; rank by objective='joules' before applying "
                f"on a power-capped pool")
    priced = [r for r in recs if r.predicted_savings is not None
              and r.predicted_joule_savings is not None]
    if len(priced) > 1:
        by_cycles = max(priced, key=lambda r: r.predicted_savings)
        by_joules = max(priced, key=lambda r: r.predicted_joule_savings)
        if by_cycles.action != by_joules.action:
            notes.append(
                f"ranking depends on the axis: {by_cycles.action} saves the "
                f"most cycles ({by_cycles.predicted_savings:.1f}) but "
                f"{by_joules.action} saves the most configuration energy "
                f"({by_joules.predicted_joule_savings:.1f} pJ)")
    return notes


# -- diagnosis from a serialized trace ----------------------------------------


def diagnose_doc(doc: dict) -> Diagnosis:
    """Diagnose a ``TRACE_*.json`` document (as ``obs.export.write_trace``
    wrote it). The launch log is gone, so recommendations are *bounds*:
    the wire share of exposed configuration is the most overlap could
    hide; ``bound=True`` marks them."""
    att = doc.get("attribution")
    assert att, "trace document carries no attribution block"
    makespan = att["makespan"]
    views = _lane_views(att)
    busy = _kind_maxima(views, makespan)
    summary = att["summary"]
    exposed = summary["exposed_config"]
    config = exposed + summary["overlapped_config"]
    regime = classify(
        makespan=makespan, exposed_config=exposed, config_cycles=config,
        host_busy=busy["host"], wire_busy=busy["wire"],
        compute_busy=busy["compute"])
    recs = []
    hideable = max(0.0, exposed - summary.get("host_occupancy", 0.0))
    if summary.get("overlapped_config", 0.0) == 0.0 and hideable > 0.0:
        recs.append(Recommendation(
            action="enable_overlap",
            why="nothing overlapped this run; the wire share of exposed "
                "T_set is the most async staging could hide",
            predicted_savings=hideable, knob={"overlap": "overlapped"},
            bound=True))
    queueing = summary.get("queueing", 0.0)
    if regime.label == "config_bound" and queueing > 0.0:
        recs.append(Recommendation(
            action="reduce_queueing",
            why=f"launches queued {queueing:.0f} cycles behind a "
                f"config-bound host; shrinking T_set drains the backlog",
            predicted_savings=None, knob={}))
    recs.sort(key=lambda r: -(r.predicted_savings or 0.0))
    return Diagnosis(
        regime=regime, lanes=views, recommendations=recs,
        stats={
            "makespan": makespan,
            "exposed_config": exposed,
            "config_cycles": config,
            **{f"{k}_busy": v for k, v in busy.items()},
        })
