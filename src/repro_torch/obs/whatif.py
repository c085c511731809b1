"""What-if estimation: predicted cycle savings behind each doctor knob.

The port's own copy of ``repro/obs/whatif.py``: the code is the
reference's, unchanged.

The doctor's recommendations ("enable overlap", "switch MMIO to burst
DMA", "raise ``staging_buffers``") are only useful quantified. This module
prices them by *replaying* a finished run's launch log through a faithful
model of the engine's dispatch recurrence — the same host-reserve /
wire-acquire / bank-wait / ring-full arithmetic ``OverlapPolicy.stage`` and
``LaunchQueue.submit`` perform — once with the run's recorded knobs and
once with the suggested knob flipped. The predicted saving is the
difference between the two replays, so any residual model bias cancels.

What stays fixed across a replay: the request stream, its per-launch cache
write-plans (field counts are a function of the stream, not of timing),
placement, and macro-op durations. What the knob changes: transfer pricing
(MMIO vs burst), whether a transfer may stream asynchronously behind
compute, and how many configuration banks bound the stream's pipelining.
Preempted launches are not replayed — their cycles were already refunded
by the scheduler — so predictions on priority-preemption runs are
approximate; the replay fidelity is reported per estimate
(``detail["replay_error"]``) and pinned ≤ 15% against actual re-simulated
savings in ``tests/test_doctor.py``.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from ..fabric.link import LinkModel, resolve_link
from ..fabric.transport import burst_schedule, mmio_schedule

__all__ = [
    "LaunchRow", "Replay", "WhatIf",
    "extract_rows", "replay", "rows_config_energy",
    "predict_overlap", "predict_burst", "predict_staging",
]


@dataclass(frozen=True)
class LaunchRow:
    """One recorded launch, reduced to what the dispatch recurrence needs."""

    arrival: float  # open-loop arrival (host idles forward to it)
    dev: str  # device id (placement is held fixed across replays)
    concurrent: bool  # device configuration discipline
    host_cycles: float  # T_calc + issue (host instruction time)
    wire_cycles: float  # time on the wire (0 on a core-local CSR port)
    compute_cycles: float  # macro-op duration
    xfer_mode: str  # "mmio" | "burst" — as the transport layer priced it
    n_fields: int  # fields actually sent (cache delta; launch excluded)


@dataclass(frozen=True)
class Replay:
    """One pass of the dispatch recurrence over a row list."""

    makespan: float
    exposed_config: float  # host-visible config cycles, summed
    config_cycles: float  # total T_set, summed


@dataclass(frozen=True)
class WhatIf:
    """One quantified recommendation: knob → predicted effect.

    Mitigations are priced on *two* axes. Cycles: the replay difference.
    Joules: the change in configuration energy (host issue + wire
    handshakes/descriptors, re-priced per launch through the link's
    energy rates). The axes can disagree — runtime overlap hides T_set
    without saving a single transfer joule, and burst DMA can win cycles
    while its descriptor-setup energy loses joules below the link's
    joule-crossover — and :attr:`axes_disagree` is how the doctor says
    so."""

    action: str  # "enable_overlap" | "burst_dma" | "staging_buffers"
    knob: dict  # scheduler kwargs realizing the suggestion
    baseline_makespan: float  # the run's actual makespan
    predicted_makespan: float
    predicted_savings: float  # baseline replay − modified replay
    baseline_config_energy: float | None = None  # pJ, None = unpriceable
    predicted_config_energy: float | None = None
    detail: dict = field(default_factory=dict)

    @property
    def predicted_speedup(self) -> float:
        if self.predicted_makespan <= 0.0:
            return 1.0
        return self.baseline_makespan / self.predicted_makespan

    @property
    def predicted_joule_savings(self) -> float | None:
        if self.baseline_config_energy is None:
            return None
        return self.baseline_config_energy - self.predicted_config_energy

    @property
    def axes_disagree(self) -> bool:
        """Does this knob save cycles while *costing* configuration
        joules (or vice versa)? Zero joule delta (overlap, staging) is
        agreement — nothing was spent to buy the cycles."""
        joules = self.predicted_joule_savings
        if joules is None:
            return False
        return (self.predicted_savings > 0.0 > joules
                or joules > 0.0 > self.predicted_savings)

    def to_dict(self) -> dict:
        return {
            "action": self.action,
            "knob": dict(self.knob),
            "baseline_makespan": self.baseline_makespan,
            "predicted_makespan": self.predicted_makespan,
            "predicted_savings": self.predicted_savings,
            "predicted_speedup": self.predicted_speedup,
            "baseline_config_energy": self.baseline_config_energy,
            "predicted_config_energy": self.predicted_config_energy,
            "predicted_joule_savings": self.predicted_joule_savings,
            "axes_disagree": self.axes_disagree,
            "detail": dict(self.detail),
        }


# -- row extraction ----------------------------------------------------------


def report_link(rep) -> LinkModel | None:
    """The link class a scheduler report's transfers crossed. ``None``
    when the report has no link telemetry (or mixes link classes — the
    replay prices one wire, matching the scheduler's single port)."""
    kinds = {lt.kind for lt in getattr(rep, "links", {}).values()}
    if len(kinds) != 1:
        return None
    return resolve_link(kinds.pop())


def extract_rows(rep) -> list[LaunchRow]:
    """Reduce a :class:`~repro.sched.telemetry.SchedulerReport` to replay
    rows, in dispatch order (the host clock is global and strictly
    increasing across launches, so ``issue`` orders them totally)."""
    link = report_link(rep)
    transport = getattr(rep, "transport", "auto")
    recs = []
    for dev_id, tel in rep.devices.items():
        for rec in tel.launch_log:
            recs.append((rec.issue, dev_id, tel.model, rec))
    recs.sort(key=lambda r: r[0])
    rows = []
    for _, dev_id, model, rec in recs:
        wire = rec.config_done - rec.wire_start
        n_fields = max(0, round(rec.bytes_sent / model.bytes_per_field) - 1)
        rows.append(LaunchRow(
            arrival=rec.arrival,
            dev=dev_id,
            concurrent=model.concurrent,
            host_cycles=rec.host_cycles,
            wire_cycles=wire,
            compute_cycles=rec.end - rec.start,
            xfer_mode=_infer_mode(n_fields, model, link,
                                  rec.host_cycles, wire, transport),
            n_fields=n_fields,
        ))
    return rows


def _infer_mode(n_fields: int, model, link: LinkModel | None,
                host_cycles: float, wire_cycles: float,
                transport: str = "auto") -> str:
    """Which transport discipline priced this launch. A forced transport
    knob answers directly; under ``auto`` the recorded
    ``(host_cycles, wire_cycles)`` pair is the pricing function's exact
    output, so matching it against the two candidate schedules recovers
    the choice without a separate log field."""
    if link is None or not link.supports_dma or transport == "mmio":
        return "mmio"
    if transport == "burst":
        return "burst"
    burst = burst_schedule(n_fields, model, link)
    if (burst is not None and burst.host_cycles == host_cycles
            and burst.link_cycles == wire_cycles):
        return "burst"
    return "mmio"


# -- the dispatch recurrence -------------------------------------------------


def replay(rows: list[LaunchRow], *, mode: str, buffers: int = 2,
           depth: int = 2) -> Replay:
    """Run the engine's dispatch recurrence over ``rows``.

    Mirrors ``Scheduler._dispatch_on`` exactly: host reservation at the
    scalar clock, FIFO wire acquisition (async transfers additionally wait
    for a free configuration bank), captive vs released host, depth-k
    staging-ring admission, and per-device FIFO compute. Returns the
    replayed makespan plus the exposed/total config split the roofline
    reads."""
    host = 0.0  # the host resource's committed time (the scalar clock)
    wire_free = 0.0
    compute: dict[str, list] = {}  # per-device (start, end), dispatch order
    inflight: dict[str, deque] = {}
    exposed = 0.0
    config = 0.0

    for row in rows:
        host = max(host, row.arrival)  # open-loop admission idle
        h_end = host + row.host_cycles
        is_async = (mode == "overlapped" and row.concurrent
                    and row.xfer_mode == "burst" and row.wire_cycles > 0.0)
        done = compute.setdefault(row.dev, [])
        earliest = h_end
        if is_async and len(done) >= buffers:
            # the shadow bank frees at launch k-buffers' retirement
            earliest = max(earliest, done[len(done) - buffers][1])
        w_start = max(earliest, wire_free)
        w_end = w_start + row.wire_cycles
        wire_free = w_end
        config_done = w_end
        host = h_end if is_async else max(h_end, w_end)
        # exposed T_set: instruction time plus wire cycles that *earlier*
        # compute on this device failed to cover (for a captive transfer,
        # everything) — mirrors Scheduler._dispatch_on's hidden term
        cfg = row.host_cycles + row.wire_cycles
        config += cfg
        hidden = 0.0
        if is_async:
            for s, e in done:
                hidden += max(0.0, min(w_end, e) - max(w_start, s))
        exposed += cfg - hidden
        # -- LaunchQueue.submit --
        ring = inflight.setdefault(row.dev, deque())
        if row.concurrent:
            while ring and ring[0] <= host:
                ring.popleft()
            while len(ring) >= depth:  # staging ring full: host blocks
                host = max(host, ring.popleft())
        free = done[-1][1] if done else 0.0
        start = max(host, config_done, free)
        end = start + row.compute_cycles
        done.append((start, end))
        if row.concurrent:
            ring.append(end)
        else:
            host = end

    frees = [iv[-1][1] for iv in compute.values() if iv]
    makespan = max([host, *frees]) if rows else 0.0
    return Replay(makespan=makespan, exposed_config=exposed,
                  config_cycles=config)


def rows_config_energy(rows, models, link: LinkModel | None) -> float | None:
    """Total configuration energy (pJ) of a row list under ``link``'s
    energy rates: each launch re-priced through the schedule its
    ``xfer_mode`` names (host issue energy + wire handshake/descriptor +
    streamed bytes). This is the joule axis of every what-if: replay
    timing never enters — moving a transfer in time (overlap, staging)
    leaves its energy untouched, while re-pricing it (burst) does not.
    ``None`` when the report's wire is unpriceable (no/mixed links)."""
    if link is None:
        return None
    total = 0.0
    for r in rows:
        model = models[r.dev]
        xfer = None
        if r.xfer_mode == "burst":
            xfer = burst_schedule(r.n_fields, model, link)
        if xfer is None:
            xfer = mmio_schedule(r.n_fields, model, link)
        total += xfer.energy
    return total


# -- estimators --------------------------------------------------------------


def _estimate(rep, action: str, knob: dict, base_rows, base_kw: dict,
              mod_rows, mod_kw: dict, detail: dict | None = None) -> WhatIf:
    base = replay(base_rows, **base_kw)
    mod = replay(mod_rows, **mod_kw)
    savings = base.makespan - mod.makespan
    actual = rep.makespan
    err = abs(base.makespan - actual) / actual if actual else 0.0
    d = dict(detail or {})
    d.update({
        "replayed_baseline": base.makespan,
        "replayed_modified": mod.makespan,
        "replay_error": err,
        "exposed_config_after": mod.exposed_config,
    })
    link = report_link(rep)
    models = {dev_id: tel.model for dev_id, tel in rep.devices.items()}
    base_e = rows_config_energy(base_rows, models, link)
    mod_e = rows_config_energy(mod_rows, models, link)
    return WhatIf(
        action=action,
        knob=knob,
        baseline_makespan=actual,
        predicted_makespan=actual - savings,
        predicted_savings=savings,
        baseline_config_energy=base_e,
        predicted_config_energy=mod_e,
        detail=d,
    )


def predict_overlap(rep, *, buffers: int | None = None,
                    depth: int = 2) -> WhatIf | None:
    """What would runtime overlap buy this serialized run? ``None`` when
    the run is already overlapped or nothing could stream (no async-eligible
    burst transfer onto a concurrent device)."""
    if getattr(rep, "overlap_mode", "serialized") == "overlapped":
        return None
    rows = extract_rows(rep)
    eligible = sum(1 for r in rows
                   if r.concurrent and r.xfer_mode == "burst"
                   and r.wire_cycles > 0.0)
    if not eligible:
        return None
    buffers = buffers if buffers is not None else getattr(
        rep, "staging_buffers", 2)
    return _estimate(
        rep, "enable_overlap", {"overlap": "overlapped"},
        rows, dict(mode="serialized", buffers=buffers, depth=depth),
        rows, dict(mode="overlapped", buffers=buffers, depth=depth),
        detail={"async_eligible_launches": eligible},
    )


def predict_burst(rep, *, depth: int = 2) -> WhatIf | None:
    """What would coalescing per-register MMIO into burst DMA buy? Reprices
    every MMIO transfer of ≥ 8 fields through the link's DMA engine (the
    crossover region the paper measures) and replays. ``None`` when the
    link has no DMA engine or no transfer qualifies."""
    link = report_link(rep)
    if link is None or not link.supports_dma:
        return None
    models = {dev_id: tel.model for dev_id, tel in rep.devices.items()}
    rows = extract_rows(rep)
    from dataclasses import replace
    mod_rows, repriced = [], 0
    for r in rows:
        if r.xfer_mode == "mmio" and r.n_fields >= 8:
            xfer = burst_schedule(r.n_fields, models[r.dev], link)
            if xfer is not None:
                mod_rows.append(replace(
                    r, xfer_mode="burst", host_cycles=xfer.host_cycles,
                    wire_cycles=xfer.link_cycles))
                repriced += 1
                continue
        mod_rows.append(r)
    if not repriced:
        return None
    mode = getattr(rep, "overlap_mode", "serialized")
    buffers = getattr(rep, "staging_buffers", 2)
    kw = dict(mode=mode, buffers=buffers, depth=depth)
    return _estimate(
        rep, "burst_dma", {"transport": "burst"},
        rows, kw, mod_rows, kw,
        detail={"repriced_launches": repriced},
    )


def predict_staging(rep, *, buffers: int = 2, depth: int = 2) -> WhatIf | None:
    """What would ``staging_buffers=buffers`` buy an overlapped run whose
    async transfers wait on configuration banks? ``None`` for serialized
    runs (banks never bound a captive transfer) or when the run already
    has that many banks."""
    if getattr(rep, "overlap_mode", "serialized") != "overlapped":
        return None
    current = getattr(rep, "staging_buffers", 2)
    if buffers == current:
        return None
    rows = extract_rows(rep)
    return _estimate(
        rep, "staging_buffers", {"staging_buffers": buffers},
        rows, dict(mode="overlapped", buffers=current, depth=depth),
        rows, dict(mode="overlapped", buffers=buffers, depth=depth),
        detail={"buffers_before": current, "buffers_after": buffers},
    )
