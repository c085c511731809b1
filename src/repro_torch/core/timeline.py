"""Figure-2-style timelines from interpreter traces.

The port's own copy of ``repro/core/timeline.py``: the code is the
reference's, unchanged.

The paper's Figure 2 shows the configuration wall as idle accelerator gaps
between macro-operations while the host configures. This module renders the
same picture from a :class:`~repro.core.interp.Trace`: an ASCII gantt of
accelerator busy intervals, plus the utilization summary the figure implies.
"""

from __future__ import annotations

from .interp import Trace


def accel_utilization(trace: Trace) -> float:
    if trace.total_cycles == 0:
        return 0.0
    return trace.accel_busy_cycles / trace.total_cycles


def idle_gaps(trace: Trace) -> list[tuple[float, float]]:
    """Gaps where the accelerator sits idle between macro-operations."""
    gaps = []
    t = 0.0
    for inv in trace.invocations:
        if inv.start > t:
            gaps.append((t, inv.start))
        t = max(t, inv.end)
    if trace.total_cycles > t:
        gaps.append((t, trace.total_cycles))
    return gaps


def render(trace: Trace, width: int = 72, label: str = "") -> str:
    """ASCII gantt: each cell shows the fraction of its time-slice the
    accelerator was busy ('#' ≥ 2/3, '+' ≥ 1/3, '.' mostly idle)."""
    total = trace.total_cycles or 1.0
    busy = [0.0] * width
    cell_w = total / width
    for inv in trace.invocations:
        lo_f, hi_f = inv.start / cell_w, inv.end / cell_w
        lo, hi = int(lo_f), min(int(hi_f), width - 1)
        for i in range(lo, hi + 1):
            seg = min(hi_f, i + 1) - max(lo_f, i)
            busy[i] += max(seg, 0.0)
    bar = "".join(
        "#" if b >= 0.75 else "+" if b >= 0.4 else ":" if b >= 0.15 else "."
        for b in busy
    )
    util = accel_utilization(trace)
    head = f"{label:10s}" if label else ""
    return (
        f"{head}|{bar}| {trace.total_cycles:9.0f} cyc, "
        f"accel busy {util * 100:5.1f}%"
    )


def compare(traces: dict[str, Trace], width: int = 72) -> str:
    """Render several optimization levels one under another (Figure 7)."""
    return "\n".join(render(t, width, label=name) for name, t in traces.items())
