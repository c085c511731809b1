"""Shared summary statistics — one ``geomean`` for the whole repo.

The port's own copy of ``repro/core/stats.py``: the code is the
reference's, unchanged.

Two definitions used to coexist: ``sched.telemetry.geomean`` collapsed any
non-positive term to 0.0 (a collapsed benchmark cell must drag the summary
to zero, not vanish from it), while ``core.evaluate.geomean`` assumed
all-positive inputs and raised on zeros. Every ``BENCH_*.json`` summary,
CI geomean gate, and report now shares the collapsing definition below;
both historical call sites re-export it unchanged.
"""

from __future__ import annotations

from typing import Iterable


def geomean(values: Iterable[float]) -> float:
    """Geometric mean; 0.0 for an empty sequence or any non-positive term —
    a collapsed cell must drag the summary to zero, not vanish from it."""
    vals = list(values)
    if not vals or any(v <= 0.0 for v in vals):
        return 0.0
    prod = 1.0
    for v in vals:
        prod *= v
    return prod ** (1.0 / len(vals))
