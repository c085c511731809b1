"""Evaluation harness: run a workload under each optimization level.

The port's own copy of ``repro/core/evaluate.py``: the code is the
reference's, unchanged.

Reproduces the paper's measurement methodology (§6): the same source program
is compiled at four levels — baseline (volatile-asm model), +dedup, +overlap,
+both — executed on the cycle-approximate interpreter, and placed on the
configuration roofline. Functional equivalence (identical launch logs) is
asserted on every run: an optimization that changes observable accelerator
behaviour is a compiler bug, not a speedup.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

from . import passes
from .accelerators import AcceleratorModel
from .interp import Trace, run
from .ir import Module
from .roofline import RooflinePoint


@dataclass
class LevelResult:
    level: str
    trace: Trace
    point: RooflinePoint


def evaluate(
    module_fn,
    models: dict[str, AcceleratorModel],
    levels: tuple[str, ...] = ("baseline", "dedup", "overlap", "both"),
    check_equivalence: bool = True,
) -> dict[str, LevelResult]:
    """``module_fn`` builds a fresh module (passes mutate in place)."""
    concurrent = {name for name, m in models.items() if m.concurrent}
    results: dict[str, LevelResult] = {}
    reference_log = None
    for level in levels:
        module: Module = module_fn()
        if level == "baseline":
            passes.baseline(module)
        else:
            passes.optimize(
                module,
                concurrent_accels=concurrent,
                do_dedup=level in ("dedup", "both"),
                do_overlap=level in ("overlap", "both"),
            )
        trace = run(module, models)
        if check_equivalence:
            sig = trace.log_signature()
            if reference_log is None:
                reference_log = sig
            else:
                assert sig == reference_log, f"{level}: invocation log diverged"
        model = next(iter(models.values()))
        results[level] = LevelResult(
            level=level,
            trace=trace,
            point=RooflinePoint(
                name=level,
                i_oc=trace.i_oc,
                performance=trace.performance,
                p_peak=model.p_peak,
                bw_config=model.bw_config,
            ),
        )
    return results


def speedup(results: dict[str, LevelResult], level: str = "both") -> float:
    return results["baseline"].trace.total_cycles / results[level].trace.total_cycles


# one shared definition for every BENCH_* summary (re-exported here for
# the historical call sites; non-positive terms collapse the mean to 0.0)
from .stats import geomean  # noqa: E402
