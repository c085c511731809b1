"""The paper's contribution, copied from the JAX package: the accfg IR
and its imperative constructor (:mod:`~repro_torch.core.builder`), the
optimization passes (:mod:`~repro_torch.core.passes`: ``baseline`` and the
``optimize`` pipeline of state tracing, LICM, dedup and overlap), lowering
to register writes (:mod:`~repro_torch.core.lowering`), the tiled matmul
programs the paper evaluates (:mod:`~repro_torch.core.matmul_driver`), the
accelerator models and the cycle-approximate interpreter whose ``Trace``
timelines the scheduler and cluster reports export, the per-level
evaluation (``evaluate_levels``), the configuration roofline, ASCII
timelines and the shared ``geomean``."""

from . import (
    accelerators,
    builder,
    evaluate,
    interp,
    ir,
    lowering,
    matmul_driver,
    passes,
    roofline,
    stats,
    timeline,
)
from .accelerators import REGISTRY, AcceleratorModel, gemmini_like, opengemm_like
from .builder import Builder
from .evaluate import evaluate as evaluate_levels
from .evaluate import geomean, speedup
from .interp import Trace, run
from .ir import Module
from .roofline import (
    RooflinePoint,
    concurrent_config_roofline,
    config_bound,
    effective_config_bandwidth,
    knee_point,
    processor_roofline,
    roofsurface,
    sequential_config_roofline,
)

__all__ = [
    "REGISTRY",
    "AcceleratorModel",
    "Builder",
    "Module",
    "RooflinePoint",
    "Trace",
    "accelerators",
    "builder",
    "concurrent_config_roofline",
    "config_bound",
    "effective_config_bandwidth",
    "evaluate",
    "evaluate_levels",
    "geomean",
    "gemmini_like",
    "interp",
    "ir",
    "knee_point",
    "lowering",
    "matmul_driver",
    "opengemm_like",
    "passes",
    "processor_roofline",
    "roofline",
    "roofsurface",
    "run",
    "sequential_config_roofline",
    "speedup",
    "stats",
    "timeline",
]
