"""The cycle-approximate core the port's scheduler and bridge price
launches with: the accelerator models, the accfg IR and its interpreter
(whose ``Trace`` timelines the scheduler and cluster reports export), the
configuration roofline and the shared ``geomean``. These are copies of
the JAX package's modules; the accfg passes, IR construction, lowering
and evaluation are queued in ``ROADMAP.md``."""

from . import accelerators, interp, ir, roofline, stats
from .accelerators import REGISTRY, AcceleratorModel, gemmini_like, opengemm_like
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
    "Module",
    "RooflinePoint",
    "Trace",
    "accelerators",
    "concurrent_config_roofline",
    "config_bound",
    "effective_config_bandwidth",
    "gemmini_like",
    "interp",
    "ir",
    "knee_point",
    "opengemm_like",
    "processor_roofline",
    "roofline",
    "roofsurface",
    "run",
    "sequential_config_roofline",
    "stats",
]
