"""The port's engine layer: the host/wire/compute resources one scheduler
dispatches onto (:mod:`~repro_torch.engine.resources`), the serialized vs.
overlapped staging policy (:mod:`~repro_torch.engine.overlap`), the
calibrated compute model (:mod:`~repro_torch.engine.costmodel`), the knob
tuner that picks ``overlap`` and ``staging_buffers`` from the predicted
wire/compute ratio (:mod:`~repro_torch.engine.autotune`), all copies of
the JAX package's, and the calibration harness that fits the compute
model against the port's kernels on the card
(``python -m repro_torch.engine.calibrate``)."""

from . import autotune, costmodel, overlap, resources
from .autotune import TunedKnobs, tune, tune_from_ratio
from .costmodel import (
    CALIBRATION_PATH,
    COMPUTE_MODES,
    KERNELS,
    ComputeModel,
    KernelFit,
    fit_overhead,
    load_fits,
    resolve_compute_model,
    save_fits,
)
from .overlap import ASYNC_XFER_MODES, OVERLAP_MODES, OverlapPolicy, StagePlan
from .resources import (
    EngineResources,
    Interval,
    Resource,
    merge_intervals,
    overlap_cycles,
)

__all__ = [
    "ASYNC_XFER_MODES",
    "CALIBRATION_PATH",
    "COMPUTE_MODES",
    "KERNELS",
    "OVERLAP_MODES",
    "ComputeModel",
    "EngineResources",
    "Interval",
    "KernelFit",
    "OverlapPolicy",
    "Resource",
    "StagePlan",
    "TunedKnobs",
    "autotune",
    "costmodel",
    "fit_overhead",
    "load_fits",
    "merge_intervals",
    "overlap",
    "overlap_cycles",
    "resolve_compute_model",
    "resources",
    "save_fits",
    "tune",
    "tune_from_ratio",
]
