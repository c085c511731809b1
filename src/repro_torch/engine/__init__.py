"""The port's engine layer: the calibrated compute model
(:mod:`~repro_torch.engine.costmodel`, a copy of the JAX package's) and the
calibration harness that fits it against the port's kernels on the card
(``python -m repro_torch.engine.calibrate``)."""

from .costmodel import (CALIBRATION_PATH, KERNELS, ComputeModel, KernelFit,
                        fit_overhead, load_fits, save_fits)

__all__ = ["CALIBRATION_PATH", "KERNELS", "ComputeModel", "KernelFit",
           "fit_overhead", "load_fits", "save_fits"]
