"""Calibrated analytical compute model — per-kernel-shape cycle prediction.

The port's own copy of ``repro/engine/costmodel.py``, unchanged but for
where its fits live: ``CALIBRATION_PATH`` is the port's
``repro_torch/engine/calibration.json``, written by
``python -m repro_torch.engine.calibrate`` from the port's kernels on the
card. The JAX package's interpret-mode fits stay where they are.

Until now every launch's compute duration was a flat constant per macro-op:
``AcceleratorModel.macro_cycles`` prices ``launch_latency + ops/p_peak``,
the ideal datapath time, as if loop control, tile fetches, and pipeline
stalls were free. That undersells the configuration wall's other side — the
overlap engine's wire/compute ratio, the router's placement probes, and the
doctor's what-if replays are all anchored to a made-up number.

The fix is the standard analytical form (Prajapati et al., arXiv:1802.01957;
the csl-experiments GEMM model): per kernel shape,

    cycles = issue(shape)  +  overhead_factor × work(shape)

where

* ``issue(shape)`` — launch setup plus one issue cycle per grid step
  (``depth × (launch_latency + steps(M, K, N))``, steps from the device's
  tile): the loop-control floor no datapath width removes;
* ``work(shape)`` — the ideal datapath term (``ops(M, K, N) / p_peak``);
* ``overhead_factor`` — a **measured** dimensionless factor folding in
  everything the analytical minimum omits (loop control, memory ops, task
  switching, pipeline stalls), fitted per kernel against wall-clock timings
  of the real kernels (``engine.calibrate``). On hardware it lands
  ≥ 1 (measured work can't beat the datapath minimum); under interpret-mode
  calibration it can be < 1, because a CPU emulating the grid pays per
  step, not per datapath op.

Fits persist to a committed ``calibration.json`` next to this module, so CI
and tests are deterministic without re-timing; the harness that produced
them can be re-run with ``python -m repro_torch.engine.calibrate``.

:class:`ComputeModel` is the scheduler-facing object. ``mode="flat"``
reproduces ``AcceleratorModel.macro_cycles`` **bit-exactly** (every
committed BENCH number is pinned to it); ``mode="calibrated"`` applies the
fitted per-kernel model, pricing decode and prefill launches by their real
shapes (a chunked prefill's M-scaled GEMM costs more than ``chunk`` decode
steps' ideal time, because its grid issues more steps and its overhead
scales with work).
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Callable, Mapping

from ..core.accelerators import AcceleratorModel

CALIBRATION_PATH = os.path.join(os.path.dirname(__file__), "calibration.json")

COMPUTE_MODES = ("flat", "calibrated")


def _ceil_div(a: float, b: float) -> int:
    a, b = int(a), int(b)
    if a <= 0:
        return 0
    return -(-a // max(b, 1))


@dataclass(frozen=True)
class KernelSpec:
    """Analytical shape terms of one kernel class.

    ``ops(dims)`` is the datapath work (the numerator of the ideal-cycles
    term); ``steps(dims, tile)`` the grid-step count (one issue cycle
    each — the loop-control floor). ``dims`` is the scheduler's logical
    ``(M, K, N)``; kernels that ignore an axis simply don't read it, so
    predictions stay monotone in every axis."""

    name: str
    ops: Callable[[tuple[int, int, int]], float]
    steps: Callable[[tuple[int, int, int], tuple[int, int, int]], int]


KERNELS: dict[str, KernelSpec] = {
    # A(M,K) @ B(K,N): 2·M·K·N ops over a (M/tm)·(K/tk)·(N/tn) grid
    "matmul": KernelSpec(
        "matmul",
        ops=lambda d: 2.0 * d[0] * d[1] * d[2],
        steps=lambda d, t: (_ceil_div(d[0], t[0]) * _ceil_div(d[1], t[1])
                            * _ceil_div(d[2], t[2])),
    ),
    # QKᵀ + PV with M=N=seq, K=head dim: 4·S²·D ops over a (S/tm)·(S/tn)
    # grid (K/V tiles stream per query block; head dim is not tiled)
    "flash_attention": KernelSpec(
        "flash_attention",
        ops=lambda d: 4.0 * d[0] * d[1] * d[2],
        steps=lambda d, t: _ceil_div(d[0], t[0]) * _ceil_div(d[2], t[2]),
    ),
    # blocked argmax scan, M=batch rows, N=vocab: one compare per element
    # over a (N/tn) grid (K unused)
    "sampling": KernelSpec(
        "sampling",
        ops=lambda d: float(d[0] * d[2]),
        steps=lambda d, t: _ceil_div(d[2], t[2]),
    ),
}

# launch-path tags → calibrated kernel classes: the bridge tags decode and
# prefill launches distinctly (both are GEMM-class — the per-shape terms,
# not the alias, price them differently), and unknown tags fall back flat
KERNEL_ALIASES = {
    "decode": "matmul",
    "prefill": "matmul",
    "gemm": "matmul",
    "attention": "flash_attention",
}


def canonical_kernel(kernel: str) -> str:
    return KERNEL_ALIASES.get(kernel, kernel)


@dataclass(frozen=True)
class KernelFit:
    """One kernel's calibration: the measured overhead factor plus the fit's
    provenance (wall-clock scale and quality), so a committed fit is
    auditable without re-timing."""

    kernel: str
    overhead_factor: float  # measured/ideal work-cycle ratio (c_work/c_issue)
    seconds_per_cycle: float  # wall-clock seconds one model cycle mapped to
    r2: float = 0.0  # coefficient of determination of the fit
    n_samples: int = 0  # shapes the fit saw

    def as_dict(self) -> dict:
        return {
            "overhead_factor": self.overhead_factor,
            "seconds_per_cycle": self.seconds_per_cycle,
            "r2": self.r2,
            "n_samples": self.n_samples,
        }


def fit_overhead(issues, works, seconds) -> KernelFit:
    """Fit ``t ≈ c_issue·issue + c_work·work`` (no intercept — a zero-shape
    kernel takes zero time) over measured shapes; the overhead factor is
    ``c_work / c_issue``: how many wall-clock issue-cycle-equivalents one
    ideal work cycle actually took on the measured backend.

    The regression is weighted by 1/t — it minimizes **relative** error,
    not absolute, so a 100 µs shape and a 30 ms shape constrain the fit
    equally (unweighted least squares lets the largest shape's
    cache-pressure tail dominate and overpredicts small shapes several-fold).
    Degenerate solutions (collinear predictors — a balanced GEMM tile makes
    steps ∝ ops — or noise driving a coefficient negative) are projected to
    the boundary: single-scale ``t = c·(issue + work)`` with factor 1.0.
    Interpret-mode factors can be < 1 (a CPU emulating the grid pays per
    *step*, not per datapath op); on real hardware both terms share one
    clock and the factor lands ≥ 1. Deterministic given the measurements:
    CI never re-times, it loads the committed JSON this produced."""
    issues = [float(x) for x in issues]
    works = [float(x) for x in works]
    seconds = [float(x) for x in seconds]
    n = len(seconds)
    assert n == len(issues) == len(works) and n >= 2, "need ≥ 2 shapes"
    assert all(t > 0.0 for t in seconds), "wall-clock samples must be > 0"
    # weighted normal equations: rows scaled by 1/t, target becomes 1
    x_i = [i / t for i, t in zip(issues, seconds)]
    x_w = [w / t for w, t in zip(works, seconds)]
    s_ii = sum(x * x for x in x_i)
    s_iw = sum(a * b for a, b in zip(x_i, x_w))
    s_ww = sum(x * x for x in x_w)
    b_i = sum(x_i)
    b_w = sum(x_w)
    det = s_ii * s_ww - s_iw * s_iw
    c_issue = c_work = 0.0
    if det > 1e-12 * max(s_ii * s_ww, 1e-30):
        c_issue = (b_i * s_ww - b_w * s_iw) / det
        c_work = (s_ii * b_w - s_iw * b_i) / det
    if c_issue <= 0.0 or c_work <= 0.0:
        # boundary projection: t = c·(issue + work), overhead unresolvable
        x_t = [a + b for a, b in zip(x_i, x_w)]
        denom = sum(x * x for x in x_t) or 1.0
        c_issue = c_work = max(sum(x_t) / denom, 1e-30)
    factor = c_work / c_issue
    predicted = [c_issue * i + c_work * w for i, w in zip(issues, works)]
    mean = sum(seconds) / n
    ss_tot = sum((t - mean) ** 2 for t in seconds)
    ss_res = sum((t - p) ** 2 for t, p in zip(seconds, predicted))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0.0 else 1.0
    return KernelFit(kernel="", overhead_factor=factor,
                     seconds_per_cycle=c_issue, r2=r2, n_samples=n)


def load_fits(path: str | None = None) -> dict[str, KernelFit]:
    """Load committed calibration fits (no timing, fully deterministic)."""
    with open(path or CALIBRATION_PATH) as f:
        data = json.load(f)
    fits = {}
    for name, d in data["fits"].items():
        fits[name] = KernelFit(
            kernel=name,
            overhead_factor=float(d["overhead_factor"]),
            seconds_per_cycle=float(d["seconds_per_cycle"]),
            r2=float(d.get("r2", 0.0)),
            n_samples=int(d.get("n_samples", 0)),
        )
    return fits


def save_fits(fits: Mapping[str, KernelFit], path: str,
              *, backend: str = "pallas_interpret",
              samples: Mapping[str, list] | None = None) -> None:
    """Persist fits (plus the raw timing samples, for audit) as the
    committed calibration JSON."""
    data = {
        "version": 1,
        "backend": backend,
        "fits": {name: fit.as_dict() for name, fit in fits.items()},
    }
    if samples:
        data["samples"] = {k: list(v) for k, v in samples.items()}
    with open(path, "w") as f:
        json.dump(data, f, indent=2, sort_keys=True)
        f.write("\n")


class ComputeModel:
    """Scheduler-facing compute pricing.

    * ``mode="flat"`` — delegates to ``AcceleratorModel.macro_cycles``
      verbatim: the pre-costmodel constant, bit-exact (the compat mode every
      committed BENCH number is pinned against).
    * ``mode="calibrated"`` — the analytical model above with per-kernel
      fitted overhead factors. Kernels without a fit fall back flat, so a
      partial calibration never crashes a run.
    """

    def __init__(self, mode: str = "calibrated",
                 fits: Mapping[str, KernelFit] | None = None,
                 path: str | None = None):
        assert mode in COMPUTE_MODES, mode
        self.mode = mode
        if fits is None:
            fits = load_fits(path) if mode == "calibrated" else {}
        self.fits = dict(fits)

    @classmethod
    def flat(cls) -> "ComputeModel":
        return cls(mode="flat", fits={})

    @classmethod
    def calibrated(cls, path: str | None = None) -> "ComputeModel":
        return cls(mode="calibrated", path=path)

    def fit_for(self, kernel: str) -> KernelFit | None:
        return self.fits.get(canonical_kernel(kernel))

    # -- prediction ----------------------------------------------------------

    def issue_cycles(self, kernel: str, dims, model: AcceleratorModel,
                     depth: int = 1) -> float:
        spec = KERNELS[canonical_kernel(kernel)]
        return depth * (model.launch_latency + spec.steps(dims, model.tile))

    def work_cycles(self, kernel: str, dims, model: AcceleratorModel,
                    depth: int = 1) -> float:
        spec = KERNELS[canonical_kernel(kernel)]
        return depth * spec.ops(dims) / model.p_peak

    def predict(self, kernel: str, dims, model: AcceleratorModel,
                depth: int = 1) -> float:
        """Predicted compute cycles of ``depth`` back-to-back launches of
        ``kernel`` at logical ``dims`` on ``model``'s datapath. Monotone
        nondecreasing in each of M, K, N and depth (ceil-div step counts
        and linear work terms)."""
        dims = tuple(int(x) for x in dims)
        fit = self.fit_for(kernel)
        if self.mode == "flat" or fit is None \
                or canonical_kernel(kernel) not in KERNELS:
            regs = dict(zip(model.dim_fields, dims))
            return depth * model.macro_cycles(regs)
        issue = self.issue_cycles(kernel, dims, model, depth)
        work = self.work_cycles(kernel, dims, model, depth)
        return issue + fit.overhead_factor * work

    def macro_cycles(self, model: AcceleratorModel, regs: Mapping[str, int],
                     kernel: str = "matmul") -> float:
        """Drop-in replacement for ``model.macro_cycles(regs)`` on the
        scheduler's launch path — flat mode IS that call, bit-exactly."""
        if self.mode == "flat":
            return model.macro_cycles(dict(regs))
        dims = tuple(int(regs.get(f, 0)) for f in model.dim_fields)
        return self.predict(kernel, dims, model)

    def wire_compute_ratio(self, kernel: str, dims, model: AcceleratorModel,
                           wire_cycles: float) -> float:
        """Predicted wire/compute ratio — the autotuner's decision axis
        (``engine.autotune``): > 1 means the wire cannot fully hide behind
        one launch's compute."""
        compute = self.predict(kernel, dims, model)
        return wire_cycles / compute if compute > 0.0 else math.inf


def resolve_compute_model(spec) -> "ComputeModel | None":
    """``None`` → flat legacy path (the scheduler calls the accelerator
    model directly — bit-exact); ``"flat"``/``"calibrated"`` → the named
    mode; an instance passes through."""
    if spec is None or isinstance(spec, ComputeModel):
        return spec
    assert spec in COMPUTE_MODES, spec
    return ComputeModel.flat() if spec == "flat" else ComputeModel.calibrated()
