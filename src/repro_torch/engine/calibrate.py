"""Calibration harness — fit overhead factors against the port's kernels.

The port of ``repro.engine.calibrate``. It times the port's hand-written
kernels (``matmul``, ``flash_attention`` and greedy ``sampling``, through
``kernels.ops``) over the same ladder of shapes, then least-squares-fits
each kernel's measured wall-clock against the analytical ``issue + work``
terms of the port's copy of ``engine.costmodel``: the model's *form* is
analytical, its *overhead factor* is measured.

Run it on the card and commit the JSON::

    PYTHONPATH=src python -m repro_torch.engine.calibrate

It writes ``src/repro_torch/engine/calibration.json`` (the port's own
file; the JAX package's interpret-mode fits stay in
``src/repro/engine/calibration.json``), with ``backend`` naming the card
and its power limit as ``nvidia-smi`` prints them. ``--device cpu`` times
the plain PyTorch versions instead, which measures the CPU, not a kernel:
it is for checking the harness, not for committing.

Each sample is the median wall-clock time of one call followed by
``torch.cuda.synchronize()``: the host's issue and the device's work
together, which is what the fit splits into its two terms. One untimed
call first absorbs the ``nvcc`` build and the first launch."""

from __future__ import annotations

import argparse
import statistics
import subprocess
import time

import torch

from ..core.accelerators import REGISTRY, AcceleratorModel
from ..kernels import ops
from .costmodel import (CALIBRATION_PATH, KERNELS, KernelFit, fit_overhead,
                        save_fits)

# shape ladders: (M, K, N) logical dims per costmodel.KERNELS semantics,
# the JAX harness's own (repro/engine/calibrate.py): matmul (M, K, N);
# flash_attention (seq, head_dim, seq); sampling (batch, -, vocab).
SHAPES: dict[str, list[tuple[int, int, int]]] = {
    "matmul": [
        (128, 128, 128),
        (256, 128, 128),
        (128, 256, 128),
        (128, 128, 256),
        (256, 256, 256),
        (384, 256, 384),
    ],
    "flash_attention": [
        (128, 64, 128),
        (256, 64, 256),
        (384, 64, 384),
        (512, 64, 512),
        (256, 128, 256),
    ],
    "sampling": [
        (4, 0, 1024),
        (4, 0, 4096),
        (8, 0, 4096),
        (4, 0, 8192),
        (8, 0, 8192),
    ],
}

SMOKE_SHAPES = {k: v[:3] for k, v in SHAPES.items()}


def kernel_thunk(kernel: str, dims, device: str = "cuda"):
    """Build float32 inputs for one logical shape on ``device`` and return a
    thunk that runs the kernel once. Inputs come from a generator seeded as
    the JAX harness seeds its key, ``m·7 + k·13 + n·29``."""
    m, k, n = dims
    gen = torch.Generator(device=device).manual_seed(m * 7 + k * 13 + n * 29)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    if kernel == "matmul":
        a, b = randn(m, k), randn(k, n)
        return lambda: ops.matmul_op(a, b)
    if kernel == "flash_attention":
        q, kk, v = randn(1, 1, m, k), randn(1, 1, m, k), randn(1, 1, m, k)
        return lambda: ops.attention_op(q, kk, v, causal=False)
    if kernel == "sampling":
        logits = randn(m, n)
        return lambda: ops.sample_op(logits)
    raise ValueError(f"unknown kernel {kernel!r}")


def _synchronize(device: str):
    if torch.device(device).type == "cuda":
        return lambda: torch.cuda.synchronize(device)
    return lambda: None


def time_kernel(kernel: str, dims, *, device: str = "cuda",
                repeats: int = 3) -> float:
    """Median wall-clock seconds of one kernel call at ``dims``, each timed
    call ending in a device synchronise so asynchronous launch cannot hide
    the work. One untimed call first absorbs the build."""
    thunk = kernel_thunk(kernel, dims, device)
    sync = _synchronize(device)
    thunk()  # warm-up: nvcc build at first use, first launch
    sync()
    samples = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        thunk()
        sync()
        samples.append(time.perf_counter() - t0)
    return statistics.median(samples)


def calibrate_kernel(kernel: str, shapes, model: AcceleratorModel,
                     *, device: str = "cuda",
                     repeats: int = 3) -> tuple[KernelFit, list]:
    """Fit one kernel's overhead factor over its shape ladder; returns the
    fit and the raw (dims, seconds) samples for the audit trail."""
    spec = KERNELS[kernel]
    issues, works, seconds, samples = [], [], [], []
    for dims in shapes:
        secs = time_kernel(kernel, dims, device=device, repeats=repeats)
        issues.append(model.launch_latency + spec.steps(dims, model.tile))
        works.append(spec.ops(dims) / model.p_peak)
        seconds.append(secs)
        samples.append({"dims": list(dims), "seconds": secs})
    fit = fit_overhead(issues, works, seconds)
    return KernelFit(kernel=kernel, overhead_factor=fit.overhead_factor,
                     seconds_per_cycle=fit.seconds_per_cycle, r2=fit.r2,
                     n_samples=fit.n_samples), samples


def run_calibration(*, device: str = "cuda", accel: str = "opengemm",
                    repeats: int = 3, smoke: bool = False,
                    verbose: bool = True):
    """Time every kernel's ladder and fit its overhead factor."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("calibration on cuda needs a CUDA device; pass "
                           "--device cpu to check the harness on the CPU")
    model = REGISTRY[accel]
    shapes = SMOKE_SHAPES if smoke else SHAPES
    fits, samples = {}, {}
    for kernel in sorted(KERNELS):
        fit, raw = calibrate_kernel(kernel, shapes[kernel], model,
                                    device=device, repeats=repeats)
        fits[kernel] = fit
        samples[kernel] = raw
        if verbose:
            print(f"{kernel:>16}: overhead_factor={fit.overhead_factor:.4g} "
                  f"sec/cycle={fit.seconds_per_cycle:.3g} "
                  f"r2={fit.r2:.4f} n={fit.n_samples}")
    return fits, samples


def backend_name(device: str) -> str:
    """What the fits were measured on: for a card, its name and power limit
    as ``nvidia-smi --query-gpu=name,power.limit`` prints them."""
    if torch.device(device).type != "cuda":
        return "cpu (plain PyTorch versions)"
    index = torch.device(device).index
    index = torch.cuda.current_device() if index is None else index
    return subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the kernels run: cuda (the card) or cpu "
                         "(the plain versions, to check the harness)")
    ap.add_argument("--accel", default="opengemm", choices=sorted(REGISTRY))
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--smoke", action="store_true",
                    help="short shape ladders (harness sanity, not for committing)")
    ap.add_argument("--out", default=CALIBRATION_PATH)
    args = ap.parse_args(argv)
    fits, samples = run_calibration(device=args.device, accel=args.accel,
                                    repeats=args.repeats, smoke=args.smoke)
    save_fits(fits, args.out, backend=backend_name(args.device), samples=samples)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
