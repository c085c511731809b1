"""Plain float32 references, one module a family, written from each
family's layer equations. They import nothing of the program and take
nothing it made: the benchmark draws the weights and hands the same tensors
to both sides, and a reference reads the program's outputs only to judge
them."""

from __future__ import annotations

import contextlib

import torch

FP8_MAX = 448.0  # largest finite float8_e4m3fn


def f32_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in float32 over any leading axes of ``x``."""
    return x @ w.float()


def _fp8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8_e4m3fn with one scale a slice along ``dim``
    (its absolute maximum at the format's largest value), back in f32."""
    scale = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The control's product: both operands rounded to fp8 (e4m3, a scale
    a row of ``x`` and a column of ``w``), multiplied in f32. fp8 is the
    precision below the bf16 that the configurations serve in."""
    return _fp8(x.float(), -1) @ _fp8(w.float(), 0)


@contextlib.contextmanager
def full_f32():
    """Products and einsums in full f32: TF32 off for their span."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


def widest_gap(ref: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap by which the logit of ``tokens`` (..., ) lies below
    the best logit of ``ref`` (..., V) at the same position."""
    best = ref.max(dim=-1).values
    got = ref.gather(-1, tokens[..., None].long())[..., 0]
    return float((best - got).max())
