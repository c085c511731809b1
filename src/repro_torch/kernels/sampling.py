"""Greedy sampling: the decode launch's fused epilogue.

:func:`greedy_sample` is the port of the Pallas kernel
``repro/kernels/sampling.py::greedy_sample``: argmax over the last axis of
``(B, V)`` logits → ``(B,)`` int32 ids, the lowest index winning ties and
the first NaN winning over every number (``jnp.argmax``'s contract). On a
CUDA tensor it launches the hand-written Hopper kernel
``csrc/greedy_sample.cu``; on a CPU tensor it runs the plain version
``ref.greedy_sample_ref``. There is no other route: a CUDA tensor either
runs the kernel or raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import greedy_sample_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def _launcher():
    fn = _build.load("greedy_sample").greedy_sample_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis of contiguous ``(B, V)`` float32, bfloat16
    or float16 logits → ``(B,)`` int32 ids. ``greedy_sample.launches``
    counts the kernel's launches."""
    if logits.dtype not in _DTYPE_CODES:
        raise TypeError(f"greedy_sample takes float32, bfloat16 or float16 "
                        f"logits, not {logits.dtype}")
    if logits.dim() != 2:
        raise ValueError(f"greedy_sample takes (B, V) logits, not shape "
                         f"{tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError("greedy_sample takes contiguous logits")
    b, v = logits.shape
    if not 0 < v < 2**31:
        raise ValueError(f"greedy_sample needs 0 < V < 2**31, got V={v}")
    if logits.device.type == "cpu":
        return greedy_sample_ref(logits)
    if logits.device.type != "cuda":
        raise ValueError(f"greedy_sample runs on cuda or cpu, not {logits.device}")
    if logits.get_device() != torch.cuda.current_device():
        # the runtime launches on the current device's streams only
        with torch.cuda.device(logits.device):
            return greedy_sample(logits)
    out = torch.empty((b,), dtype=torch.int32, device=logits.device)
    if b == 0:
        return out
    err = _launcher()(logits.data_ptr(), out.data_ptr(), b, v,
                      _DTYPE_CODES[logits.dtype],
                      torch.cuda.current_stream(logits.device).cuda_stream)
    if err:
        raise RuntimeError(f"greedy_sample kernel launch failed: CUDA error {err}")
    greedy_sample.launches += 1
    return out


greedy_sample.launches = 0
