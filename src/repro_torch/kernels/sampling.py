"""Greedy sampling and top-k: the decode launch's fused epilogue.

:func:`greedy_sample` is the port of the Pallas kernel
``repro/kernels/sampling.py::greedy_sample``: argmax over the last axis of
``(B, V)`` logits → ``(B,)`` int32 ids, the lowest index winning ties and
the first NaN winning over every number (``jnp.argmax``'s contract). On a
CUDA tensor it launches the hand-written Hopper kernel
``csrc/greedy_sample.cu``; on a CPU tensor it runs the plain version
``ref.greedy_sample_ref``. There is no other route: a CUDA tensor either
runs the kernel or raises.

:func:`top_k` is the port of ``repro/kernels/sampling.py::top_k``: the k
best of each row in ``lax.top_k`` order (descending, NaN first, ties by the
lowest index), in one launch of ``csrc/top_k.cu`` where the Pallas version
takes k greedy passes. Its plain version is ``ref.top_k_ref``, a stable
descending sort. ``k`` is at most :data:`K_MAX`, the kernel's compile-time
list length.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import greedy_sample_ref, top_k_ref

K_MAX = 64  # top_k.cu's kKMax: each thread's list of the best k lives in registers
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def _launcher():
    fn = _build.load("greedy_sample").greedy_sample_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_logits(name: str, logits: torch.Tensor) -> None:
    if logits.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32, bfloat16 or float16 "
                        f"logits, not {logits.dtype}")
    if logits.dim() != 2:
        raise ValueError(f"{name} takes (B, V) logits, not shape "
                         f"{tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError(f"{name} takes contiguous logits")
    if not 0 < logits.shape[1] < 2**31:
        raise ValueError(f"{name} needs 0 < V < 2**31, got V={logits.shape[1]}")


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis of contiguous ``(B, V)`` float32, bfloat16
    or float16 logits → ``(B,)`` int32 ids. ``greedy_sample.launches``
    counts the kernel's launches."""
    _check_logits("greedy_sample", logits)
    b, v = logits.shape
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
    _build.check(err, "greedy_sample")
    greedy_sample.launches += 1
    return out


greedy_sample.launches = 0


@functools.cache
def _top_k_launcher():
    lib = _build.load("top_k")
    if lib.top_k_max_k() != K_MAX:
        raise RuntimeError(f"top_k.cu's kKMax is {lib.top_k_max_k()}, not K_MAX={K_MAX}")
    fn = lib.top_k_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def top_k(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` best of each row of contiguous ``(B, V)`` float32, bfloat16
    or float16 logits → ``((B, k)`` float32 values, ``(B, k)`` int32 ids),
    in ``lax.top_k`` order, for ``1 <= k <= min(V, K_MAX)``.
    ``top_k.launches`` counts the kernel's launches."""
    _check_logits("top_k", logits)
    b, v = logits.shape
    if isinstance(k, bool) or not isinstance(k, int) or not 1 <= k <= min(v, K_MAX):
        raise ValueError(f"top_k takes an int 1 <= k <= min(V={v}, K_MAX={K_MAX}), not {k!r}")
    if logits.device.type == "cpu":
        return top_k_ref(logits, k)
    if logits.device.type != "cuda":
        raise ValueError(f"top_k runs on cuda or cpu, not {logits.device}")
    if logits.get_device() != torch.cuda.current_device():
        with torch.cuda.device(logits.device):
            return top_k(logits, k)
    vals = torch.empty((b, k), dtype=torch.float32, device=logits.device)
    ids = torch.empty((b, k), dtype=torch.int32, device=logits.device)
    if b == 0:
        return vals, ids
    _build.check(_top_k_launcher()(logits.data_ptr(), vals.data_ptr(), ids.data_ptr(), b, v, k,
                                   _DTYPE_CODES[logits.dtype],
                                   torch.cuda.current_stream(logits.device).cuda_stream),
                 "top_k")
    top_k.launches += 1
    return vals, ids


top_k.launches = 0
