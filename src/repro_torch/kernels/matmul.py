"""Blocked matrix products: :func:`matmul` and :func:`configured_matmul`.

Ports of the Pallas kernels ``repro/kernels/matmul.py::matmul`` and
``::configured_matmul``. Both launch one hand-written Hopper kernel,
``csrc/matmul.cu``, through its two C entry points. On a CPU tensor each
wrapper runs its plain version (``ref.matmul_ref``,
``ref.configured_matmul_ref``); on a CUDA tensor it launches the kernel or
raises. Unlike the Pallas kernels, neither needs its dimensions to be
multiples of a block: the kernel masks the ragged edges.

``configured_matmul``'s zero points are the paper's configuration
registers. The Pallas kernel brings them in by scalar prefetch; here they
are the kernel's by-value launch parameters, so the wrapper needs them on
the host: a pair of ints or a ``(2,)`` int32 CPU tensor. A CUDA tensor is
refused, because reading it on the host would synchronise with the device.
"""

from __future__ import annotations

import ctypes
import functools
import operator

import torch

from . import _build
from .ref import configured_matmul_ref, matmul_ref

_MATMUL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CONFIGURED_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_BLOCK_M = 128  # rows of C per block; the grid's y extent is at most 65535
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("matmul")
    lib.matmul_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    lib.matmul_launch.restype = _I
    lib.configured_matmul_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    lib.configured_matmul_launch.restype = _I
    return lib


def _check_operands(name: str, a: torch.Tensor, b: torch.Tensor, dtypes) -> None:
    if a.dtype not in dtypes or b.dtype != a.dtype:
        raise TypeError(f"{name} takes A and B of one type among "
                        f"{sorted(str(d) for d in dtypes)}, not {a.dtype} and {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"{name} takes A (M, K) and B (K, N), not shapes "
                         f"{tuple(a.shape)} and {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name} takes contiguous A and B")
    if a.device != b.device:
        raise ValueError(f"{name} takes A and B on one device, not {a.device} and {b.device}")
    (m, k), n = a.shape, b.shape[1]
    if max(m, k, n) >= 2**31 or -(-m // _BLOCK_M) > 65535:
        raise ValueError(f"{name}: M={m}, K={k}, N={n} is past the kernel's grid")
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {a.device}")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(M, K)·(K, N)`` summed in float32, in ``a.dtype`` (float32 or
    bfloat16). ``matmul.launches`` counts the kernel's launches."""
    _check_operands("matmul", a, b, _MATMUL_DTYPES)
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    if a.get_device() != torch.cuda.current_device():
        with torch.cuda.device(a.device):  # the runtime launches on the current device
            return matmul(a, b)
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    _build.check(_lib().matmul_launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
                                      _MATMUL_DTYPES[a.dtype],
                                      torch.cuda.current_stream(a.device).cuda_stream), "matmul")
    matmul.launches += 1
    return out


matmul.launches = 0


def _zero_points(zero_points) -> tuple[int, int]:
    if isinstance(zero_points, torch.Tensor):
        if zero_points.device.type != "cpu":
            raise ValueError(
                f"configured_matmul takes its zero points on the host (a pair of ints or a "
                f"(2,) int32 CPU tensor), not on {zero_points.device}: reading them there "
                f"would synchronise with the device")
        if zero_points.shape != (2,) or zero_points.dtype != torch.int32:
            raise ValueError(f"configured_matmul takes (2,) int32 zero points, not "
                             f"{tuple(zero_points.shape)} {zero_points.dtype}")
        zero_points = zero_points.tolist()
    try:
        zp_a, zp_b = (operator.index(z) for z in zero_points)
    except (TypeError, ValueError) as e:
        raise TypeError(f"configured_matmul takes two integer zero points, not "
                        f"{zero_points!r}") from e
    if not all(-2**24 <= z <= 2**24 for z in (zp_a, zp_b)):
        raise ValueError(f"configured_matmul zero points must lie within ±2**24, where "
                         f"float32 holds them exactly, not {zp_a}, {zp_b}")
    return zp_a, zp_b


def configured_matmul(a: torch.Tensor, b: torch.Tensor, zero_points) -> torch.Tensor:
    """``(A - zp_a)·(B - zp_b)`` in float32, for float32, bfloat16 or int8
    A and B of one type, with ``zero_points = (zp_a, zp_b)`` on the host.
    ``configured_matmul.launches`` counts the kernel's launches."""
    _check_operands("configured_matmul", a, b, _CONFIGURED_DTYPES)
    zp_a, zp_b = _zero_points(zero_points)
    if a.device.type == "cpu":
        return configured_matmul_ref(a, b, zp_a, zp_b)
    if a.get_device() != torch.cuda.current_device():
        with torch.cuda.device(a.device):
            return configured_matmul(a, b, (zp_a, zp_b))
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), dtype=torch.float32, device=a.device)
    if m == 0 or n == 0:
        return out
    _build.check(_lib().configured_matmul_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, zp_a, zp_b,
        _CONFIGURED_DTYPES[a.dtype], torch.cuda.current_stream(a.device).cuda_stream),
        "configured_matmul")
    configured_matmul.launches += 1
    return out


configured_matmul.launches = 0
