"""Blocked matrix products: :func:`matmul` and :func:`configured_matmul`.

Ports of the Pallas kernels ``repro/kernels/matmul.py::matmul`` and
``::configured_matmul``. On a CPU tensor each wrapper runs its plain
version (``ref.matmul_ref``, ``ref.configured_matmul_ref``); on a CUDA
tensor it launches a hand-written Hopper kernel or raises. Unlike the
Pallas kernels, neither needs its dimensions to be multiples of a block:
the kernels mask the ragged edges.

``matmul`` takes one of three routes, chosen by :func:`plan_matmul` from
the type, the shape and the operands' alignment, and counted in
``matmul.launches_by_route``:

* ``"wgmma"`` (``csrc/matmul_wgmma.cu``): bf16 on the tensor cores, fed by
  TMA through an mbarrier ring;
* ``"pipelined"`` (``csrc/matmul.cu::sgemm_pipelined``): f32 FMA through a
  cp.async ring, with the tile chosen to fill the card;
* ``"simt"`` (``csrc/matmul.cu::gemm_kernel``): any shape, f32 or bf16.

``configured_matmul`` takes one of two routes, chosen by
:func:`plan_configured_matmul` and counted in
``configured_matmul.launches_by_route``:

* ``"wgmma"`` (``csrc/configured_matmul_wgmma.cu``): int8 on the tensor
  cores with s32 sums, the zero points applied in the epilogue through
  row and column sums, the exact integer result rounded to float32 once;
* ``"simt"`` (``csrc/matmul.cu::gemm_kernel``): any shape, f32, bf16 or
  int8, summed in float32.

Its zero points are the paper's configuration registers. The Pallas kernel
brings them in by scalar prefetch; here they are the kernels' by-value
launch parameters, so the wrapper needs them on the host: a pair of ints
or a ``(2,)`` int32 CPU tensor. A CUDA tensor is refused, because reading
it on the host would synchronise with the device.
"""

from __future__ import annotations

import ctypes
import functools
import operator
from dataclasses import dataclass

import torch

from . import _build
from .ref import configured_matmul_ref, matmul_ref

_MATMUL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_CONFIGURED_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_BLOCK_M = 128  # rows of C per block of the simt kernel; its grid's y extent is at most 65535
_P, _I = ctypes.c_void_p, ctypes.c_int

ROUTES = ("wgmma", "pipelined", "simt")
CONFIGURED_ROUTES = ("wgmma", "simt")
PIPELINED_TILES = (128, 64, 32)  # square f32 tiles, largest first
WGMMA_BLOCK_M = 128
WGMMA_BLOCK_NS = (128, 192)  # multiples of 64: the swizzle atom of an N-contiguous B


@dataclass(frozen=True)
class MatmulPlan:
    route: str
    block_m: int  # rows of C per block
    block_n: int  # columns of C per block


def _blocks(m: int, n: int, bm: int, bn: int) -> int:
    return -(-m // bm) * -(-n // bn)


def _wgmma_width(m: int, n: int, sms: int) -> int:
    """The ``WGMMA_BLOCK_NS`` width with the least ``ceil(blocks / sms) ·
    width``: the time of the last wave of tiles, so a second, nearly empty
    wave is avoided."""
    return min(WGMMA_BLOCK_NS,
               key=lambda bn: (-(-_blocks(m, n, WGMMA_BLOCK_M, bn) // sms) * bn, bn))


def plan_matmul(dtype: torch.dtype, m: int, k: int, n: int, ptrs,
                sms: int = _build.H100_SMS) -> MatmulPlan:
    """The kernel and tile of one ``matmul`` of ``(m, k)·(k, n)`` with A and B
    at addresses ``ptrs``, on a card of ``sms`` SMs. A pure function, so the
    rule is tested on the CPU.

    * bf16 takes ``"wgmma"`` where TMA can describe both operands: K and N
      multiples of 8 (16-byte row strides), K > 0 and both addresses 16-byte
      aligned. Its tile is 128 rows by :func:`_wgmma_width`.
    * f32 takes ``"pipelined"`` where its 16-byte copies can: K and N
      multiples of 4, K > 0, both addresses 16-byte aligned. Its tile is the
      largest of ``PIPELINED_TILES`` whose grid covers the SMs, else the
      smallest.
    * Everything else takes ``"simt"``, 128 x 128 tiles.

    This is an explicit route, not a fallback: whichever kernel is chosen,
    a failed build or launch raises."""
    aligned = k > 0 and all(p % 16 == 0 for p in ptrs)
    if dtype == torch.bfloat16 and aligned and k % 8 == 0 and n % 8 == 0:
        return MatmulPlan("wgmma", WGMMA_BLOCK_M, _wgmma_width(m, n, sms))
    if dtype == torch.float32 and aligned and k % 4 == 0 and n % 4 == 0:
        tile = next((t for t in PIPELINED_TILES if _blocks(m, n, t, t) >= sms),
                    PIPELINED_TILES[-1])
        return MatmulPlan("pipelined", tile, tile)
    return MatmulPlan("simt", _BLOCK_M, _BLOCK_M)


INT8_WGMMA_MAX_K = 65536  # |sum a·b| <= K·128² stays inside int32
INT8_WGMMA_MAX_ZP = 128  # |zp|: the epilogue's int64 terms, and the f32 result, stay exact


def plan_configured_matmul(dtype: torch.dtype, m: int, k: int, n: int, ptrs, zero_points,
                           sms: int = _build.H100_SMS) -> MatmulPlan:
    """The kernel and tile of one ``configured_matmul`` of ``(m, k)·(k, n)``
    with A and B at addresses ``ptrs`` and ``zero_points = (zp_a, zp_b)``,
    on a card of ``sms`` SMs. A pure function, so the rule is tested on the
    CPU.

    * int8 takes ``"wgmma"`` where TMA and the 16-byte tiles can take the
      operands and the sums stay exact: K and N multiples of 16 (16-byte
      row strides), K > 0, both addresses 16-byte aligned,
      ``K <= INT8_WGMMA_MAX_K`` and ``|zp| <= INT8_WGMMA_MAX_ZP``. Its tile
      is 128 rows by :func:`_wgmma_width`, as for bf16 ``matmul``.
    * Everything else, every f32 and bf16 call included, takes ``"simt"``.

    An explicit route, not a fallback: a failed build or launch raises."""
    aligned = k > 0 and all(p % 16 == 0 for p in ptrs)
    if (dtype == torch.int8 and aligned and k % 16 == 0 and n % 16 == 0
            and k <= INT8_WGMMA_MAX_K and all(abs(z) <= INT8_WGMMA_MAX_ZP for z in zero_points)):
        return MatmulPlan("wgmma", WGMMA_BLOCK_M, _wgmma_width(m, n, sms))
    return MatmulPlan("simt", _BLOCK_M, _BLOCK_M)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("matmul")
    lib.matmul_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    lib.matmul_launch.restype = _I
    lib.matmul_pipelined_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    lib.matmul_pipelined_launch.restype = _I
    lib.configured_matmul_launch.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    lib.configured_matmul_launch.restype = _I
    return lib


@functools.cache
def _configured_wgmma_launcher():
    fn = _build.load("configured_matmul_wgmma").configured_matmul_wgmma_launch
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


@functools.cache
def _wgmma_launcher():
    fn = _build.load("matmul_wgmma").matmul_wgmma_launch
    fn.argtypes = [_P, _P, _P, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


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
    bfloat16), through the route :func:`plan_matmul` chooses.
    ``matmul.launches`` counts the kernels' launches and
    ``matmul.launches_by_route`` the launches of each route."""
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
    plan = plan_matmul(a.dtype, m, k, n, (a.data_ptr(), b.data_ptr()),
                       _build.sm_count(a.get_device()))
    ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if plan.route == "wgmma":
        err = _wgmma_launcher()(*ptrs, plan.block_n, stream)
    elif plan.route == "pipelined":
        err = _lib().matmul_pipelined_launch(*ptrs, plan.block_m, stream)
    else:
        err = _lib().matmul_launch(*ptrs, _MATMUL_DTYPES[a.dtype], stream)
    _build.check(err, f"matmul ({plan.route})")
    matmul.launches += 1
    matmul.launches_by_route[plan.route] += 1
    return out


matmul.launches = 0
matmul.launches_by_route = dict.fromkeys(ROUTES, 0)


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
    A and B of one type, with ``zero_points = (zp_a, zp_b)`` on the host,
    through the route :func:`plan_configured_matmul` chooses.
    ``configured_matmul.launches`` counts the kernels' launches and
    ``configured_matmul.launches_by_route`` the launches of each route."""
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
    plan = plan_configured_matmul(a.dtype, m, k, n, (a.data_ptr(), b.data_ptr()), (zp_a, zp_b),
                                  _build.sm_count(a.get_device()))
    args = (a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k, zp_a, zp_b)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    if plan.route == "wgmma":
        err = _configured_wgmma_launcher()(*args, plan.block_n, stream)
    else:
        err = _lib().configured_matmul_launch(*args, _CONFIGURED_DTYPES[a.dtype], stream)
    _build.check(err, f"configured_matmul ({plan.route})")
    configured_matmul.launches += 1
    configured_matmul.launches_by_route[plan.route] += 1
    return out


configured_matmul.launches = 0
configured_matmul.launches_by_route = dict.fromkeys(CONFIGURED_ROUTES, 0)
