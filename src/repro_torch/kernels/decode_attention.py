"""Decode attention over a K/V cache: the serving step's attention.

:func:`decode_attention` takes one new query row per batch row, q (B, 1,
Hq, D), the layer's K and V caches (B, T, Hkv, D), read in place with their
strides (views of the stacked cache), the new k and v (B, 1, Hkv, D), and
the per-row positions (B,) on the device. Row b attends to the cache rows
up to its position, its own new K/V standing in for the cache's row there;
a row whose position lies past the cache attends to all of it as it is.
Returns (B, 1, Hq, D), the heads in ``gqa_combine``'s order.

On a CUDA tensor it launches the hand-written Hopper kernel
``csrc/decode_attention.cu``, which reads only the rows each batch row
attends to, split over slices of the cache as
:func:`plan_decode_attention` says; the positions are read on the card, so
a CUDA graph may replay the step while the card advances them. On a CPU
tensor it runs the plain version ``ref.decode_attention_ref``, the einsums
``models.layers`` ran before, bit for bit. There is no other route: a CUDA
tensor the kernel does not take raises.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import _build
from .ref import decode_attention_ref

DA_HEAD_DIMS = (16, 64, 96, 112, 128)  # decode_attention.cu's template instances
DA_MAX_G = 8  # kMaxG: query heads a K/V head
DA_TILE = 32  # kTile: cache rows a stage of the kernel's ring
DA_BLOCKS_PER_SM = 4  # blocks an SM holds at D 128 (shared memory)
DA_MIN_SLICE = 128  # cache rows: a slice streams four tiles at least


@functools.cache
def _launcher():
    fn = _build.load("decode_attention").decode_attention_launch
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@dataclass(frozen=True)
class DecodePlan:
    splits: int  # slices of the cache, a block each per (batch row, K/V head)
    chunk: int  # cache rows a slice, a multiple of DA_TILE; the last takes the rest

    def bounds(self, t: int) -> list[tuple[int, int]]:
        """Each slice's ``[start, stop)`` of a cache of ``t`` rows."""
        return [(s * self.chunk, min(t, (s + 1) * self.chunk)) for s in range(self.splits)]


def plan_decode_attention(b: int, hkv: int, t: int, sms: int = _build.H100_SMS) -> DecodePlan:
    """How ``decode_attention`` slices a cache of ``t`` rows for ``b`` batch
    rows of ``hkv`` K/V heads on a card of ``sms`` SMs. A pure function of
    those, never of the positions, so a captured step replays it as the
    card advances them; tested on the CPU. The slices grow in number until
    the b·hkv·splits blocks fill one wave (``DA_BLOCKS_PER_SM`` a SM), each
    slice at least ``DA_MIN_SLICE`` rows; the chunk is a multiple of
    ``DA_TILE`` and every slice is non-empty."""
    want = -(-DA_BLOCKS_PER_SM * sms // max(b * hkv, 1))
    splits = max(1, min(want, -(-t // DA_MIN_SLICE)))
    chunk = -(-t // splits)
    chunk = -(-chunk // DA_TILE) * DA_TILE
    return DecodePlan(-(-t // chunk), chunk)


def _check(q, k_cache, v_cache, k, v, pos) -> None:
    tensors = (q, k_cache, v_cache, k, v, pos)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"decode_attention takes its tensors on one device, not "
                         f"{[str(t.device) for t in tensors]}")
    if q.dim() != 4 or k_cache.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention takes q (B, 1, Hq, D) and caches (B, T, Hkv, D), "
                         f"not {tuple(q.shape)} and {tuple(k_cache.shape)}")
    b, _, hq, d = q.shape
    _, t, hkv, _ = k_cache.shape
    if (v_cache.shape != k_cache.shape or k_cache.shape[0] != b or k_cache.shape[3] != d
            or k.shape != (b, 1, hkv, d) or v.shape != k.shape or pos.shape != (b,)
            or t < 1 or hkv < 1 or hq % hkv):
        raise ValueError(f"decode_attention shapes do not fit: q {tuple(q.shape)}, caches "
                         f"{tuple(k_cache.shape)} and {tuple(v_cache.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, pos {tuple(pos.shape)}")
    if pos.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"decode_attention takes int32 or int64 positions, not {pos.dtype}")


def _check_kernel(q, k_cache, v_cache, k, v) -> None:
    """What the CUDA kernel takes beyond the shapes: bf16, D one of
    DA_HEAD_DIMS, at most DA_MAX_G query heads a K/V head, every row of D
    elements contiguous and 16-byte aligned."""
    d, g = q.shape[3], q.shape[2] // k_cache.shape[2]
    if any(t.dtype != torch.bfloat16 for t in (q, k_cache, v_cache, k, v)):
        raise TypeError("decode_attention's kernel takes bfloat16 q, caches, k and v")
    if d not in DA_HEAD_DIMS or not 1 <= g <= DA_MAX_G:
        raise ValueError(f"decode_attention's kernel takes D in {DA_HEAD_DIMS} and up to "
                         f"{DA_MAX_G} query heads a K/V head, not D={d}, G={g}")
    for name, t, dims in (("q", q, (0, 2)), ("k_cache", k_cache, (0, 1, 2)),
                          ("v_cache", v_cache, (0, 1, 2)), ("k", k, (0, 2)), ("v", v, (0, 2))):
        if t.stride(3) != 1 or any(t.stride(i) % 8 for i in dims) or t.data_ptr() % 16:
            raise ValueError(f"decode_attention's kernel reads each row of {name} as 16-byte "
                             f"chunks: its last dim contiguous, its strides multiples of 8 "
                             f"elements and its start 16-byte aligned, not strides "
                             f"{t.stride()}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Attention of q (B, 1, Hq, D) over the caches (B, T, Hkv, D) up to each
    row's position ``pos`` (B,), with the row's new k and v (B, 1, Hkv, D)
    at that position → (B, 1, Hq, D) in q's type; the cache is read, never
    written. On a card the kernel slices the cache as
    :func:`plan_decode_attention` says.
    ``decode_attention.launches`` counts the calls that launched it (each
    the slices' kernel and, with more than one slice, their merge)."""
    _check(q, k_cache, v_cache, k, v, pos)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, k, v, pos)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention runs on cuda or cpu, not {q.device}")
    _check_kernel(q, k_cache, v_cache, k, v)
    if q.get_device() != torch.cuda.current_device():
        with torch.cuda.device(q.device):
            return decode_attention(q, k_cache, v_cache, k, v, pos)
    b, _, hq, d = q.shape
    t, hkv = k_cache.shape[1], k_cache.shape[2]
    plan = plan_decode_attention(b, hkv, t, _build.sm_count(q.get_device()))
    out = torch.empty((b, 1, hq, d), dtype=q.dtype, device=q.device)
    if b == 0:
        return out
    part_acc = part_ml = None
    if plan.splits > 1:  # the slices' f32 partials: the sums, and each head's max and total
        part_acc = torch.empty((b, hkv, plan.splits, hq // hkv, d), dtype=torch.float32,
                               device=q.device)
        part_ml = torch.empty((b, hkv, plan.splits, hq // hkv, 2), dtype=torch.float32,
                              device=q.device)
    strides = (ctypes.c_longlong * 13)(
        q.stride(0), q.stride(2), *k_cache.stride()[:3], *v_cache.stride()[:3],
        k.stride(0), k.stride(2), v.stride(0), v.stride(2), pos.stride(0))
    err = _launcher()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), k.data_ptr(),
                      v.data_ptr(), pos.data_ptr(), out.data_ptr(),
                      0 if part_acc is None else part_acc.data_ptr(),
                      0 if part_ml is None else part_ml.data_ptr(),
                      ctypes.addressof(strides),
                      b, t, hkv, hq // hkv, d, int(pos.dtype == torch.int64), plan.splits,
                      plan.chunk, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, f"decode_attention ({plan.splits} slices)")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
