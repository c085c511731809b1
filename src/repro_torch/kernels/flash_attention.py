"""Flash attention: the port of the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention``.

On a CUDA tensor :func:`flash_attention` launches the hand-written Hopper
kernel ``csrc/flash_attention.cu``; on a CPU tensor it runs the plain
version ``ref.flash_attention_ref``. There is no other route.

The causal mask is bottom-right aligned (query row i sees keys
``j <= i + Sk - Sq``), as the JAX package's plain reference masks; its
Pallas kernel masks top-left, and the two differ when ``Sq != Sk``
(ROADMAP Queue 3). Causal attention with ``Sq > Sk`` is refused: its first
rows see no key, the reference gives NaN there and the Pallas kernel
another number.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build
from .ref import flash_attention_ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
D_MAX = 128  # the kernel keeps D / 32 accumulator columns per lane, up to 4
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _launcher():
    fn = _build.load("flash_attention").flash_attention_launch
    fn.argtypes = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
    fn.restype = _I
    return fn


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> None:
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes q, k, v of one type, float32 or bfloat16, "
                        f"not {q.dtype}, {k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention takes q (B, H, Sq, D) and k, v (B, H, Sk, D), "
                         f"not {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, h, sq, d = q.shape
    sk = k.shape[2]
    if k.shape[:2] != q.shape[:2] or k.shape[3] != d:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         f"in B, H or D (GQA callers repeat the K/V heads first)")
    if not 0 < d <= D_MAX:
        raise ValueError(f"flash_attention takes 0 < D <= {D_MAX}, not D={d}")
    if sk == 0:
        raise ValueError("flash_attention needs at least one key")
    if causal and sq > sk:
        raise ValueError(f"causal flash_attention needs Sq <= Sk, not Sq={sq} > Sk={sk}: "
                         f"the first rows would see no key")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")
    if not q.device == k.device == v.device:
        raise ValueError(f"flash_attention takes q, k, v on one device, not "
                         f"{q.device}, {k.device}, {v.device}")
    if b * h > 65535 or max(sq, sk) * d >= 2**31:
        raise ValueError(f"flash_attention: B·H={b * h}, Sq={sq}, Sk={sk}, D={d} is past "
                         f"the kernel's grid")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True) -> torch.Tensor:
    """Softmax attention of q (B, H, Sq, D) over k, v (B, H, Sk, D), scale
    ``1/sqrt(D)``, in ``q.dtype`` (float32 or bfloat16), with float32
    running max, normaliser and accumulator. ``flash_attention.launches``
    counts the kernel's launches."""
    _check(q, k, v, causal)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.get_device() != torch.cuda.current_device():
        with torch.cuda.device(q.device):  # the runtime launches on the current device
            return flash_attention(q, k, v, causal=causal)
    b, h, sq, d = q.shape
    out = torch.empty_like(q)
    if b * h == 0 or sq == 0:
        return out
    _build.check(_launcher()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
                             sq, k.shape[2], d, int(causal), _DTYPE_CODES[q.dtype],
                             torch.cuda.current_stream(q.device).cuda_stream),
                 "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
