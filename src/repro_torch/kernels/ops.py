"""Public kernel entry points, each chosen by its tensor's device.

Unlike ``repro.kernels.ops`` there is no ``backend=`` switch and there are
no block-size keywords: a CUDA tensor always runs the hand-written kernel,
a CPU tensor its plain version, so nothing can send a CUDA tensor to the
plain version by choice. ``sample_op`` and ``top_k_op`` also take a
``meta`` tensor (the dry run's trace): they return empty outputs of the
kernel's shapes and dtypes and compute nothing. Any other device raises. Each kernel's wrapper counts its launches
(``matmul.launches``, ...).
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate

from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .matmul import configured_matmul, matmul
from .sampling import greedy_sample, top_k


def matmul_op(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(M, K)·(K, N)`` summed in float32, in ``a.dtype``."""
    return matmul(a, b)


def configured_matmul_op(a: torch.Tensor, b: torch.Tensor, zero_points) -> torch.Tensor:
    """``(A - zp_a)·(B - zp_b)`` in float32; ``zero_points`` is a pair of
    ints or a ``(2,)`` int32 CPU tensor (the configuration registers)."""
    return configured_matmul(a, b, zero_points)


def attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool = True) -> torch.Tensor:
    """q, k, v: (B, H, S, D). GQA callers repeat K/V heads before the call."""
    return flash_attention(q, k, v, causal=causal)


def decode_attention_op(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                        k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One decode step's attention: q (B, 1, Hq, D) over the K/V caches
    (B, T, Hkv, D), read where they lie, up to each row's position ``pos``
    (B,), the row's new k and v (B, 1, Hkv, D) standing in for the cache's
    row at its position → (B, 1, Hq, D)."""
    return decode_attention(q, k_cache, v_cache, k, v, pos)


def _by_rows(kernel, logits: torch.Tensor, *args):
    """``kernel`` on a DTensor's rows: the rows keep their sharding, the last
    dim is gathered whole (a partial sum reduced), and each rank runs the
    kernel on its local rows; the outputs are DTensors of the rows'
    placements. A plain tensor goes to the kernel as it is."""
    if not isinstance(logits, DTensor):
        return kernel(logits, *args)
    mesh = logits.device_mesh
    rows = [p if p.is_shard() and p.dim == 0 else Replicate() for p in logits.placements]
    local = logits.redistribute(mesh, rows).to_local().contiguous()
    out = kernel(local, *args)
    wrap = lambda t: DTensor.from_local(t, mesh, rows, run_check=False)  # noqa: E731
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def sample_op(logits: torch.Tensor) -> torch.Tensor:
    """Greedy sampling over (B, V) logits → (B,) int32 ids, lowest index
    winning ties — the decode launch's fused epilogue. A DTensor samples
    its rows where they lie (:func:`_by_rows`)."""
    return _by_rows(greedy_sample, logits)


def top_k_op(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k (float32 values, int32 ids) over (B, V) logits, lax.top_k order.
    A DTensor takes its top-k a row where the row lies (:func:`_by_rows`)."""
    return _by_rows(top_k, logits, k)
