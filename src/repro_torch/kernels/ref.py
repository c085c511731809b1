"""Plain PyTorch versions of the port's kernels.

Each hand-written kernel has its plain version here: the wrappers run it on
CPU tensors, the CPU tests hold it against the JAX package, and
``chip_smoke.py`` holds each kernel against it on the card.
"""

from __future__ import annotations

import math

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(M, K)·(K, N)`` accumulated in float32, cast to ``a.dtype``."""
    return (a.float() @ b.float()).to(a.dtype)


def configured_matmul_ref(a: torch.Tensor, b: torch.Tensor, zp_a: int,
                          zp_b: int) -> torch.Tensor:
    """OpenGeMM-style GEMM with zero-point configuration registers:
    ``C = (A - zp_a)·(B - zp_b)`` in float32."""
    return (a.float() - float(zp_a)) @ (b.float() - float(zp_b))


def greedy_sample_ref(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis of (B, V) logits → (B,) int32, lowest index
    winning ties and the first NaN winning over every number (the
    ``jnp.argmax`` contract, which ``torch.argmax`` shares)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)


def top_k_ref(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k of (B, V) logits in float32 → ((B, k) values, (B, k) int32 ids)
    in ``lax.top_k`` order: descending, NaN above every number, ties by the
    lowest index. A stable descending sort gives that order; ``torch.topk``
    does not keep the lowest index first on ties."""
    vals, ids = torch.sort(logits.float(), dim=-1, descending=True, stable=True)
    return vals[:, :k].contiguous(), ids[:, :k].to(torch.int32).contiguous()


def gqa_scores(q: torch.Tensor, k: torch.Tensor, n_kv: int) -> torch.Tensor:
    """q: (B,S,Hq,D), k: (B,T,Hkv,D) -> scores (B,Hkv,G,S,T)."""
    b, s, hq, d = q.shape
    qg = q.reshape(b, s, n_kv, hq // n_kv, d)
    return torch.einsum("bsngd,btnd->bngst", qg, k) / math.sqrt(d)


def gqa_combine(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B,Hkv,G,S,T), v: (B,T,Hkv,D) -> (B,S,Hq,D)."""
    b, n, g, s, _t = probs.shape
    out = torch.einsum("bngst,btnd->bsngd", probs, v)
    return out.reshape(b, s, n * g, -1)


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         k: torch.Tensor, v: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One decode step's attention over a K/V cache, as ``models.layers``
    computes it over a bf16 cache: q (B, 1, Hq, D), the caches (B, T, Hkv,
    D), the row's new k and v (B, 1, Hkv, D), which stand in for the cache's
    row at ``pos`` (B,), and each row attending to the rows up to its
    position (the whole cache where the position lies past it). The scores
    are :func:`gqa_scores` in the inputs' type, then f32; the softmax is f32
    and its probabilities are cast to the inputs' type for
    :func:`gqa_combine`. Returns (B, 1, Hq, D)."""
    cols = torch.arange(k_cache.shape[1], device=q.device)[None, :]  # (1, T)
    own = (cols == pos[:, None])[:, :, None, None]  # (B, T, 1, 1)
    k_all = torch.where(own, k.to(k_cache.dtype), k_cache)
    v_all = torch.where(own, v.to(v_cache.dtype), v_cache)
    scores = gqa_scores(q, k_all, k_cache.shape[2]).float()
    valid = cols <= pos[:, None]  # (B, T)
    scores = torch.where(valid[:, None, None, None, :], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v_all.dtype)
    return gqa_combine(probs, v_all)


def decode_attention_f64(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                         k: torch.Tensor, v: torch.Tensor,
                         pos: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`decode_attention_ref`'s attention in float64 from the same
    inputs, and the most that a result which keeps the scores, the softmax
    and the sums in f32 may lie from it, elementwise: 2**-8 (bf16's
    rounding, relative) of |out|, for the output rounded once, and of the
    probabilities' mean of the attended |v|, for each probability rounded
    before P.V, with an eighth more of the latter for the f32 sums. Returns
    (out, limit), each (B, 1, Hq, D) float64."""
    q64, kc, vc, k64, v64 = (x.double() for x in (q, k_cache, v_cache, k, v))
    cols = torch.arange(k_cache.shape[1], device=q.device)[None, :]
    own = (cols == pos[:, None])[:, :, None, None]
    k_all, v_all = torch.where(own, k64, kc), torch.where(own, v64, vc)
    scores = gqa_scores(q64, k_all, k_cache.shape[2])
    scores = scores.masked_fill(~(cols <= pos[:, None])[:, None, None, None, :], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = gqa_combine(probs, v_all)
    return out, 2.0 ** -8 * (out.abs() + 1.125 * gqa_combine(probs, v_all.abs()))


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True) -> torch.Tensor:
    """q: (B, H, Sq, D), k and v: (B, H, Sk, D) → (B, H, Sq, D) in
    ``q.dtype``: plain softmax attention in float32, scale ``1/sqrt(D)``.
    The causal mask is bottom-right aligned (query row i sees keys
    ``j <= i + Sk - Sq``), as ``repro.kernels.ref.flash_attention_ref``."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    if causal:
        sq, sk = q.shape[2], k.shape[2]
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)
