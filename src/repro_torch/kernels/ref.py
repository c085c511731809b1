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
