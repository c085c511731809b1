"""Neural building blocks of the dense family, as plain functions on tensors.

The counterpart of ``repro/models/layers.py`` for the layers a dense GQA
transformer runs: norms, rotary embedding, attention with a per-slot KV
cache, and the SwiGLU MLP. Parameters are plain dicts of tensors with the
reference's names and layouts, so a test can load the reference's weights
and compare like with like.

Compute dtype is bf16, with the same f32 islands as the reference: norm and
rope math in f32, attention scores and softmax in f32 and then cast to bf16.
int8 KV, ``chunked_attention``, MoE, Mamba and RWKV are not ported yet
(``ROADMAP.md``, Queue 1).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from .config import ModelConfig

COMPUTE_DTYPE = torch.bfloat16


def _dense_init(gen: torch.Generator, shape: tuple[int, ...], scale_axis: int = 0,
                stack: int = 0) -> torch.Tensor:
    """N(0, 1/fan_in) in f32, stored in bf16, as the reference draws it.
    ``stack`` > 0 draws that many layers at once under a leading axis; the
    scale still comes from the per-layer ``shape``."""
    scale = 1.0 / math.sqrt(shape[scale_axis])
    full = (stack, *shape) if stack else shape
    x = torch.randn(full, generator=gen, dtype=torch.float32, device=gen.device)
    return (x * scale).to(COMPUTE_DTYPE)


# --------------------------------------------------------------------------
# Norms & positional encodings
# --------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps) * weight + bias).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, D); positions: (B, S) or (S,)."""
    d = x.shape[-1]
    # log(theta) in f32 as the reference takes it, on the host: a tensor made
    # on the card here would copy and synchronise on every call
    log_theta = float(np.log(np.float32(theta)))
    freqs = torch.exp(
        -log_theta * torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
    )  # (D/2,)
    angles = positions[..., None].float() * freqs  # (B, S, D/2)
    cos = torch.cos(angles)[..., None, :]  # (B, S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA, optional QKV bias, optional per-slot KV cache)
# --------------------------------------------------------------------------


def attention_init(gen: torch.Generator, cfg: ModelConfig, stack: int) -> dict:
    d, hd = cfg.d_model, cfg.head_dim_
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    params = {
        "wq": _dense_init(gen, (d, hq * hd), stack=stack),
        "wk": _dense_init(gen, (d, hkv * hd), stack=stack),
        "wv": _dense_init(gen, (d, hkv * hd), stack=stack),
        "wo": _dense_init(gen, (hq * hd, d), stack=stack),
    }
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            params[name] = torch.zeros((stack, width), dtype=COMPUTE_DTYPE,
                                       device=gen.device)
    return params


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1)


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


def masked_cache_write(buf: torch.Tensor, val: torch.Tensor, pos: torch.Tensor,
                       update_mask: torch.Tensor | None) -> None:
    """Write one row per slot into ``buf`` (B, T, H, D), in place, at that
    slot's ``pos``; where JAX donated the cache and rebuilt it, the port
    updates it where it lies.

    Only the slots that ``update_mask`` selects change. A masked-out slot is
    never indexed at its own position, which may lie past the cache (a
    padded prefill step, or a resident slot riding along another slot's
    prefill chunk): its write goes to its row 0 and carries the value
    already there, so its cache stays bit-identical and no host sync is
    needed to pick the selected rows. The reference writes every row and
    then restores the masked ones (``Model._masked_cache``), and XLA drops
    out-of-range writes that PyTorch would reject."""
    rows = torch.arange(buf.shape[0], device=buf.device)
    pos = pos.long()
    new = val[:, 0].to(buf.dtype)
    if update_mask is None:
        buf[rows, pos] = new
        return
    at = torch.where(update_mask, pos, torch.zeros_like(pos))
    buf[rows, at] = torch.where(update_mask[:, None, None], new, buf[rows, at])


def attention_apply(
    params: dict,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    *,
    cache: dict | None = None,
    cache_pos: torch.Tensor | None = None,
    update_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Causal self-attention. Without ``cache``: the full sequence, as the
    training forward runs it. With ``cache`` ({"k","v": (B, S_max, Hkv, D)},
    updated in place) and ``cache_pos`` ((B,) per-slot positions): one new
    token per slot, written at its position (only where ``update_mask``
    selects), attending to the cache rows up to its position."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = _split_heads(q, hq)
    k = _split_heads(k, hkv)
    v = _split_heads(v, hkv)

    q = rope(q, positions, cfg.rope_theta)
    if cache_pos is None:
        k = rope(k, positions, cfg.rope_theta)
    else:  # continuous batching: each row at its own position
        k = rope(k, cache_pos[:, None].expand(k.shape[:2]), cfg.rope_theta)

    if cache is not None:
        masked_cache_write(cache["k"], k, cache_pos, update_mask)
        masked_cache_write(cache["v"], v, cache_pos, update_mask)
        k, v = cache["k"], cache["v"]

    b, s = x.shape[:2]
    scores = gqa_scores(q, k, hkv).float()
    t = k.shape[1]
    if cache is not None:
        # mask out cache slots past each slot's current position
        valid = torch.arange(t, device=x.device)[None, :] <= cache_pos[:, None]  # (B, T)
        scores = torch.where(valid[:, None, None, None, :], scores, -1e30)
    else:
        mask = torch.ones((s, t), dtype=torch.bool, device=x.device).tril()
        scores = torch.where(mask[None, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(COMPUTE_DTYPE)
    out = gqa_combine(probs, v)
    return out.reshape(b, s, -1) @ params["wo"]


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, cfg: ModelConfig, stack: int) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "wi": _dense_init(gen, (d, ff), stack=stack),
        "wg": _dense_init(gen, (d, ff), stack=stack),
        "wo": _dense_init(gen, (ff, d), stack=stack),
    }


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ params["wg"]) * (x @ params["wi"])) @ params["wo"]
