"""Neural building blocks of the dense, MoE, hybrid, RWKV-6 and
encoder-decoder families, as plain functions on tensors.

The counterpart of ``repro/models/layers.py``: norms, rotary embedding,
attention (causal or not, with or without RoPE, self- or cross-attention,
with a per-slot KV cache), the SwiGLU and GELU MLPs, and the top-k
token-choice MoE MLP with its sort-based, capacity-limited dispatch; for
Jamba (the hybrid family), the Mamba selective SSM: a depthwise causal
convolution, an input-dependent ``dt``, ``B`` and ``C``, and the state
recurrence run as an associative scan over the sequence (in chunks with
``cfg.ssm_chunk``) or a step at a time in decode; and for RWKV-6 (Finch):
the time mix with its matrix-valued recurrent state and data-dependent
decay, and the squared-ReLU channel mix. Parameters are plain dicts of
tensors with the reference's names and layouts, so a test can load the
reference's weights and compare like with like.

Compute dtype is bf16, with the same f32 islands as the reference: norm and
rope math in f32, attention scores and softmax in f32 and then cast to bf16,
the MoE router in f32, the Mamba ``dt``, decay and state in f32, the RWKV
decay and state in f32. The serving cache may hold K/V as int8 with a bf16
scale a row and head (``quantize_kv``), and full-sequence passes may run
the online-softmax ``chunked_attention`` (``cfg.attn_chunk``), each as the
reference computes it. Under an ambient mesh (``distributed.use_mesh``)
``moe_impl="shard_map"`` runs the expert-parallel all-to-all
(:func:`_moe_shard_map`).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.distributed._functional_collectives as funcol
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..distributed.spmd import ambient_mesh, shard_local_write, traced_once
from ..kernels import ops as kernel_ops
from ..kernels.ref import gqa_combine, gqa_scores
from .config import ModelConfig

COMPUTE_DTYPE = torch.bfloat16


def _dense_init(gen: torch.Generator, shape: tuple[int, ...], scale_axis: int = 0,
                stack: int = 0) -> torch.Tensor:
    """N(0, 1/fan_in) in f32, stored in bf16, as the reference draws it.
    ``stack`` > 0 gives that many layers under a leading axis, the scale
    from the per-layer ``shape``: the numbers of one f32 draw of the whole
    stack, made a part of at most one layer at a time into the bf16 stack
    (:func:`_normal_parts`). A stacked f32 draw of qwen2.5-32b's MLP
    matrices would not fit one card beside its weights; drawn in parts,
    the seeded weights stay those of the stacked draw. On a ``meta``
    generator (``Model.abstract_params``) it draws nothing and returns an
    empty tensor of the shape."""
    if gen.device.type == "meta":
        return torch.empty((stack, *shape) if stack else shape, dtype=COMPUTE_DTYPE,
                           device=gen.device)
    scale = 1.0 / math.sqrt(shape[scale_axis])
    if not stack:
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
        return x.mul_(scale).to(COMPUTE_DTYPE)
    out = torch.empty((stack, *shape), dtype=COMPUTE_DTYPE, device=gen.device)
    flat = out.view(-1)
    for start, part in _normal_parts(gen, flat.numel(), out[0].numel()):
        flat[start:start + part.numel()] = part.mul_(scale)
    return out


def _launches(n: int) -> list[tuple[int, int]]:
    """The spans of ``torch.randn(n)`` on a card that PyTorch draws in
    launches of their own, in order: where a span's f32 bytes pass 32-bit
    offsets it halves it, the first half first. A draw of more than one
    launch first moves the generator's offset as one launch of all ``n``
    would, and then draws each launch from there."""
    if (n - 1) * 4 < 2**31 - 1:
        return [(0, n)]
    half = n // 2
    return _launches(half) + [(half + a, half + b) for a, b in _launches(n - half)]


def _normal_parts(gen: torch.Generator, n: int, most: int):
    """Yields ``(start, part)``: f32 tensors of at most ``most`` elements (or
    the draw's unit, where that is larger) that together hold the numbers
    of one ``torch.randn(n, generator=gen)``, and leave ``gen`` where that
    call leaves it.

    The CPU draws 16 numbers at a time in order, and redraws the last 16
    where ``n`` is not a multiple of 16; so parts of a multiple of 16, the
    last one at least 16 long, continue one stream. A card draws each of
    :func:`_launches` on its own; in one, each of ``T`` threads (256 a
    block, as many blocks as the SMs hold, the grid full from ``T``
    elements on) draws 4 numbers a Philox step, element ``j`` from thread
    ``j % T`` at step ``j // 4T``, and the generator's offset moves 4 a
    step; so a part of a multiple of ``4T`` starting at ``c`` of a launch,
    drawn from the offset the launch started at plus ``4 · c // 4T``, is
    that launch's slice. A launch too small to fill the grid is drawn
    whole."""
    if gen.device.type == "cpu":
        size = max(16, most // 16 * 16)
        starts = list(range(0, n, size))
        if len(starts) > 1 and n - starts[-1] < 16:
            starts.pop()  # the last part takes the CPU's redrawn tail
        for start, stop in zip(starts, starts[1:] + [n]):
            yield start, torch.randn(stop - start, generator=gen, dtype=torch.float32)
        return
    props = torch.cuda.get_device_properties(gen.device)
    threads = props.multi_processor_count * props.max_threads_per_multi_processor
    unit = 4 * threads  # the elements one Philox step of every thread draws
    size = max(unit, most // unit * unit)
    spans = _launches(n)
    if len(spans) > 1:
        gen.set_offset(gen.get_offset() + 4 * -(-n // unit))
    for first, last in spans:
        m = last - first
        if m < threads:
            yield first, torch.randn(m, generator=gen, dtype=torch.float32, device=gen.device)
            continue
        base = gen.get_offset()
        for start in range(0, m, size):
            gen.set_offset(base + 4 * (start // unit))
            k = min(size, m - start)
            part = torch.randn(-(-k // unit) * unit, generator=gen, dtype=torch.float32,
                               device=gen.device)  # whole steps: the launch's grid
            yield first + start, part[:k]
        gen.set_offset(base + 4 * -(-m // unit))


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


def inv_freqs(d: int, theta: float, device: torch.device) -> torch.Tensor:
    """theta^(-i/d) for even i < d, in f32: the frequencies of rotary and
    sinusoidal position embeddings, as the reference computes them."""
    # log(theta) in f32 as the reference takes it, on the host: a tensor made
    # on the card here would copy and synchronise on every call
    log_theta = float(np.log(np.float32(theta)))
    return torch.exp(-log_theta * torch.arange(0, d, 2, dtype=torch.float32, device=device) / d)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10_000.0) -> torch.Tensor:
    """Rotary embedding. x: (B, S, H, D); positions: (B, S) or (S,)."""
    freqs = inv_freqs(x.shape[-1], theta, x.device)  # (D/2,)
    angles = positions[..., None].float() * freqs  # (B, S, D/2)
    cos = torch.cos(angles)[..., None, :]  # (B, S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA, optional QKV bias, optional RoPE, self- or cross-attention,
# optional per-slot KV cache)
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


def cross_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Unmasked attention of q (B, S, Hq, D) over every row of k and v
    (B, T, Hkv, D): :func:`gqa_scores`, the f32 softmax and
    :func:`gqa_combine`, rounded as they round, with k and v read where they
    lie. ``einsum`` would copy each head-major first, since B and Hkv of a
    (B, T, Hkv, D) tensor do not merge into one batch axis; one ``bmm`` a
    batch row takes that row's heads as a strided batch (D apart, rows
    Hkv·D apart), which cuBLAS reads in place. The decoder's
    cross-attention over ``xk``/``xv`` runs here: whisper-medium's are
    12.3 MB each a layer at B = 4."""
    b, s, hq, d = q.shape
    n = k.shape[2]
    g = hq // n
    qh = q.reshape(b, s, n, g, d).permute(0, 2, 3, 1, 4).reshape(b, n, g * s, d)
    scores = torch.stack([torch.bmm(qh[i], k[i].permute(1, 2, 0)) for i in range(b)])
    probs = torch.softmax((scores / math.sqrt(d)).float(), dim=-1).to(COMPUTE_DTYPE)
    out = torch.stack([torch.bmm(probs[i], v[i].permute(1, 0, 2)) for i in range(b)])
    return out.reshape(b, n, g, s, d).permute(0, 3, 1, 2, 4).reshape(b, s, hq, d)


def attention_chunk(t: int, requested: int) -> int:
    """The chunk a full-sequence pass over ``t`` keys takes for
    ``cfg.attn_chunk = requested``: the largest divisor of ``t`` not above
    ``min(requested, t)``, as the reference picks it (1,500 → 500 and
    4,672 → 292 at 512). 1 means the plain path."""
    return next(c for c in range(min(requested, t), 0, -1) if t % c == 0)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, n_kv: int, *,
                      causal: bool, chunk: int) -> torch.Tensor:
    """Online-softmax attention over KV chunks of ``chunk`` rows, the
    reference's ``lax.scan`` as a loop, op for op: everything in f32, the
    scores multiplied by an f32 ``1/sqrt(d)`` (not divided by ``sqrt(d)``
    as :func:`gqa_scores` does), the causal mask at -1e30 and the running
    max ``m``, sum ``l`` and accumulator updated in the reference's order;
    the output ``acc / l`` cast to q's dtype. It never holds the S×T
    scores at once. q: (B,S,Hq,D); k,v: (B,T,Hkv,D) -> (B,S,Hq,D)."""
    b, s, hq, d = q.shape
    t = k.shape[1]
    if t % chunk:
        raise ValueError(f"chunk {chunk} does not divide {t} keys")
    g = hq // n_kv
    qg = q.reshape(b, s, n_kv, g, d).float()
    scale = float(np.float32(1.0) / np.sqrt(np.float32(d)))
    rows = torch.arange(s, device=q.device)
    m = torch.full((b, n_kv, g, s, 1), -1e30, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, n_kv, g, s, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, n_kv, g, s, d), dtype=torch.float32, device=q.device)
    for j in range(0, t, chunk):
        sc = torch.einsum("bsngd,btnd->bngst", qg, k[:, j:j + chunk].float()) * scale
        if causal:
            cols = j + torch.arange(chunk, device=q.device)
            sc = torch.where((rows[:, None] >= cols[None, :])[None, None, None], sc, -1e30)
        m_new = torch.maximum(m, torch.amax(sc, dim=-1, keepdim=True))
        p = torch.exp(sc - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bngst,btnd->bngsd", p, v[:, j:j + chunk].float())
        m = m_new
    out = (acc / l).to(q.dtype)  # (B,n,g,S,D)
    return out.movedim(3, 1).reshape(b, s, hq, d)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) absmax int8 quantization of x (B,S,H,D), as the
    reference's: the scale is ``max|x| / 127`` in f32, floored at 1e-8;
    ``x / scale`` rounds half to even and clips to ±127. Returns (int8
    values, the scale (B,S,H,1) in bf16)."""
    x32 = x.float()
    scale = torch.clamp_min(torch.amax(torch.abs(x32), dim=-1, keepdim=True) / 127.0, 1e-8)
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale.to(COMPUTE_DTYPE)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(COMPUTE_DTYPE) * scale.to(COMPUTE_DTYPE)


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
    needed to pick the selected rows. A selected slot past the cache raises
    (``IndexError``; a device assert on a card). The reference writes every
    row, attends with it and then restores the masked ones
    (``Model._masked_cache``), and XLA drops out-of-range writes that
    PyTorch would reject; :func:`attention_apply` gives a masked-out slot
    its own K/V at its position in what it attends to, so it computes the
    reference's numbers all the same. A DTensor cache is written a rank's
    shard at a time (``distributed.spmd.shard_local_write``)."""
    if isinstance(buf, DTensor):
        return shard_local_write(masked_cache_write, buf, val, pos, update_mask)
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
    positions: torch.Tensor | None,
    *,
    causal: bool = True,
    use_rope: bool = True,
    kv: torch.Tensor | None = None,
    cache: dict | None = None,
    cache_pos: torch.Tensor | None = None,
    update_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Attention of ``x`` (B, S, d). Without ``cache``: the full sequence,
    as the training forward runs it, causal unless ``causal=False``. With
    ``kv`` ((B, T, d), the encoder's output), cross-attention: K and V come
    from ``kv``, unrotated, and no mask applies. ``use_rope=False`` rotates
    neither Q nor K (``positions`` may then be None). With
    ``cfg.attn_chunk`` and more than that many query rows, the pass runs
    :func:`chunked_attention` over chunks of :func:`attention_chunk` keys
    (the plain path where that is 1).

    With ``cache`` ({"k","v": (B, S_max, Hkv, D)}, for an int8 cache also
    {"k_scale","v_scale": (B, S_max, Hkv, 1)}, updated in place) and
    ``cache_pos`` ((B,) per-slot positions): one new token per slot,
    written at its position (only where ``update_mask`` selects),
    attending to the cache rows up to its position. Every slot, a
    masked-out one too, attends with its own new K/V at its position, as
    the reference's do: under MoE the rows meet in one capacity-limited
    expert buffer, so a masked row's numbers reach the live rows. A plain
    bf16 cache is attended over by ``kernels.ops.decode_attention_op``
    (on a card the hand-written kernel, which reads the cache where it lies
    and only up to each position; on the CPU the einsums below, bit for
    bit); an int8 or a sharded (DTensor) cache by :func:`_cached_kv` and
    the einsums."""
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    src = x if kv is None else kv
    q = x @ params["wq"]
    k = src @ params["wk"]
    v = src @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    q = _split_heads(q, hq)
    k = _split_heads(k, hkv)
    v = _split_heads(v, hkv)

    if use_rope and kv is None:
        q = rope(q, positions, cfg.rope_theta)
        if cache_pos is None:
            k = rope(k, positions, cfg.rope_theta)
        else:  # continuous batching: each row at its own position
            k = rope(k, cache_pos[:, None].expand(k.shape[:2]), cfg.rope_theta)

    b, s = x.shape[:2]
    if cache is not None and s == 1 and _plain_bf16(cache):
        for key, val in (("k", k), ("v", v)):
            masked_cache_write(cache[key], val, cache_pos, update_mask)
        out = kernel_ops.decode_attention_op(q, cache["k"], cache["v"], k, v, cache_pos)
        return out.reshape(b, s, -1) @ params["wo"]
    if cache is not None:
        cols = torch.arange(cache["k"].shape[1], device=x.device)[None, :]  # (1, T)
        k, v = _cached_kv(cache, k, v, cols, cache_pos, update_mask)
    elif cfg.attn_chunk and s > cfg.attn_chunk:
        chunk = attention_chunk(k.shape[1], cfg.attn_chunk)
        if chunk > 1:
            out = chunked_attention(q, k, v, hkv, causal=causal and kv is None, chunk=chunk)
            return out.reshape(b, s, -1) @ params["wo"]

    scores = gqa_scores(q, k, hkv).float()
    t = k.shape[1]
    if cache is not None:
        # mask out cache slots past each slot's current position
        valid = cols <= cache_pos[:, None]  # (B, T)
        scores = torch.where(valid[:, None, None, None, :], scores, -1e30)
    elif causal and kv is None:
        mask = torch.ones((s, t), dtype=torch.bool, device=x.device).tril()
        scores = torch.where(mask[None, None, None], scores, -1e30)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)  # bf16 as the reference's; f32 in f32
    out = gqa_combine(probs, v)
    return out.reshape(b, s, -1) @ params["wo"]


def _plain_bf16(cache: dict) -> bool:
    """Whether a layer's cache holds plain (not DTensor) bf16 K/V, which a
    decode step attends over with ``kernels.ops.decode_attention_op``; an
    int8 cache and a sharded one take :func:`_cached_kv` and the einsums."""
    k = cache["k"]
    return "k_scale" not in cache and not isinstance(k, DTensor) and k.dtype == COMPUTE_DTYPE


def _cached_kv(cache: dict, k: torch.Tensor, v: torch.Tensor, cols: torch.Tensor,
               cache_pos: torch.Tensor, update_mask: torch.Tensor | None):
    """Writes the new (B, 1, Hkv, D) K and V into the layer's cache at each
    slot's position (only where ``update_mask`` selects) and returns the K
    and V to attend over: the whole cache, with each row's own new K/V at
    its position, where the reference wrote it before attending (a row
    past the cache has no mark there, so nothing is added, as XLA drops
    that write). A cache with ``k_scale`` holds int8 K/V: the new rows are
    quantized first (:func:`quantize_kv`) and the whole cache is
    dequantized to attend over, as the reference does; a masked-out row
    thus attends with its own quantized-then-dequantized K/V."""
    new = {"k": k, "v": v}
    if "k_scale" in cache:
        (new["k"], new["k_scale"]), (new["v"], new["v_scale"]) = quantize_kv(k), quantize_kv(v)
    for key, val in new.items():
        masked_cache_write(cache[key], val, cache_pos, update_mask)
    seen = cache  # every row is in place already
    if update_mask is not None:
        own = (cols == cache_pos[:, None])[:, :, None, None]  # (B, T, 1, 1)
        seen = {key: torch.where(own, val.to(cache[key].dtype), cache[key])
                for key, val in new.items()}
    if "k_scale" in cache:
        return dequantize_kv(seen["k"], seen["k_scale"]), dequantize_kv(seen["v"], seen["v_scale"])
    return seen["k"], seen["v"]


# --------------------------------------------------------------------------
# SwiGLU and GELU MLPs
# --------------------------------------------------------------------------


def mlp_init(gen: torch.Generator, cfg: ModelConfig, stack: int) -> dict:
    """SwiGLU's ``{"wi", "wg", "wo"}``, or with ``cfg.mlp_kind == "gelu"``
    the two-matrix ``{"wi", "wo"}`` (whisper's)."""
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.mlp_kind == "gelu":
        return {"wi": _dense_init(gen, (d, ff), stack=stack),
                "wo": _dense_init(gen, (ff, d), stack=stack)}
    return {
        "wi": _dense_init(gen, (d, ff), stack=stack),
        "wg": _dense_init(gen, (d, ff), stack=stack),
        "wo": _dense_init(gen, (ff, d), stack=stack),
    }


def mlp_apply(params: dict, x: torch.Tensor) -> torch.Tensor:
    if "wg" not in params:  # GELU (whisper's two-matrix MLP)
        return _gelu(x @ params["wi"]) @ params["wo"]
    return (_silu(x @ params["wg"]) * (x @ params["wi"])) @ params["wo"]


# bf16 values of the tanh approximation's constants, as ``jax.nn.gelu`` casts
# them to the activations' dtype
_GELU_CUBE = float(torch.tensor(0.044715).to(COMPUTE_DTYPE))
_GELU_SCALE = float(torch.tensor(math.sqrt(2 / math.pi)).to(COMPUTE_DTYPE))


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (``approximate=True``) as XLA computes it in bf16:
    each op of x · 0.5 · (1 + tanh(c · (x + 0.044715 x³))) rounded to bf16,
    its constants too, where ``F.gelu`` rounds once and gives another bf16
    value for about four inputs in ten."""
    inner = _GELU_SCALE * (x + _GELU_CUBE * (x * (x * x)))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


# --------------------------------------------------------------------------
# Mixture-of-Experts MLP (top-k token-choice with capacity, sort-based
# dispatch, as the reference formulates it)
# --------------------------------------------------------------------------


def moe_init(gen: torch.Generator, cfg: ModelConfig, stack: int) -> dict:
    """An f32 router (d, E) and bf16 experts (E, d, ff) / (E, ff, d), each
    scaled by its per-expert fan-in, under a leading ``stack`` axis. The
    experts are drawn one layer at a time into the stacked bf16 tensor: a
    stacked f32 draw of full-width experts would not fit beside them."""
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def experts(shape: tuple[int, ...]) -> torch.Tensor:
        out = torch.empty((stack, *shape), dtype=COMPUTE_DTYPE, device=gen.device)
        for i in range(stack):
            out[i] = _dense_init(gen, shape, scale_axis=1)
        return out

    return {
        "router": _dense_init(gen, (d, e), stack=stack).float(),
        "wi": experts((e, d, ff)),
        "wg": experts((e, d, ff)),
        "wo": experts((e, ff, d)),
    }


def _moe_route(params: dict, cfg: ModelConfig, xt: torch.Tensor):
    """Shared router: returns (top_p, top_e, aux_loss). xt: (T, d).

    The top-k runs through ``kernels.ops.top_k_op`` (the hand-written
    ``top_k`` on a card, its stable sort on the CPU), in ``lax.top_k``'s
    order, never ``torch.topk``, whose order on ties differs. The router
    product sums in float64 and rounds to float32: at least float32's
    precision whatever the process's TF32 setting, as a TF32 product would
    flip routes (PyTorch's TF32 switches are global, and its two APIs for
    them refuse to be mixed)."""
    k, e = cfg.experts_per_token, cfg.n_experts
    logits = (xt.double() @ params["router"].double()).float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = kernel_ops.top_k_op(probs, k)  # (T, k) f32, int32
    if probs.requires_grad:  # the kernel's values carry no gradient; the same values gathered do
        top_p = torch.gather(probs, -1, top_e.long())
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)
    # load-balancing auxiliary loss (Switch-style)
    me = torch.mean(probs, dim=0)
    first = top_e[:, :1] == torch.arange(e, dtype=top_e.dtype, device=xt.device)
    ce = torch.mean(first.float(), dim=0)
    aux = e * torch.sum(me * ce)
    return top_p, top_e, aux


def _moe_dispatch(cfg: ModelConfig, xt: torch.Tensor, top_p: torch.Tensor,
                  top_e: torch.Tensor, capacity: int):
    """Sort-based dispatch; returns (buf (E,C,d), se, sp, st, slot, keep).

    The reference's semantics exactly: a stable sort by expert (ties keep
    the lower flat index), each expert's first slot by a left-side search,
    ``keep`` where the position within the expert is below ``capacity``
    (dropped entries point at slot 0 and add zeros), and a scatter-add of
    the kept rows into a zero buffer (out of place: DTensor takes no
    in-place write into a tensor it did not make). Nothing here reads a
    device value back to the host, so a CUDA graph can capture it."""
    t, d = xt.shape
    k, e = cfg.experts_per_token, cfg.n_experts
    flat_e = top_e.reshape(-1).long()  # (T*k,)
    flat_p = top_p.reshape(-1)
    token_idx = torch.arange(t * k, device=xt.device) // k  # each token k times
    order = torch.argsort(flat_e, stable=True)  # group by expert
    se, sp, st = flat_e[order], flat_p[order], token_idx[order]
    starts = torch.searchsorted(se, torch.arange(e, device=xt.device))  # first slot of each expert
    pos = torch.arange(t * k, device=xt.device) - starts[se]  # position within expert
    keep = pos < capacity
    slot = torch.where(keep, pos, 0)
    buf = torch.zeros((e, capacity, d), dtype=xt.dtype, device=xt.device).index_put(
        (se, slot), xt[st] * keep[:, None].to(xt.dtype), accumulate=True)
    return buf, se, sp, st, slot, keep


def _moe_ffn(params: dict, buf: torch.Tensor) -> torch.Tensor:
    h = torch.einsum("ecd,edf->ecf", buf, params["wg"])
    g = torch.einsum("ecd,edf->ecf", buf, params["wi"])
    return torch.einsum("ecf,efd->ecd", _silu(h) * g, params["wo"])


def _moe_combine(cfg: ModelConfig, yb: torch.Tensor, se, sp, st, slot, keep,
                 t: int, d: int) -> torch.Tensor:
    """Each kept entry's expert output times its weight, rounded to bf16
    first as the reference rounds it, summed into its token's row. A token
    gets ``k`` terms (a dropped one adds zero); at k = 2 the sum does not
    depend on the order of the adds."""
    out_tok = yb[se, slot] * (sp * keep)[:, None].to(yb.dtype)
    return torch.zeros((t, d), dtype=yb.dtype, device=yb.device).index_put(
        (st,), out_tok, accumulate=True)


def moe_apply(params: dict, cfg: ModelConfig,
              x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (output, aux_loss). x: (B, S, d).

    The reference's ``gspmd`` formulation: every token of the batch routes
    into one (E, C, d) buffer of ``C = max(int(capacity_factor·T·k/E), 1)``
    slots an expert, and every expert's buffer goes through the FFN.
    ``moe_impl="shard_map"`` runs :func:`_moe_shard_map` under an ambient
    mesh with a ``model`` axis that divides the experts, and this same path
    where the reference's does: no mesh, no ``model`` axis, or
    ``E % ep != 0``."""
    if cfg.moe_impl == "shard_map":
        out = _moe_shard_map(params, cfg, x)
        if out is not None:
            return out
    b, s, d = x.shape
    t = b * s
    k, e = cfg.experts_per_token, cfg.n_experts
    xt = x.reshape(t, d)
    top_p, top_e, aux = _moe_route(params, cfg, xt)
    capacity = max(int(cfg.capacity_factor * t * k / e), 1)
    buf, se, sp, st, slot, keep = _moe_dispatch(cfg, xt, top_p, top_e, capacity)
    yb = _moe_ffn(params, buf)
    out = _moe_combine(cfg, yb, se, sp, st, slot, keep, t, d)
    return out.reshape(b, s, d), aux


def _moe_shard_map(params: dict, cfg: ModelConfig, x: torch.Tensor):
    """Expert-parallel MoE over the ambient mesh, the reference's
    ``_moe_shard_map``: returns (output, aux_loss), or None where no mesh is
    ambient, it has no ``model`` axis, or ``ep`` (its size) does not divide
    the experts.

    Each rank takes its batch shard's tokens whole (replicated over
    ``model``) and its ``E/ep`` experts, routes the tokens locally into an
    (E, C, d) buffer with ``C`` padded to a multiple of ``ep``, and sends
    each expert's rows to the rank that owns it with one
    ``all_to_all_single`` over the ``model`` group, (E, C, d) → (E/ep, C·ep,
    d); the local experts' FFN runs, and a second all-to-all brings the
    rows back, (E/ep, C·ep, d) → (E, C, d), to combine. The collective is
    the autograd-aware functional one, so a train step differentiates
    through it. ``aux`` is averaged over the batch axes. ``x`` and the
    parameters may be DTensors of any placement (they are redistributed
    first) or plain tensors, taken as replicated; the output is a DTensor
    sharded over the batch axes, or whole where ``x`` was plain. A batch
    that the batch axes do not divide raises ``ValueError``, as the
    reference's ``shard_map`` refuses it."""
    mesh = ambient_mesh()
    names = tuple(mesh.mesh_dim_names or ()) if mesh is not None else ()
    if "model" not in names:
        return None
    ep = mesh.size(names.index("model"))
    e, k = cfg.n_experts, cfg.experts_per_token
    if e % ep:
        return None
    shards = math.prod(mesh.size(i) for i, a in enumerate(names) if a != "model")
    if x.shape[0] % shards:
        raise ValueError(f"moe_impl='shard_map': a batch of {x.shape[0]} does not divide "
                         f"the batch axes' {shards} devices")
    rows = [Replicate() if a == "model" else Shard(0) for a in names]
    experts = [Shard(0) if a == "model" else Replicate() for a in names]

    def local(t: torch.Tensor, placements) -> torch.Tensor:
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * len(names), run_check=False)
        return t.redistribute(mesh, placements).to_local()

    lp = {"router": local(params["router"], [Replicate()] * len(names)),
          **{w: local(params[w], experts) for w in ("wi", "wg", "wo")}}
    xl = local(x, rows)
    bl, s, d = xl.shape
    t = bl * s
    xt = xl.reshape(t, d)
    top_p, top_e, aux = _moe_route(lp, cfg, xt)
    capacity = max(int(cfg.capacity_factor * t * k / e), 1)
    capacity = -(-capacity // ep) * ep  # E·C splits evenly across the expert axis
    buf, se, sp, st, slot, keep = _moe_dispatch(cfg, xt, top_p, top_e, capacity)
    group = (mesh, names.index("model"))
    # to expert owners: peer j's (E/ep, C, d) block of my experts lands at j
    buf = funcol.all_to_all_single_autograd(buf, None, None, group)
    buf = buf.reshape(ep, e // ep, capacity, d).transpose(0, 1).reshape(e // ep, ep * capacity, d)
    yb = _moe_ffn(lp, buf)  # the local experts only
    # back to the token owners: (E/ep, C·ep, d) -> (E, C, d)
    yb = yb.reshape(e // ep, ep, capacity, d).transpose(0, 1).contiguous()
    yb = funcol.all_to_all_single_autograd(yb, None, None, group).reshape(e, capacity, d)
    out = _moe_combine(cfg, yb, se, sp, st, slot, keep, t, d).reshape(bl, s, d)
    out = DTensor.from_local(out, mesh, rows, run_check=False)
    aux = DTensor.from_local(aux, mesh, [Replicate() if a == "model" else Partial("avg")
                                         for a in names], run_check=False)
    aux = aux.redistribute(mesh, [Replicate()] * len(names))
    if not isinstance(x, DTensor):
        return out.full_tensor(), aux.full_tensor()
    return out, aux


# --------------------------------------------------------------------------
# Mamba (selective SSM): Jamba's mixer
# --------------------------------------------------------------------------


def mamba_init(gen: torch.Generator, cfg: ModelConfig, stack: int) -> dict:
    """The reference's Mamba parameters under a leading ``stack`` axis:
    bf16 ``in_proj`` (d, 2·d_in), ``conv_w`` (K, d_in), ``x_proj``
    (d_in, 2N + 1) and ``out_proj`` (d_in, d), each N(0, 1/fan_in); f32
    ``dt_bias`` zeros, ``a_log`` = log(1 … N) on every channel, ``d_skip``
    ones."""
    d = cfg.d_model
    d_in, n = cfg.ssm_expand * d, cfg.ssm_state_dim
    dev = gen.device
    a_log = torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=dev))
    return {
        "in_proj": _dense_init(gen, (d, 2 * d_in), stack=stack),
        "conv_w": _dense_init(gen, (cfg.ssm_conv_dim, d_in), stack=stack),
        "x_proj": _dense_init(gen, (d_in, 2 * n + 1), stack=stack),  # -> B, C, dt
        "dt_bias": torch.zeros((stack, d_in), dtype=torch.float32, device=dev),
        "a_log": a_log.expand(stack, d_in, n).contiguous(),
        "d_skip": torch.ones((stack, d_in), dtype=torch.float32, device=dev),
        "out_proj": _dense_init(gen, (d_in, d), stack=stack),
    }


def _mamba_scan_combine(left: tuple, right: tuple) -> tuple:
    """(a1, b1) then (a2, b2): the recurrence h = a·h + b composed."""
    a1, b1 = left
    a2, b2 = right
    return a2 * a1, a2 * b1 + b2


def _along(x: torch.Tensor, axis: int, start: int, stop: int | None = None,
           step: int = 1) -> torch.Tensor:
    return x[(slice(None),) * axis + (slice(start, stop, step),)]


def _interleave(even: torch.Tensor, odd: torch.Tensor, axis: int) -> torch.Tensor:
    """even[0], odd[0], even[1], … along ``axis`` (``even`` may be one longer)."""
    pairs = torch.stack([_along(even, axis, 0, odd.shape[axis]), odd], axis + 1)
    out = pairs.flatten(axis, axis + 1)
    if even.shape[axis] > odd.shape[axis]:
        out = torch.cat([out, _along(even, axis, -1)], axis)
    return out


def associative_scan(fn, elems: tuple, axis: int) -> tuple:
    """``lax.associative_scan(fn, elems, axis=axis)``, combining the same
    elements in the same order: pairs of neighbours reduced, the half-length
    scan by recursion, then each even element from the odd prefix before it.
    With the reference's order the f32 Mamba state matches its own to
    within f32 rounding; a sequential loop sums in another order."""
    n = elems[0].shape[axis]
    if n < 2:
        return elems
    reduced = fn(tuple(_along(e, axis, 0, -1, 2) for e in elems),
                 tuple(_along(e, axis, 1, None, 2) for e in elems))
    odd = associative_scan(fn, reduced, axis)
    before = tuple(_along(e, axis, 0, -1) for e in odd) if n % 2 == 0 else odd
    even = fn(before, tuple(_along(e, axis, 2, None, 2) for e in elems))
    even = tuple(torch.cat([_along(e, axis, 0, 1), r], axis) for e, r in zip(elems, even))
    return tuple(_interleave(e, o, axis) for e, o in zip(even, odd))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)``: max(x, 0) + log1p(e^-|x|)
    (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _mamba_gate(params: dict, y: torch.Tensor, xi: torch.Tensor, z: torch.Tensor,
                dtype: torch.dtype) -> torch.Tensor:
    """The skip through ``d_skip``, the SiLU gate of ``z`` in f32, the cast
    back and ``out_proj``."""
    y = y + xi.float() * params["d_skip"]
    return (y * _silu(z.float())).to(dtype) @ params["out_proj"]


def _mamba_contract(h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The reference's ``einsum(..."dn,...n->...d")`` of the f32 state with
    ``C``, as an elementwise product and a sum over N: never a product that
    a TF32 switch could send through the tensor cores."""
    return torch.sum(h * c.float()[..., None, :], dim=-1)


def mamba_apply(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Training/prefill over (B, S, d) from a zero state. The convolution is
    the reference's Python ``sum`` of K products, each add rounded in the
    activations' dtype; ``dt`` is one column put through softplus in f32
    and broadcast over d_in; the state runs as one :func:`associative_scan`
    over S, or with ``cfg.ssm_chunk`` (when it divides S and S exceeds it;
    else, as the reference, silently the one scan) as a loop over chunks
    carrying the (B, d_in, N) state, the scan inside each. The one scan
    holds (B, S, d_in, N) f32 tensors: 268 MB each at jamba's widths, B = 4
    and S = 64; the chunks hold (B, chunk, d_in, N)."""
    b, s, _ = x.shape
    d_in, n, kc = cfg.ssm_expand * cfg.d_model, cfg.ssm_state_dim, cfg.ssm_conv_dim
    xi, z = torch.chunk(x @ params["in_proj"], 2, dim=-1)  # (B, S, d_in) each

    w = params["conv_w"]  # (K, d_in): depthwise causal conv over time
    pad = F.pad(xi, (0, 0, kc - 1, 0))
    conv = pad[:, :s] * w[0]
    for i in range(1, kc):
        conv = conv + pad[:, i:i + s] * w[i]
    xi = _silu(conv)

    bc_dt = xi @ params["x_proj"]  # (B, S, 2N+1)
    bmat, cmat, dt = bc_dt[..., :n], bc_dt[..., n:2 * n], bc_dt[..., 2 * n:]
    dt = _softplus(dt.float() + params["dt_bias"])  # (B, S, d_in)
    a = -torch.exp(params["a_log"])  # (d_in, N)

    def prefix(xi_c, dt_c, b_c, h0):
        """One chunk's states h_t (B, C, d_in, N) from the carried-in h0."""
        a_bar = torch.exp(dt_c[..., None] * a)
        bx = (dt_c * xi_c.float())[..., None] * b_c.float()[:, :, None, :]
        a_acc, h = associative_scan(_mamba_scan_combine, (a_bar, bx), 1)
        return h + a_acc * h0[:, None]

    h0 = torch.zeros((b, d_in, n), dtype=torch.float32, device=x.device)
    chunk = cfg.ssm_chunk
    if chunk and s > chunk and s % chunk == 0:
        ys = []
        for t in range(0, s, chunk):
            part = slice(t, t + chunk)
            h = prefix(xi[:, part], dt[:, part], bmat[:, part], h0)
            ys.append(_mamba_contract(h, cmat[:, part]))
            h0 = h[:, -1]
        y = torch.cat(ys, 1)
    else:
        y = _mamba_contract(prefix(xi, dt, bmat, h0), cmat)
    return _mamba_gate(params, y, xi, z, x.dtype)


def mamba_step(params: dict, cfg: ModelConfig, x: torch.Tensor,
               state: dict) -> tuple[torch.Tensor, dict]:
    """Single-token decode. x: (B, 1, d); state: {"h": (B, d_in, N) f32,
    "conv": (B, K, d_in)}. Returns (y (B, 1, d), the new state as new
    tensors): the caller decides which rows of its cache take them. The
    convolution is the reference's ``einsum`` over the window: products
    exact in f32, summed in f32 oldest first, rounded once, as XLA's dot
    does it; elementwise, so a row's bits do not depend on the batch."""
    n = cfg.ssm_state_dim
    xi, z = torch.chunk(x[:, 0] @ params["in_proj"], 2, dim=-1)  # (B, d_in)
    conv = torch.cat([state["conv"][:, 1:], xi[:, None]], dim=1)  # (B, K, d_in)
    w = params["conv_w"].float()
    acc = conv[:, 0].float() * w[0]
    for i in range(1, cfg.ssm_conv_dim):
        acc = acc + conv[:, i].float() * w[i]
    xi = _silu(acc.to(x.dtype))

    bc_dt = xi @ params["x_proj"]
    bvec, cvec, dt = bc_dt[..., :n], bc_dt[..., n:2 * n], bc_dt[..., 2 * n:]
    dt = _softplus(dt.float() + params["dt_bias"])  # (B, d_in)
    a_bar = torch.exp(dt[..., None] * -torch.exp(params["a_log"]))  # (B, d_in, N)
    bx = (dt * xi.float())[..., None] * bvec.float()[:, None, :]
    h = a_bar * state["h"] + bx
    y = _mamba_contract(h, cvec)
    return _mamba_gate(params, y, xi, z, x.dtype)[:, None], {"h": h, "conv": conv}


# --------------------------------------------------------------------------
# RWKV-6 (Finch) time mix + channel mix: data-dependent decay, attention-free
# --------------------------------------------------------------------------


def rwkv_init(gen: torch.Generator, cfg: ModelConfig, stack: int) -> dict:
    d = cfg.d_model
    dev = gen.device

    def full(shape: tuple[int, ...], value: float) -> torch.Tensor:
        return torch.full((stack, *shape), value, dtype=torch.float32, device=dev)

    return {
        "wr": _dense_init(gen, (d, d), stack=stack),
        "wk": _dense_init(gen, (d, d), stack=stack),
        "wv": _dense_init(gen, (d, d), stack=stack),
        "wg": _dense_init(gen, (d, d), stack=stack),
        "wo": _dense_init(gen, (d, d), stack=stack),
        "w_decay": _dense_init(gen, (d, d), stack=stack),  # data-dependent decay proj
        "decay_bias": full((d,), -6.0),
        "mix": full((5, d), 0.5),  # token-shift mixes r, k, v, g, w
        "bonus": full((d,), 0.0),  # per-channel "u" bonus
    }


def _rwkv_heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, d // head_dim, head_dim)


def _rwkv_mixes(params: dict, x: torch.Tensor, prev: torch.Tensor) -> list[torch.Tensor]:
    """The five token-shift lerps (r, k, v, g, w) in the activations' dtype,
    ``1 - mix`` included, as the reference casts them."""
    mix = params["mix"].to(x.dtype)
    return [x * mix[i] + prev * (1 - mix[i]) for i in range(5)]


def _silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as XLA computes it in the activations' dtype: each op
    of x · 1/(1 + e^(-x)) rounded to bf16, where ``F.silu`` rounds once and
    gives another bf16 value for a third of inputs."""
    return x * (1 / (1 + torch.exp(-x)))


def _rwkv_decay(params: dict, xw: torch.Tensor) -> torch.Tensor:
    """exp(-exp(f32(xw @ w_decay) + decay_bias)): a decay in (0, 1), in f32."""
    return torch.exp(-torch.exp((xw @ params["w_decay"]).float() + params["decay_bias"]))


def _wkv_step(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, state: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One step of the recurrence over (B, H, K) r, k, w, u and (B, H, V) v
    with the (B, H, K, V) f32 state: returns (out (B, H, V), new state).

    ``kv`` is an outer product and ``r · (s + u·kv)`` a contraction over K.
    Both are written as elementwise products and a sum, never ``einsum`` or
    ``bmm``: PyTorch routes an f32 product through TF32 when its global
    switch is on (and a K = 1 outer product too), and this state must stay
    in full f32 whatever the process has set."""
    kv = k.float()[..., :, None] * v.float()[..., None, :]
    out = torch.sum(r.float()[..., :, None] * (state + u[..., None] * kv), dim=-2)
    return out, w[..., None] * state + kv


def rwkv_apply(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Training/prefill over (B, S, d) from a zero state: the reference's
    ``lax.scan`` over time is a Python loop over S. On ``meta`` tensors (the
    dry run's trace) one step stands for all S (``distributed.spmd
    .traced_once``)."""
    b, s, d = x.shape
    hd = cfg.rwkv_head_dim
    nh = d // hd

    shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]  # token shift
    xr, xk, xv, xg, xw = _rwkv_mixes(params, x, shifted)

    r = _rwkv_heads(xr @ params["wr"], hd)  # (B,S,H,K)
    k = _rwkv_heads(xk @ params["wk"], hd)
    v = _rwkv_heads(xv @ params["wv"], hd)
    g = _silu(xg @ params["wg"])  # (B,S,D)
    w = _rwkv_heads(_rwkv_decay(params, xw), hd)  # (B,S,H,K)
    u = params["bonus"].reshape(nh, hd).expand(b, nh, hd)  # (B,H,K)

    state = torch.zeros((b, nh, hd, hd), dtype=torch.float32, device=x.device)
    if x.device.type == "meta":  # the dry run: one step of one shape, weighted by s
        out, state = traced_once(s, _wkv_step, r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, state)
        outs = [out] * s
    else:
        outs = []
        for t in range(s):
            out, state = _wkv_step(r[:, t], k[:, t], v[:, t], w[:, t], u, state)
            outs.append(out)
    out = torch.stack(outs, 1).reshape(b, s, d).to(x.dtype)
    return (out * g) @ params["wo"]


def rwkv_step(params: dict, cfg: ModelConfig, x: torch.Tensor,
              state: dict) -> tuple[torch.Tensor, dict]:
    """Single-token decode. x: (B, 1, d); state: {"s": (B,H,K,V) f32,
    "shift": (B, d)}. Returns (y (B, 1, d), the new state as new tensors):
    the caller decides which rows of its cache take them."""
    b, _, d = x.shape
    hd = cfg.rwkv_head_dim
    xt = x[:, 0]
    xr, xk, xv, xg, xw = _rwkv_mixes(params, xt, state["shift"])

    r = (xr @ params["wr"]).reshape(b, -1, hd)
    k = (xk @ params["wk"]).reshape(b, -1, hd)
    v = (xv @ params["wv"]).reshape(b, -1, hd)
    g = _silu(xg @ params["wg"])
    w = _rwkv_decay(params, xw).reshape(b, -1, hd)
    u = params["bonus"].reshape(-1, hd).expand(b, -1, hd)

    out, new_s = _wkv_step(r, k, v, w, u, state["s"])
    out = out.reshape(b, d).to(x.dtype)
    y = (out * g) @ params["wo"]
    return y[:, None], {"s": new_s, "shift": xt}


def rwkv_channel_mix_init(gen: torch.Generator, cfg: ModelConfig, stack: int) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    return {
        "wk": _dense_init(gen, (d, ff), stack=stack),
        "wv": _dense_init(gen, (ff, d), stack=stack),
        "mix": torch.full((stack, 1, d), 0.5, dtype=torch.float32, device=gen.device),
    }


def rwkv_channel_mix(params: dict, x: torch.Tensor, shifted: torch.Tensor) -> torch.Tensor:
    """Squared-ReLU MLP on the token-shift lerp; relu and square in bf16."""
    mix = params["mix"][0].to(x.dtype)
    xk = x * mix + shifted * (1 - mix)
    h = torch.square(torch.relu(xk @ params["wk"]))
    return h @ params["wv"]
