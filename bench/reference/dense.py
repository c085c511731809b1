"""The dense decoder (phi4-mini-3.8b) in plain float32 PyTorch.

Pre-norm layers: RMSNorm, grouped-query attention with rotary position
embedding (rotate-half over every dimension of a head, theta from the
configuration), causal over the sequence, an output projection, then
RMSNorm and the SwiGLU MLP ``(silu(h Wg) * (h Wi)) Wo``; a final RMSNorm
and the head (the embedding's transpose when tied). Parameters are read by
the names of the tree the benchmark drew; every product goes through ``mm``
(``reference.f32_mm``, or the control's ``fp8_mm``).
"""

from __future__ import annotations

import math

import torch

from bench.reference import f32_mm
from bench.weights import fan_in_std


def program_fields(c: dict) -> dict:
    """The program's ``ModelConfig`` fields that have to equal the file's
    numbers, by the program's names (the entry compares them)."""
    return {"family": c["family"], "d_model": c["hidden_size"],
            "n_layers": c["num_hidden_layers"], "d_ff": c["intermediate_size"],
            "vocab_size": c["vocab_size"], "n_heads": c["num_attention_heads"],
            "n_kv_heads": c["num_key_value_heads"], "head_dim_": c["head_dim"],
            "tie_embeddings": c["tie_word_embeddings"], "norm_eps": c["rms_norm_eps"],
            "rope_theta": c["rope_theta"]}


def reduced_file(c: dict, cfg) -> dict:
    """The file ``c`` at a reduced program configuration ``cfg``'s numbers
    (the benchmark's CPU tests)."""
    return dict(c, hidden_size=cfg.d_model, num_hidden_layers=cfg.n_layers,
                intermediate_size=cfg.d_ff, vocab_size=cfg.vocab_size,
                num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads,
                head_dim=cfg.head_dim_)


def init_rule(path: tuple, shape: tuple) -> tuple[float, float]:
    if path[-1] == "w":  # an RMSNorm's weight
        return 1.0, 0.1
    return 0.0, fan_in_std(path, shape)


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def _rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def logits(params: dict, config: dict, tokens: torch.Tensor, mm=f32_mm) -> torch.Tensor:
    """(R, S) token ids at positions 0 .. S-1 → (R, S, V) float32 logits."""
    n, hq, hkv = (config[k] for k in ("num_hidden_layers", "num_attention_heads",
                                      "num_key_value_heads"))
    hd, eps = config["head_dim"], config["rms_norm_eps"]
    r, s = tokens.shape
    dev = tokens.device
    inv = config["rope_theta"] ** (-torch.arange(0, hd, 2, dtype=torch.float64) / hd)
    ang = (torch.arange(s, dtype=torch.float64)[:, None] * inv[None]).to(dev)
    cos, sin = ang.cos().float()[:, None], ang.sin().float()[:, None]  # (S, 1, hd/2)
    causal = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    lay = params["layers"]
    x = params["embed"][tokens].float()  # (R, S, d)
    for i in range(n):
        h = _rms(x, lay["attn_norm"]["w"][i], eps)
        q = _rotate(mm(h, lay["attn"]["wq"][i]).view(r, s, hq, hd), cos, sin)
        k = _rotate(mm(h, lay["attn"]["wk"][i]).view(r, s, hkv, hd), cos, sin)
        v = mm(h, lay["attn"]["wv"][i]).view(r, s, hkv, hd)
        k = k.repeat_interleave(hq // hkv, dim=2)  # query head j reads K/V head j // (hq/hkv)
        v = v.repeat_interleave(hq // hkv, dim=2)
        scores = torch.einsum("rshd,rthd->rhst", q, k) / math.sqrt(hd)
        probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        o = torch.einsum("rhst,rthd->rshd", probs, v).reshape(r, s, hq * hd)
        x = x + mm(o, lay["attn"]["wo"][i])
        h = _rms(x, lay["mlp_norm"]["w"][i], eps)
        gate = mm(h, lay["mlp"]["wg"][i])
        x = x + mm(gate * torch.sigmoid(gate) * mm(h, lay["mlp"]["wi"][i]), lay["mlp"]["wo"][i])
    x = _rms(x, params["final_norm"]["w"], eps)
    head = params["embed"].T if config["tie_word_embeddings"] else params["head"]
    return mm(x, head)
