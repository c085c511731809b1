"""The RWKV-6 (Finch) decoder of the port (rwkv6-7b) in plain float32
PyTorch, from the port's layer equations (the configuration file lists
where they depart from the published Finch).

A layer: LayerNorm; the time mix on it and on its previous position (zero
before the first): five lerps ``x_c = h * mix_c + prev * (1 - mix_c)`` for
c = r, k, v, g, w; ``r, k, v = x_c W_c`` split into heads of ``head_size``;
``g = silu(x_g W_g)``; a decay ``w = exp(-exp(x_w W_decay + decay_bias))``;
per head the matrix state S (K x V, zero at the start):
``out_t = r_t (S + diag(u) k_t^T v_t)``, ``S <- diag(w_t) S + k_t^T v_t``;
``(out * g) W_o`` added to the residual. Then LayerNorm and the channel
mix: ``relu(x_k W_k)^2 W_v`` of the lerp of it and its previous position,
added to the residual. A final LayerNorm and the untied head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference import f32_mm
from bench.weights import fan_in_std

_VECTORS = {"w": (1.0, 0.1), "b": (0.0, 0.1), "mix": (0.5, 0.25),
            "decay_bias": (-6.0, 0.5), "bonus": (0.0, 0.5)}
# The time mix's output projection is drawn 32 times narrower than
# N(0, 1/fan_in). The port has no GroupNorm on the wkv output (the published
# Finch's ln_x), so at N(0, 1/fan_in) the time mix adds 20-40 times what the
# channel mix adds, the random model is chaotic in depth, and bf16 parts
# from f32 by 2.2-2.8 logits, as far as fp8 does (6.5-7.3): no comparison
# could tell them apart. At 1/32 each mix adds about 1, as the GroupNorm keeps it.
TIME_MIX_OUT = 1 / 32


def program_fields(c: dict) -> dict:
    """The program's ``ModelConfig`` fields that have to equal the file's
    numbers, by the program's names (the entry compares them)."""
    return {"family": c["family"], "d_model": c["hidden_size"],
            "n_layers": c["num_hidden_layers"], "d_ff": c["intermediate_size"],
            "vocab_size": c["vocab_size"], "rwkv_head_dim": c["head_size"],
            "norm_eps": c["layer_norm_epsilon"], "tie_embeddings": c["tie_word_embeddings"]}


def reduced_file(c: dict, cfg) -> dict:
    """The file ``c`` at a reduced program configuration ``cfg``'s numbers
    (the benchmark's CPU tests)."""
    return dict(c, hidden_size=cfg.d_model, num_hidden_layers=cfg.n_layers,
                intermediate_size=cfg.d_ff, vocab_size=cfg.vocab_size,
                head_size=cfg.rwkv_head_dim, attention_hidden_size=cfg.d_model)


def init_rule(path: tuple, shape: tuple) -> tuple[float, float]:
    if path[-1] in _VECTORS:
        return _VECTORS[path[-1]]
    scale = TIME_MIX_OUT if path[-2:] == ("tm", "wo") else 1.0
    return 0.0, scale * fan_in_std(path, shape)


def _ln(x: torch.Tensor, p: dict, eps: float, i: int | None = None) -> torch.Tensor:
    w, b = (p["w"], p["b"]) if i is None else (p["w"][i], p["b"][i])
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def _prev(h: torch.Tensor) -> torch.Tensor:
    """Each position's previous one along the sequence, zero before the first."""
    return F.pad(h, (0, 0, 1, 0))[:, :-1]


def logits(params: dict, config: dict, tokens: torch.Tensor, mm=f32_mm) -> torch.Tensor:
    """(R, S) token ids from a zero state → (R, S, V) float32 logits."""
    n, d, hs = config["num_hidden_layers"], config["hidden_size"], config["head_size"]
    eps = config["layer_norm_epsilon"]
    r, s = tokens.shape
    nh = d // hs
    lay = params["layers"]
    tm, cm = lay["tm"], lay["cm"]
    x = params["embed"][tokens].float()  # (R, S, d)
    for i in range(n):
        h = _ln(x, lay["tm_norm"], eps, i)
        prev = _prev(h)
        mix = tm["mix"][i].float()
        xr, xk, xv, xg, xw = (h * mix[c] + prev * (1 - mix[c]) for c in range(5))
        rr = mm(xr, tm["wr"][i]).view(r, s, nh, hs)
        kk = mm(xk, tm["wk"][i]).view(r, s, nh, hs)
        vv = mm(xv, tm["wv"][i]).view(r, s, nh, hs)
        gate = mm(xg, tm["wg"][i])
        g = gate * torch.sigmoid(gate)
        w = torch.exp(-torch.exp(mm(xw, tm["w_decay"][i]) + tm["decay_bias"][i].float()))
        w = w.view(r, s, nh, hs)
        u = tm["bonus"][i].float().view(nh, hs, 1)
        state = torch.zeros((r, nh, hs, hs), dtype=torch.float32, device=x.device)
        outs = []
        for t in range(s):
            kv = kk[:, t, :, :, None] * vv[:, t, :, None, :]  # (R, H, K, V)
            outs.append((rr[:, t, :, :, None] * (state + u * kv)).sum(dim=2))
            state = w[:, t, :, :, None] * state + kv
        out = torch.stack(outs, dim=1).reshape(r, s, d)
        x = x + mm(out * g, tm["wo"][i])
        h = _ln(x, lay["cm_norm"], eps, i)
        mix = cm["mix"][i][0].float()
        xk = h * mix + _prev(h) * (1 - mix)
        x = x + mm(torch.relu(mm(xk, cm["wk"][i])).square(), cm["wv"][i])
    x = _ln(x, params["final_norm"], eps)
    return mm(x, params["head"])
