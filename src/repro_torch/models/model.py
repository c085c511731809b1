"""The model facade of the port: the dense, vision-language, MoE, hybrid,
RWKV-6 and encoder-decoder families, for training and serving.

The counterpart of ``repro/models/model.py``'s :class:`Model` for
``family`` ``"dense"``, ``"vlm"`` (the dense trunk; ``forward`` puts the
vision front end's patch embeddings before the tokens and drops their rows
before the head, and the serving path, as the reference's, runs the text
alone from position 0), ``"moe"`` (the MoE MLP in every layer in place
of the dense one), ``"hybrid"`` (Jamba: groups of ``attn_period`` layers,
an attention layer with a dense MLP and then ``attn_period - 1`` Mamba
layers whose MLP is MoE at the even in-group positions and dense at the
odd ones), ``"ssm"`` (RWKV-6: a time mix and a channel mix a layer,
LayerNorm with bias) and ``"encdec"`` (whisper: a non-causal encoder over
audio frames and a decoder with self- and cross-attention, sinusoidal
positions, the GELU MLP, LayerNorm with bias): ``init`` draws seeded
weights like the reference's ``Model.init`` (same tree, shapes, scales and
dtypes; other random numbers), ``forward`` is the full-sequence path and
``loss`` the training objective over it, and ``init_cache`` /
``decode_step`` / ``decode_and_sample`` / ``prefill_chunk`` are the
serving path over a per-slot KV cache, or for ``ssm`` a recurrent
state with no position axis.

Layouts follow the reference so tests compare like with like: parameters
are stacked per layer under a leading ``n_layers`` axis (``hybrid``: per
group, and within a group per Mamba, MoE or dense-MLP layer, as
``groups.mamba`` (g, m, …), ``groups.mamba_moe`` (g, n_moe, …) and
``groups.mamba_mlp`` (g, m − n_moe, …)); the reference's ``lax.scan``
becomes a Python loop over layers, and the cache is
``(n_layers, B, max_len, Hkv, D)`` (``hybrid``: ``k``/``v`` (g, B, max_len,
Hkv, D), ``h`` (g, m, B, d_in, N) f32 and ``conv`` (g, m, B, K, d_in);
``ssm``: ``s`` (n_layers, B, H, K, V) f32, ``shift_tm`` and ``shift_cm``
(n_layers, B, d); ``encdec`` adds the cross-attention's ``xk``/``xv``
(n_layers, B, encoder_seq_len, Hkv, D), which a decode step reads and
never writes; with ``cache_quant="int8"`` the dense, vlm and moe caches
hold int8 ``k``/``v`` and bf16 ``k_scale``/``v_scale`` (n_layers, B,
max_len, Hkv, 1)). Where the reference donates the cache and gets a new
one back, the port updates every leaf in place, at a fixed address, and
returns the same dict.

Over a mesh (DTensor parameters and inputs, ``launch.steps``) every layer
boundary of the trunk and decode loops passes the residual stream through
``distributed.spmd.constrain``, which pins it at the reference's layout;
on plain tensors it is the identity.

``cfg.attn_chunk`` runs full-sequence attention in online-softmax chunks
(``layers.chunked_attention``), and ``cfg.remat`` checkpoints each layer
(``hybrid``: each group) of a full-sequence pass while autograd records
(:func:`_remat`), as the reference's ``jax.checkpoint`` does: it changes
memory, not numbers.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from ..distributed.spmd import constrain
from ..kernels import _build
from ..kernels import ops as kernel_ops
from . import layers as L
from .config import ModelConfig

# the products with no batch dimension, whose outputs remat="dots" keeps: every
# 2-D projection and the MoE router reach aten.mm (a (B, S, d) @ (d, f)
# folds into one); the attention einsums and the MoE experts' products reach
# bmm and are recomputed, as JAX's checkpoint_dots_with_no_batch_dims does
_DOTS = [torch.ops.aten.mm.default]


def _norm(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    if "b" in params:
        return L.layer_norm(x, params["w"], params["b"], eps)
    return L.rms_norm(x, params["w"], eps)


def _sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """Sinusoidal position embeddings (``positions``' shape + (d,)): angles
    in f32, sin and cos concatenated, cast to bf16, as the reference makes
    them."""
    ang = positions[..., None].float() * L.inv_freqs(d, 10_000.0, positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(L.COMPUTE_DTYPE)


def _remat(body, cfg: ModelConfig):
    """The reference's ``_remat`` of a layer body: ``"full"`` keeps only the
    body's inputs and recomputes the rest in the backward
    (``jax.checkpoint``); ``"dots"`` keeps the outputs of the products with
    no batch dimension too (``checkpoint_dots_with_no_batch_dims``), by
    selective checkpointing. Only while autograd records: under
    ``no_grad`` (serving, a graph capture) the body runs as it is."""
    if cfg.remat == "none":
        return body
    context = {} if cfg.remat == "full" else {
        "context_fn": partial(create_selective_checkpoint_contexts, _DOTS)}

    def run(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        return checkpoint(body, *args, use_reentrant=False, **context)

    return run


FAMILIES = ("dense", "vlm", "moe", "hybrid", "ssm", "encdec")


class _MetaGenerator:
    """Stands in for the ``torch.Generator`` of :meth:`Model.init` in
    :meth:`Model.abstract_params`: ``layers._dense_init`` draws nothing on a
    ``meta`` device, and every other leaf is made on this one."""

    device = torch.device("meta")


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _layers(tree: dict, n: int) -> list[dict]:
    """Every layer's parameters, each leaf split by one ``torch.unbind``: the
    same views as :func:`_layer`'s, for the full-sequence paths that
    training differentiates. Under autograd one ``unbind``'s backward is a
    single ``stack`` a leaf, where ``v[i]`` a layer builds a zero tensor the
    size of the whole stack for each layer's gradient and sums ``n`` of
    them."""
    split = {k: _layers(v, n) if isinstance(v, dict) else torch.unbind(v)
             for k, v in tree.items()}
    return [{k: v[i] for k, v in split.items()} for i in range(n)]


class Model:
    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(f"family {cfg.family!r} is not one of the reference's "
                                      f"{FAMILIES}")
        if cfg.family == "hybrid" and (cfg.attn_period < 1 or cfg.n_layers % cfg.attn_period):
            # the reference divides by zero, or drops the layers past the last whole group
            raise ValueError(f"a hybrid's {cfg.n_layers} layers must be whole groups of "
                             f"attn_period={cfg.attn_period} layers")
        self.cfg = cfg
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.cache_has_positions and torch.cuda.is_available():
            # the decode step's attention kernel, compiled while the caller
            # sets up the rest (weights, other kernels), not at the first step
            _build.build_in_background("decode_attention")

    @property
    def cache_has_positions(self) -> bool:
        """Whether the cache has a position axis (a KV cache of ``max_len``
        rows a slot), so a write past ``max_len`` exists; an ``ssm`` state
        has none, and decodes any number of steps."""
        return self.cfg.family != "ssm"

    # ================================================================ params

    def abstract_params(self) -> dict:
        """The tree of :meth:`init` as empty tensors on ``torch.device("meta")``:
        the reference's tree, shapes and dtypes from the shapes alone, with
        nothing drawn (whole jamba-1.5-large-398b is 397,480,591,360
        parameters)."""
        return self._init(_MetaGenerator())

    def init(self, seed: int) -> dict:
        """Seeded weights on ``self.device``, in the reference's tree: the
        MoE family has ``layers.moe`` in place of ``layers.mlp``; ``hybrid``
        has ``groups.{attn_norm, attn, attn_mlp_norm, attn_mlp, mamba_norm,
        mamba, mamba_mlp_norm, mamba_moe, mamba_mlp}`` (:meth:`_hybrid_init`); ``ssm``
        has ``layers.{tm_norm, tm, cm_norm, cm}``; ``encdec`` has
        ``enc_layers.{ln1, attn, ln2, mlp}``, ``enc_final_norm`` and
        ``dec_layers.{ln1, self_attn, ln2, cross_attn, ln3, mlp}``. The
        norms of ``ssm`` and ``encdec`` (their final ones too) are
        LayerNorms with a bias ``b``."""
        return self._init(torch.Generator(device=self.device).manual_seed(seed))

    def _init(self, gen) -> dict:
        cfg = self.cfg
        n, d = cfg.n_layers, cfg.d_model

        def norm(*shape):
            w = {"w": torch.ones(shape, dtype=torch.float32, device=gen.device)}
            if cfg.family in ("ssm", "encdec"):  # LayerNorm with a bias
                w["b"] = torch.zeros(shape, dtype=torch.float32, device=gen.device)
            return w

        params: dict = {
            "embed": L._dense_init(gen, (cfg.vocab_size, d)),
            "final_norm": norm(d),
        }
        if cfg.family == "encdec":
            ne = cfg.n_encoder_layers
            params["enc_layers"] = {
                "ln1": norm(ne, d),
                "attn": L.attention_init(gen, cfg, stack=ne),
                "ln2": norm(ne, d),
                "mlp": L.mlp_init(gen, cfg, stack=ne),
            }
            params["enc_final_norm"] = norm(d)
            params["dec_layers"] = {
                "ln1": norm(n, d),
                "self_attn": L.attention_init(gen, cfg, stack=n),
                "ln2": norm(n, d),
                "cross_attn": L.attention_init(gen, cfg, stack=n),
                "ln3": norm(n, d),
                "mlp": L.mlp_init(gen, cfg, stack=n),
            }
        elif cfg.family == "hybrid":
            params["groups"] = self._hybrid_init(gen, norm)
        elif cfg.family == "ssm":
            params["layers"] = {
                "tm_norm": norm(n, d),
                "tm": L.rwkv_init(gen, cfg, stack=n),
                "cm_norm": norm(n, d),
                "cm": L.rwkv_channel_mix_init(gen, cfg, stack=n),
            }
        else:
            params["layers"] = {
                "attn_norm": norm(n, d),
                "attn": L.attention_init(gen, cfg, stack=n),
                "mlp_norm": norm(n, d),
            }
        if cfg.family == "moe":
            params["layers"]["moe"] = L.moe_init(gen, cfg, stack=n)
        elif cfg.family in ("dense", "vlm"):
            params["layers"]["mlp"] = L.mlp_init(gen, cfg, stack=n)
        if not cfg.tie_embeddings:
            params["head"] = L._dense_init(gen, (d, cfg.vocab_size))
        return params

    def _groups(self) -> tuple[int, int, int]:
        """A hybrid's groups, Mamba layers a group, and MoE layers among
        them (the even in-group positions)."""
        m = self.cfg.attn_period - 1
        return self.cfg.n_layers // self.cfg.attn_period, m, (m + 1) // 2

    def _hybrid_init(self, gen: torch.Generator, norm) -> dict:
        """The hybrid trunk's tree, the reference's ``_hybrid_trunk_init``:
        per group an attention layer and its dense MLP, and the Mamba layers'
        mixers and norms (g, m, …), MoE MLPs (g, n_moe, …) and dense MLPs
        (g, m − n_moe, …). Each nested stack is drawn as one stack of its
        g·count layers (``layers._dense_init``, a part of at most one layer
        at a time; the MoE experts a layer at a time) and viewed as
        (g, count, …)."""
        cfg = self.cfg
        g, m, n_moe = self._groups()
        d = cfg.d_model

        def nested(init, count: int) -> dict:
            tree = init(gen, cfg, stack=max(g * count, 1))  # stack=0 would mean no stack axis
            return {k: v[:g * count].reshape(g, count, *v.shape[1:]) for k, v in tree.items()}

        return {
            "attn_norm": norm(g, d),
            "attn": L.attention_init(gen, cfg, stack=g),
            "attn_mlp_norm": norm(g, d),
            "attn_mlp": L.mlp_init(gen, cfg, stack=g),
            "mamba_norm": norm(g, m, d),
            "mamba": nested(L.mamba_init, m),
            "mamba_mlp_norm": norm(g, m, d),
            "mamba_moe": nested(L.moe_init, n_moe),
            "mamba_mlp": nested(L.mlp_init, m - n_moe),
        }

    def _head(self, params: dict) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["head"]

    # ================================================================= train

    def forward(self, params: dict, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits, moe_aux_loss): the sum of the layers' aux losses,
        zero for the dense, vlm, ssm and encdec families. ``vlm`` takes
        ``batch["frontend_embeds"]`` (B, P, d), cast to bf16 and put before
        the token embeddings: the trunk runs positions 0 … P+S−1 and the P
        prefix rows are dropped after the final norm, so the logits are
        the tokens' (B, S, V)."""
        cfg = self.cfg
        if cfg.family == "encdec":
            return self._forward_encdec(params, batch)
        x = params["embed"][batch["tokens"]]  # (B, S, d)
        prefix = 0
        if cfg.family == "vlm":
            fe = batch["frontend_embeds"].to(x.dtype)  # (B, P, d)
            x = torch.cat([fe, x], dim=1)
            prefix = fe.shape[1]
        x, aux = self.trunk(params, x)
        x = _norm(params["final_norm"], x, cfg.norm_eps)
        logits = x[:, prefix:] @ self._head(params)
        return logits, aux

    def trunk(self, params: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The layers of ``forward`` (not ``encdec``'s) over the embedded
        (B, S, d) ``x``, from ``params["layers"]`` (``hybrid``:
        ``params["groups"]``): (x, the MoE aux loss)."""
        if self.cfg.family == "ssm":
            x = self._rwkv_trunk(params["layers"], x)
            return x, torch.zeros((), dtype=torch.float32, device=x.device)
        if self.cfg.family == "hybrid":
            return self._hybrid_trunk(params["groups"], x)
        return self._uniform_trunk(params["layers"], x)

    def _uniform_trunk(self, trunk: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def body(x, aux, lp):
            x = x + L.attention_apply(
                lp["attn"], cfg, _norm(lp["attn_norm"], x, cfg.norm_eps), positions)
            y, a = self._mlp(lp, x)
            return x + y, aux if a is None else aux + a

        body = _remat(body, cfg)
        x = constrain(x)
        for lp in _layers(trunk, cfg.n_layers):
            x, aux = body(x, aux, lp)
            x = constrain(x)
        return x, aux

    def _hybrid_trunk(self, trunk: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """A group a step: attention and its dense MLP, then each Mamba layer
        and its MLP (MoE at even in-group positions, adding to the aux
        loss); ``cfg.remat`` checkpoints a group, as the reference's
        ``_remat`` of its group body."""
        cfg = self.cfg
        g, m, n_moe = self._groups()
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)

        def body(x, aux, gp):
            x = x + L.attention_apply(
                gp["attn"], cfg, _norm(gp["attn_norm"], x, cfg.norm_eps), positions)
            x = x + L.mlp_apply(gp["attn_mlp"], _norm(gp["attn_mlp_norm"], x, cfg.norm_eps))
            x = constrain(x)
            moes, mlps = _layers(gp["mamba_moe"], n_moe), _layers(gp["mamba_mlp"], m - n_moe)
            mamba = zip(_layers(gp["mamba_norm"], m), _layers(gp["mamba"], m),
                        _layers(gp["mamba_mlp_norm"], m))
            for i, (norm, mixer, mlp_norm) in enumerate(mamba):
                x = x + L.mamba_apply(mixer, cfg, _norm(norm, x, cfg.norm_eps))
                y = _norm(mlp_norm, x, cfg.norm_eps)
                if i % 2 == 0:
                    y, a = L.moe_apply(moes[i // 2], cfg, y)
                    aux = aux + a
                else:
                    y = L.mlp_apply(mlps[i // 2], y)
                x = constrain(x + y)
            return x, aux

        body = _remat(body, cfg)
        x = constrain(x)
        for gp in _layers(trunk, g):
            x, aux = body(x, aux, gp)
        return x, aux

    def _rwkv_trunk(self, trunk: dict, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg

        def body(x, lp):
            x = x + L.rwkv_apply(lp["tm"], cfg, _norm(lp["tm_norm"], x, cfg.norm_eps))
            h = _norm(lp["cm_norm"], x, cfg.norm_eps)
            shifted = F.pad(h, (0, 0, 1, 0))[:, :-1]
            return x + L.rwkv_channel_mix(lp["cm"], h, shifted)

        body = _remat(body, cfg)
        x = constrain(x)
        for lp in _layers(trunk, cfg.n_layers):
            x = constrain(body(x, lp))
        return x

    def encode(self, params: dict, frames: torch.Tensor) -> torch.Tensor:
        """The encoder half of ``encdec``: (B, T, d) frame embeddings (the
        audio front end's output, cast to bf16) plus sinusoidal positions,
        through the non-causal, unrotated encoder layers and
        ``enc_final_norm``; returns (B, T, d) bf16."""
        cfg = self.cfg
        x = frames.to(L.COMPUTE_DTYPE)
        x = x + _sinusoidal(torch.arange(x.shape[1], device=x.device), cfg.d_model)[None]

        def body(x, lp):
            x = x + L.attention_apply(lp["attn"], cfg, _norm(lp["ln1"], x, cfg.norm_eps), None,
                                      causal=False, use_rope=False)
            return x + L.mlp_apply(lp["mlp"], _norm(lp["ln2"], x, cfg.norm_eps))

        body = _remat(body, cfg)
        x = constrain(x)
        for lp in _layers(params["enc_layers"], cfg.n_encoder_layers):
            x = constrain(body(x, lp))
        return _norm(params["enc_final_norm"], x, cfg.norm_eps)

    def cross_kv(self, params: dict, enc: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The decoder's cross-attention K and V of the encoder output
        ``enc`` (B, T, d): each layer's ``cross_attn.wk``/``wv`` applied to
        it, as the reference's ``forward`` computes them inside
        ``attention_apply(..., kv=enc)``. Returns (xk, xv), each
        (n_layers, B, T, Hkv, D) bf16: window ``i``'s ``(xk[:, i], xv[:, i])``
        is what a request carries (``serving.Request.cross_kv``) and the
        engine writes into its slot (``init_cache`` gives zeros, and the
        reference has no function that fills them)."""
        cfg = self.cfg
        ca = params["dec_layers"]["cross_attn"]

        def heads(w: torch.Tensor) -> torch.Tensor:
            return torch.stack([L._split_heads(enc @ w[i], cfg.n_kv_heads)
                                for i in range(cfg.n_layers)])

        return heads(ca["wk"]), heads(ca["wv"])

    def _forward_encdec(self, params: dict, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """``batch``: ``frontend_embeds`` (B, T, d) and ``tokens`` (B, S). The
        encoder, then the decoder: causal self-attention and
        cross-attention to the encoder output, both unrotated, over token
        embeddings plus sinusoidal positions."""
        cfg = self.cfg
        enc = self.encode(params, batch["frontend_embeds"])
        x = params["embed"][batch["tokens"]]
        x = x + _sinusoidal(torch.arange(x.shape[1], device=x.device), cfg.d_model)[None]

        def body(x, lp):
            x = x + L.attention_apply(lp["self_attn"], cfg, _norm(lp["ln1"], x, cfg.norm_eps),
                                      None, use_rope=False)
            x = x + L.attention_apply(lp["cross_attn"], cfg, _norm(lp["ln2"], x, cfg.norm_eps),
                                      None, causal=False, use_rope=False, kv=enc)
            return x + L.mlp_apply(lp["mlp"], _norm(lp["ln3"], x, cfg.norm_eps))

        body = _remat(body, cfg)
        x = constrain(x)
        for lp in _layers(params["dec_layers"], cfg.n_layers):
            x = constrain(body(x, lp))
        x = _norm(params["final_norm"], x, cfg.norm_eps)
        return x @ self._head(params), torch.zeros((), dtype=torch.float32, device=x.device)

    def loss(self, params: dict, batch: dict) -> tuple[torch.Tensor, dict]:
        """Next-token cross-entropy plus 1e-4 · mean(logz²) plus 0.01 · the
        MoE aux loss: ``(total, {"ce", "zloss", "moe_aux"})``, each a 0-d
        float32 tensor, as the reference's ``loss``. ``batch["labels"]``
        (B, S) holds the gold ids. The logits are cast to float32 and logz
        is a logsumexp over the vocabulary. The gold logit is gathered
        (``take_along_dim``): the reference's masked sum over the
        vocabulary, which keeps the vocabulary axis sharded under GSPMD,
        adds ±0 to it everywhere else, so on finite logits the two are
        equal, and the gather makes no (B, S, V) mask."""
        logits, aux = self.forward(params, batch)
        labels = batch["labels"].long()
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
        ce = torch.mean(logz - gold)
        zloss = 1e-4 * torch.mean(torch.square(logz))
        total = ce + zloss + 0.01 * aux
        return total, {"ce": ce, "zloss": zloss, "moe_aux": aux}

    def _mlp(self, lp: dict, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor | None]:
        """The layer's MLP on ``x`` after its norm: (output, MoE aux loss or None)."""
        y = _norm(lp["mlp_norm"], x, self.cfg.norm_eps)
        if "moe" in lp:
            return L.moe_apply(lp["moe"], self.cfg, y)
        return L.mlp_apply(lp["mlp"], y), None

    # ================================================================= serve

    def input_specs(self, batch_size: int, seq_len: int) -> dict:
        """Stand-ins on ``torch.device("meta")`` for one training batch:
        int32 ``tokens`` and ``labels`` (B, S), and for ``vlm`` and ``encdec``
        the bf16 ``frontend_embeds`` (B, frontend_tokens or
        encoder_seq_len, d), as the reference's."""
        cfg = self.cfg
        meta = torch.device("meta")
        specs = {key: torch.empty((batch_size, seq_len), dtype=torch.int32, device=meta)
                 for key in ("tokens", "labels")}
        rows = {"vlm": cfg.frontend_tokens, "encdec": cfg.encoder_seq_len}.get(cfg.family)
        if rows is not None:
            specs["frontend_embeds"] = torch.empty((batch_size, rows, cfg.d_model),
                                                   dtype=L.COMPUTE_DTYPE, device=meta)
        return specs

    def init_cache(self, batch_size: int, max_len: int, concrete: bool = True) -> dict:
        """Zeros: a KV cache of ``max_len`` rows a slot, or for ``ssm`` the
        recurrent state, whose size does not depend on ``max_len``. For
        ``encdec`` also the cross-attention's ``xk``/``xv`` of
        ``encoder_seq_len`` rows a slot, zeros as the reference's are: the
        serving engine writes each request's window into its slot
        (:meth:`cross_kv`). With ``cache_quant="int8"``, the dense, vlm and
        moe caches hold int8 ``k``/``v`` and bf16 ``k_scale``/``v_scale`` of
        one column; ``encdec``'s stays bf16, as the reference ignores
        ``cache_quant`` there. ``hybrid``'s holds bf16 ``k``/``v`` a group
        and the Mamba layers' f32 ``h`` and bf16 ``conv`` window: the
        reference's attention quantizes only a cache with ``k_scale``, and
        its hybrid cache has none, so ``cache_quant`` changes nothing there
        either. ``concrete=False`` gives the same tree on
        ``torch.device("meta")``, nothing allocated."""
        cfg = self.cfg
        dev = self.device if concrete else torch.device("meta")
        if cfg.family == "hybrid":
            g, m, _ = self._groups()
            d_in, hd = cfg.ssm_expand * cfg.d_model, cfg.head_dim_
            kv = (g, batch_size, max_len, cfg.n_kv_heads, hd)
            return {
                "k": torch.zeros(kv, dtype=L.COMPUTE_DTYPE, device=dev),
                "v": torch.zeros(kv, dtype=L.COMPUTE_DTYPE, device=dev),
                "h": torch.zeros((g, m, batch_size, d_in, cfg.ssm_state_dim),
                                 dtype=torch.float32, device=dev),
                "conv": torch.zeros((g, m, batch_size, cfg.ssm_conv_dim, d_in),
                                    dtype=L.COMPUTE_DTYPE, device=dev),
            }
        if cfg.family == "ssm":
            n, hd = cfg.n_layers, cfg.rwkv_head_dim
            return {
                "s": torch.zeros((n, batch_size, cfg.d_model // hd, hd, hd),
                                 dtype=torch.float32, device=dev),
                "shift_tm": torch.zeros((n, batch_size, cfg.d_model), dtype=L.COMPUTE_DTYPE,
                                        device=dev),
                "shift_cm": torch.zeros((n, batch_size, cfg.d_model), dtype=L.COMPUTE_DTYPE,
                                        device=dev),
            }
        quant = cfg.cache_quant == "int8" and cfg.family != "encdec"
        kv_dtype = torch.int8 if quant else L.COMPUTE_DTYPE
        leaves = {"k": (max_len, cfg.head_dim_, kv_dtype), "v": (max_len, cfg.head_dim_, kv_dtype)}
        if quant:
            leaves.update(k_scale=(max_len, 1, L.COMPUTE_DTYPE),
                          v_scale=(max_len, 1, L.COMPUTE_DTYPE))
        if cfg.family == "encdec":
            window = (cfg.encoder_seq_len, cfg.head_dim_, L.COMPUTE_DTYPE)
            leaves.update(xk=window, xv=window)
        return {key: torch.zeros((cfg.n_layers, batch_size, t, cfg.n_kv_heads, width),
                                 dtype=dtype, device=dev)
                for key, (t, width, dtype) in leaves.items()}

    def decode_step(
        self, params: dict, cache: dict, tokens: torch.Tensor, pos,
        update_mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, dict]:
        """One new token per sequence. tokens: (B, 1); pos: an int or 0-d
        tensor (every slot at one position), or a (B,) int32 vector for
        continuous batching (per-slot positions). A tensor on the model's
        device is used as it is, with no copy from the host, so a CUDA graph
        can replay the step while the card advances the position. Returns
        ``(logits, cache)`` with (B, 1, V) logits and ``cache`` updated in
        place.

        ``update_mask`` (optional, (B,) bool) freezes the cache rows of
        unselected batch entries: masked-out slots still compute, and their
        cache state comes out bit-identical to what went in. They compute
        the reference's numbers: the reference writes every row's K/V,
        attends with it and then restores the masked rows (its
        ``_masked_cache``); the port writes only the selected rows
        (``layers.masked_cache_write``) and lets every row attend with its
        own K/V at its position (``layers.attention_apply``). A masked row's
        logits are no caller's output, but under MoE its hidden state
        competes with the live rows for expert capacity, so the live rows'
        logits depend on it. A row whose position lies past ``max_len``
        attends to the cache as it is (XLA drops that write), and may be
        asked for only under a mask that leaves it out.

        ``ssm`` reads the position only to tell a slot's first token: a row
        at position 0 starts from a zero state, whatever its slot holds (a
        freed slot keeps its last request's state; the reference reads that
        state on, ROADMAP.md Queue 3). Each layer's state leaves then take
        the new rows where ``update_mask`` selects (:meth:`_masked_cache`),
        so a masked row keeps its bits at any position. ``hybrid`` does the
        same for its Mamba layers' ``h`` and ``conv``, beside the KV cache of
        its attention layers.

        ``encdec`` adds sinusoidal positions at each slot's position, runs
        unrotated self-attention on ``k``/``v`` as above and
        cross-attention over all of ``xk``/``xv``, which it reads in place
        (``layers.cross_attend``) and never writes or copies (the reference
        passes them through; a copy would move more bytes than the rest of
        the step)."""
        x = params["embed"][tokens]  # (B, 1, d)
        if self.cfg.family == "ssm":
            fresh = torch.as_tensor(pos, device=x.device) == 0
            x = self._rwkv_decode(params["layers"], cache, x, fresh, update_mask)
        else:
            b = x.shape[0]
            pos = torch.as_tensor(pos, device=x.device)
            if pos.dim() == 0:
                pos = pos.expand(b)
            if self.cfg.family == "encdec":
                x = x + _sinusoidal(pos[:, None], self.cfg.d_model)
                x = self._encdec_decode(params["dec_layers"], cache, x, pos, update_mask)
            elif self.cfg.family == "hybrid":
                x = self._hybrid_decode(params["groups"], cache, x, pos, update_mask)
            else:
                x = self._uniform_decode(params["layers"], cache, x, pos, update_mask)
        x = _norm(params["final_norm"], x, self.cfg.norm_eps)
        return x @ self._head(params), cache

    def decode_and_sample(
        self, params: dict, cache: dict, prev_tokens: torch.Tensor,
        token_overrides: torch.Tensor, override_mask: torch.Tensor, pos,
        update_mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, dict]:
        """Fused decode step + greedy sampling: the launch returns ``(B, 1)``
        int32 token ids instead of ``(B, vocab)`` logits, so the host's
        per-step sync point shrinks from the full logits tensor to a few
        bytes — and, because the sampled ids never leave the device, the
        next launch's input tokens are device-resident state rather than a
        descriptor field. The host injects tokens only through
        ``token_overrides``/``override_mask`` (admissions, freed slots),
        which elide in steady-state decode.

        ``prev_tokens``: (B, 1) device-resident ids from the previous step;
        ``token_overrides``: (B,) int32 host injections where
        ``override_mask`` (B, bool) is set.

        The reference's ``sample_backend`` argument is gone: sampling runs
        the hand-written kernel on a CUDA tensor and its plain version on a
        CPU tensor (``kernels.ops.sample_op``), and nothing else."""
        tokens = torch.where(override_mask[:, None],
                             token_overrides[:, None].to(torch.int32), prev_tokens)
        logits, cache = self.decode_step(params, cache, tokens, pos, update_mask)
        ids = kernel_ops.sample_op(logits[:, 0])
        return ids[:, None], cache

    def prefill_chunk(
        self, params: dict, cache: dict, chunk_tokens: torch.Tensor,
        pos0: torch.Tensor, n_valid: torch.Tensor, slot_mask: torch.Tensor,
    ) -> tuple[torch.Tensor, dict]:
        """Batched prefill: advance only the slots in ``slot_mask`` through
        up to ``len(chunk_tokens)`` prompt tokens in **one launch** — a loop
        of masked decode steps, so a p-token prompt costs ``ceil(p/chunk)``
        launches instead of p full-batch launches.

        ``chunk_tokens``: (T,) int32, valid through ``n_valid`` (padded
        steps are fully masked — no slot advances); ``pos0``: (B,) int32
        per-slot start positions (step i writes at ``pos0 + i``);
        ``slot_mask``: (B,) bool selecting the admitted slot(s). Returns
        ``(probe, cache)`` where probe is the (B, 1) int32 argmax of the
        last valid step for the masked slots (a few-byte sync handle for
        the staging ring; zeros for unmasked slots)."""
        b = slot_mask.shape[0]
        probe = torch.zeros((b, 1), dtype=torch.int32, device=slot_mask.device)
        toks = chunk_tokens.to(torch.int32)
        for i in range(toks.shape[0]):
            step_mask = slot_mask & (i < n_valid)
            logits, cache = self.decode_step(
                params, cache, toks[i].expand(b, 1), pos0 + i, step_mask)
            ids = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
            probe = torch.where(step_mask[:, None], ids[:, None], probe)
        return probe, cache

    def _uniform_decode(self, trunk: dict, cache: dict, x: torch.Tensor,
                        pos: torch.Tensor, update_mask: torch.Tensor | None) -> torch.Tensor:
        cfg = self.cfg
        positions = pos[:, None]
        x = constrain(x)
        for i in range(cfg.n_layers):
            lp = _layer(trunk, i)
            layer_cache = {key: leaf[i] for key, leaf in cache.items()}  # views
            x = x + L.attention_apply(
                lp["attn"], cfg, _norm(lp["attn_norm"], x, cfg.norm_eps), positions,
                cache=layer_cache, cache_pos=pos, update_mask=update_mask)
            x = constrain(x + self._mlp(lp, x)[0])
        return x

    def _hybrid_decode(self, trunk: dict, cache: dict, x: torch.Tensor, pos: torch.Tensor,
                       update_mask: torch.Tensor | None) -> torch.Tensor:
        """The hybrid trunk for one token: each group's attention over its
        KV cache, then its Mamba layers' steps. The steps read a copy of
        ``h`` and ``conv``, zero on the rows at position 0 (on the card: no
        read-back), made in one pass over all layers; the rows they write
        go to the cache itself."""
        cfg = self.cfg
        g, m, _ = self._groups()
        fresh = (pos == 0).view(1, 1, -1, 1, 1)
        state = {key: torch.where(fresh, 0.0, cache[key]) for key in ("h", "conv")}
        x = constrain(x)
        for gi in range(g):
            gp = _layer(trunk, gi)
            layer_cache = {"k": cache["k"][gi], "v": cache["v"][gi]}  # views
            x = x + L.attention_apply(
                gp["attn"], cfg, _norm(gp["attn_norm"], x, cfg.norm_eps), pos[:, None],
                cache=layer_cache, cache_pos=pos, update_mask=update_mask)
            x = constrain(
                x + L.mlp_apply(gp["attn_mlp"], _norm(gp["attn_mlp_norm"], x, cfg.norm_eps)))
            for i in range(m):
                h = _norm(_layer(gp["mamba_norm"], i), x, cfg.norm_eps)
                y, st = L.mamba_step(_layer(gp["mamba"], i), cfg, h,
                                     {"h": state["h"][gi, i], "conv": state["conv"][gi, i]})
                x = x + y
                self._masked_cache(cache, st, update_mask, (gi, i))
                y = _norm(_layer(gp["mamba_mlp_norm"], i), x, cfg.norm_eps)
                if i % 2 == 0:
                    y = L.moe_apply(_layer(gp["mamba_moe"], i // 2), cfg, y)[0]
                else:
                    y = L.mlp_apply(_layer(gp["mamba_mlp"], i // 2), y)
                x = constrain(x + y)
        return x

    def _encdec_decode(self, trunk: dict, cache: dict, x: torch.Tensor, pos: torch.Tensor,
                       update_mask: torch.Tensor | None) -> torch.Tensor:
        cfg = self.cfg
        b = x.shape[0]
        x = constrain(x)
        for i in range(cfg.n_layers):
            lp = _layer(trunk, i)
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}  # views
            x = x + L.attention_apply(
                lp["self_attn"], cfg, _norm(lp["ln1"], x, cfg.norm_eps), None, use_rope=False,
                cache=layer_cache, cache_pos=pos, update_mask=update_mask)
            # cross-attention against the slot's encoder K/V, read in place
            h = _norm(lp["ln2"], x, cfg.norm_eps)
            q = L._split_heads(h @ lp["cross_attn"]["wq"], cfg.n_heads)
            o = L.cross_attend(q, cache["xk"][i], cache["xv"][i])
            x = x + o.reshape(b, 1, -1) @ lp["cross_attn"]["wo"]
            x = constrain(x + L.mlp_apply(lp["mlp"], _norm(lp["ln3"], x, cfg.norm_eps)))
        return x

    def _rwkv_decode(self, trunk: dict, cache: dict, x: torch.Tensor, fresh: torch.Tensor,
                     update_mask: torch.Tensor | None) -> torch.Tensor:
        """The RWKV trunk for one token. ``shift_tm`` takes the time mix's
        normed input and ``shift_cm`` the channel mix's. The step reads a
        copy of the state, zero on the rows ``fresh`` ((B,) or 0-d bool,
        on the card: no read-back) selects, made in one pass over all
        layers; the rows it writes go to the cache itself."""
        cfg = self.cfg
        fresh = fresh.reshape(-1, 1)
        state = {"s": torch.where(fresh[..., None, None], 0.0, cache["s"]),
                 "shift_tm": torch.where(fresh, 0.0, cache["shift_tm"]),
                 "shift_cm": torch.where(fresh, 0.0, cache["shift_cm"])}
        x = constrain(x)
        for i in range(cfg.n_layers):
            lp = _layer(trunk, i)
            h = _norm(lp["tm_norm"], x, cfg.norm_eps)
            y, st = L.rwkv_step(lp["tm"], cfg, h, {"s": state["s"][i],
                                                  "shift": state["shift_tm"][i]})
            x = x + y
            h = _norm(lp["cm_norm"], x, cfg.norm_eps)
            x = constrain(x + L.rwkv_channel_mix(lp["cm"], h[:, 0], state["shift_cm"][i])[:, None])
            self._masked_cache(cache, {"s": st["s"], "shift_tm": st["shift"],
                                       "shift_cm": h[:, 0]}, update_mask, i)
        return x

    @staticmethod
    def _masked_cache(cache: dict, new: dict, update_mask: torch.Tensor | None,
                      layer: int | tuple[int, int]) -> None:
        """The reference's per-leaf batch-row select, in place: layer
        ``layer`` of each leaf named in ``new`` takes its rows where
        ``update_mask`` is True (every row without a mask), and the other
        rows keep their bits. ``layer`` indexes the leading axes: a layer of
        an ``ssm`` leaf, or (group, Mamba layer) of a hybrid's ``h`` and
        ``conv``, whose batch axis is 2 where the layer axis leads the
        others'; the layer's view has the batch on axis 0 either way.
        ``copy_`` keeps the leaf's address, so a CUDA graph replay reads the
        state the last step wrote."""
        for key, rows in new.items():
            buf = cache[key][layer]
            if update_mask is not None:
                rows = torch.where(update_mask.view(-1, *[1] * (rows.dim() - 1)), rows, buf)
            buf.copy_(rows)
