"""The model facade of the port: the dense family, for serving.

The counterpart of ``repro/models/model.py``'s :class:`Model` for
``family == "dense"``: ``init`` draws seeded weights like the reference's
``Model.init`` (same tree, shapes, scales and dtypes; other random numbers),
``forward`` is the full-sequence path, and ``init_cache`` /
``decode_step`` / ``decode_and_sample`` / ``prefill_chunk`` are the serving
path over a per-slot KV cache.

Layouts follow the reference so tests compare like with like: parameters
are stacked per layer under a leading ``n_layers`` axis (the reference's
``lax.scan`` becomes a Python loop over layers), and the cache is
``(n_layers, B, max_len, Hkv, D)``. Where the reference donates the cache
and gets a new one back, the port updates it in place and returns the same
dict.
"""

from __future__ import annotations

import torch

from ..kernels import ops as kernel_ops
from . import layers as L
from .config import ModelConfig


def _norm(params: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    if "b" in params:
        return L.layer_norm(x, params["w"], params["b"], eps)
    return L.rms_norm(x, params["w"], eps)


def _layer(tree: dict, i: int) -> dict:
    """Layer ``i``'s parameters: views into the stacked tree."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


class Model:
    def __init__(self, cfg: ModelConfig, device: str | torch.device = "cuda"):
        if cfg.family != "dense" or cfg.mlp_kind != "swiglu":
            raise NotImplementedError(
                f"family {cfg.family!r} ({cfg.mlp_kind} MLP) is not ported: "
                f"ROADMAP.md Queue 1, item 6 (the other model families)")
        if cfg.cache_quant != "none" or cfg.attn_chunk:
            raise NotImplementedError(
                "int8 KV and chunked attention are not ported: ROADMAP.md "
                "Queue 1, item 5")
        self.cfg = cfg
        self.device = torch.device(device)

    # ================================================================ params

    def init(self, seed: int) -> dict:
        """Seeded weights on ``self.device``, in the reference's tree."""
        cfg = self.cfg
        gen = torch.Generator(device=self.device).manual_seed(seed)
        n, d = cfg.n_layers, cfg.d_model

        def ones(*shape):
            return torch.ones(shape, dtype=torch.float32, device=self.device)

        params: dict = {
            "embed": L._dense_init(gen, (cfg.vocab_size, d)),
            "final_norm": {"w": ones(d)},
            "layers": {
                "attn_norm": {"w": ones(n, d)},
                "attn": L.attention_init(gen, cfg, stack=n),
                "mlp_norm": {"w": ones(n, d)},
                "mlp": L.mlp_init(gen, cfg, stack=n),
            },
        }
        if not cfg.tie_embeddings:
            params["head"] = L._dense_init(gen, (d, cfg.vocab_size))
        return params

    def _head(self, params: dict) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["head"]

    # ================================================================= train

    def forward(self, params: dict, batch: dict) -> tuple[torch.Tensor, torch.Tensor]:
        """Returns (logits, moe_aux_loss); the dense family has no aux loss."""
        cfg = self.cfg
        x = params["embed"][batch["tokens"]]  # (B, S, d)
        b, s, _ = x.shape
        positions = torch.arange(s, device=x.device).expand(b, s)
        for i in range(cfg.n_layers):
            lp = _layer(params["layers"], i)
            x = x + L.attention_apply(
                lp["attn"], cfg, _norm(lp["attn_norm"], x, cfg.norm_eps), positions)
            x = x + L.mlp_apply(lp["mlp"], _norm(lp["mlp_norm"], x, cfg.norm_eps))
        x = _norm(params["final_norm"], x, cfg.norm_eps)
        logits = x @ self._head(params)
        return logits, torch.zeros((), dtype=torch.float32, device=x.device)

    # ================================================================= serve

    def init_cache(self, batch_size: int, max_len: int) -> dict:
        cfg = self.cfg
        shape = (cfg.n_layers, batch_size, max_len, cfg.n_kv_heads, cfg.head_dim_)
        return {
            "k": torch.zeros(shape, dtype=L.COMPUTE_DTYPE, device=self.device),
            "v": torch.zeros(shape, dtype=L.COMPUTE_DTYPE, device=self.device),
        }

    def decode_step(
        self, params: dict, cache: dict, tokens: torch.Tensor, pos,
        update_mask: torch.Tensor | None = None,
    ) -> tuple[torch.Tensor, dict]:
        """One new token per sequence. tokens: (B, 1); pos: an int or 0-d
        tensor (every slot at one position), or a (B,) int32 vector for
        continuous batching (per-slot positions). Returns ``(logits, cache)``
        with (B, 1, V) logits and ``cache`` updated in place.

        ``update_mask`` (optional, (B,) bool) freezes the cache rows of
        unselected batch entries: masked-out slots still compute (their
        logits are garbage to be discarded) but their cache state comes out
        bit-identical to what went in. The reference merges old and new
        cache after the step (its ``_masked_cache``); the port writes only
        the selected rows (``layers.masked_cache_write``), so rows past
        ``max_len`` may be asked for only under a mask that leaves them out."""
        x = params["embed"][tokens]  # (B, 1, d)
        b = x.shape[0]
        pos = torch.as_tensor(pos, device=x.device)
        if pos.dim() == 0:
            pos = pos.expand(b)
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
        for i in range(cfg.n_layers):
            lp = _layer(trunk, i)
            layer_cache = {"k": cache["k"][i], "v": cache["v"][i]}  # views
            x = x + L.attention_apply(
                lp["attn"], cfg, _norm(lp["attn_norm"], x, cfg.norm_eps), positions,
                cache=layer_cache, cache_pos=pos, update_mask=update_mask)
            x = x + L.mlp_apply(lp["mlp"], _norm(lp["mlp_norm"], x, cfg.norm_eps))
        return x
