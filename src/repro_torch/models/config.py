"""Model configuration schema for the architecture pool.

One :class:`ModelConfig` instance per assigned architecture lives in
``repro_torch.configs.<id>``; reduced variants for CPU smoke tests come from
:meth:`ModelConfig.reduced`.
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | hybrid | ssm | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_period: int = 1  # MoE MLP every k-th layer (Jamba: 2), dense otherwise

    # hybrid (Jamba): one attention layer per `attn_period` layers, rest Mamba
    attn_period: int = 0  # 0 = pure-attention (or pure-SSM for family=ssm)

    # MLP flavour: swiglu (3 matrices) or gelu (2 matrices, whisper-style)
    mlp_kind: str = "swiglu"

    # SSM / RWKV
    ssm_state_dim: int = 16
    ssm_conv_dim: int = 4
    ssm_expand: int = 2
    rwkv_head_dim: int = 64

    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_seq_len: int = 1500  # 30 s of audio at 50 Hz after the conv stub

    # modality frontends are STUBS per the assignment: input_specs() provides
    # precomputed frame/patch embeddings of this many positions
    frontend: str = ""  # "" | "audio_stub" | "vision_stub"
    frontend_tokens: int = 0

    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # training-time knobs (hillclimbed in §Perf)
    remat: str = "full"  # none | full | dots
    scan_unroll: bool = False  # unroll layer scans (dry-run: exact HLO costs)
    notes: str = ""

    # ---- distribution policy (hillclimb levers, EXPERIMENTS.md §Perf) ----
    tp_attention: bool = True  # model-shard attention projections
    pure_dp: bool = False  # replicate params; batch over every mesh axis
    fsdp: bool = False  # additionally shard params along the data axis
    grad_compression: str = "none"  # none | bf16 (cross-data reduce dtype)
    cache_shard_seq: bool = False  # decode KV cache: shard the seq dim (TP)
    attn_chunk: int = 0  # 0 = vanilla attention; >0 = online-softmax chunks
    moe_impl: str = "gspmd"  # gspmd (sort+scatter) | shard_map (explicit a2a EP)
    cache_quant: str = "none"  # none | int8 (per-token-head scaled KV cache)
    ssm_chunk: int = 0  # 0 = one associative scan over S; >0 = chunked SSD-style

    # ---------------------------------------------------------------- props

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_groups(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic (SSM/hybrid/linear-attention) archs run long_500k."""
        return self.family in ("ssm", "hybrid")

    @property
    def has_decoder(self) -> bool:
        return True  # every assigned arch has an autoregressive decode path

    def n_attn_layers(self) -> int:
        if self.family == "ssm":
            return 0
        if self.family == "hybrid" and self.attn_period:
            return self.n_layers // self.attn_period
        return self.n_layers

    def n_ssm_layers(self) -> int:
        if self.family == "ssm":
            return self.n_layers
        if self.family == "hybrid" and self.attn_period:
            return self.n_layers - self.n_attn_layers()
        return 0

    # ------------------------------------------------------------- counting

    def n_moe_layers(self) -> int:
        if self.n_experts == 0:
            return 0
        return self.n_layers // self.moe_period

    def param_count(self) -> int:
        """Total parameters (embeddings + trunk), used for 6·N·D."""
        d, ff, v = self.d_model, self.d_ff, self.vocab_size
        hd, hq, hkv = self.head_dim_, self.n_heads, self.n_kv_heads
        emb = v * d * (1 if self.tie_embeddings else 2)
        attn = d * hq * hd + 2 * d * hkv * hd + hq * hd * d  # q,k,v,o
        mats = 3 if self.mlp_kind == "swiglu" else 2
        dense_mlp = mats * d * ff
        moe_mlp = self.n_experts * mats * d * ff + d * self.n_experts
        ssm = self._ssm_params()
        norms = 2 * d

        total = emb
        n_attn, n_ssm = self.n_attn_layers(), self.n_ssm_layers()
        if self.family == "encdec":
            enc = self.n_encoder_layers * (attn + dense_mlp + norms)
            dec = self.n_layers * (2 * attn + dense_mlp + 3 * d)  # + cross-attn
            return total + enc + dec
        if self.family == "ssm":
            return total + self.n_layers * (ssm + dense_mlp + norms)
        # dense / vlm / moe / hybrid: per-layer mixer + per-layer MLP
        n_moe = self.n_moe_layers()
        n_dense_mlp = self.n_layers - n_moe
        total += n_attn * attn + n_ssm * ssm + self.n_layers * norms
        total += n_moe * moe_mlp + n_dense_mlp * dense_mlp
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k experts only)."""
        if self.n_experts == 0:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        mats = 3 if self.mlp_kind == "swiglu" else 2
        k = self.experts_per_token
        per_layer_active = k * mats * d * ff + d * self.n_experts
        per_layer_total = self.n_experts * mats * d * ff + d * self.n_experts
        return self.param_count() - self.n_moe_layers() * (
            per_layer_total - per_layer_active
        )

    def _ssm_params(self) -> int:
        d = self.d_model
        if self.family == "ssm":  # RWKV6 time-mix block
            return 4 * d * d + 6 * d  # r,k,v,o + decay/mix vectors
        d_in = self.ssm_expand * d  # Mamba block
        return (
            2 * d * d_in  # in_proj (x, z)
            + d_in * self.ssm_conv_dim
            + d_in * (2 * self.ssm_state_dim + 1)  # x -> B, C, dt
            + d_in  # dt bias + A diag + D
            + d_in * d  # out_proj
        )

    # ------------------------------------------------------------- variants

    def reduced(self) -> "ModelConfig":
        """A tiny same-family config for CPU smoke tests."""
        return replace(
            self,
            n_layers=max(2, (self.attn_period or 2)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) or 2,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            n_experts=min(self.n_experts, 4),
            experts_per_token=min(self.experts_per_token, 2),
            n_encoder_layers=2 if self.n_encoder_layers else 0,
            encoder_seq_len=16 if self.n_encoder_layers else 0,
            frontend_tokens=8 if self.frontend else 0,
            rwkv_head_dim=16,
        )
