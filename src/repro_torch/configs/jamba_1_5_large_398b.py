"""jamba-1.5-large-398b [hybrid] — Mamba+attention 1:7 interleave with MoE.

72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536, MoE 16e top-2.
[arXiv:2403.19887; hf]. One attention layer per 8-layer block, MoE every
other layer (the published Jamba recipe, reproducing the ~398B total /
~94B active split).
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab_size=65536,
    n_experts=16,
    experts_per_token=2,
    moe_period=2,
    attn_period=8,
    ssm_state_dim=16,
    ssm_conv_dim=4,
    ssm_expand=2,
    notes="hybrid: runs long_500k (sub-quadratic: 63/72 layers are Mamba)",
)
