"""kimi-k2-1t-a32b [moe] — trillion-parameter MoE, 384 experts top-8.

61L d_model=7168 64H (GQA kv=8) d_ff=2048 vocab=163840.
[arXiv:2501.kimi2; unverified — paper-table config]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=64,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=163840,
    n_experts=384,
    experts_per_token=8,
    capacity_factor=1.25,
)
