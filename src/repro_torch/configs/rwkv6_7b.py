"""rwkv6-7b [ssm] — Finch: attention-free, data-dependent decay.

32L d_model=4096 d_ff=14336 vocab=65536.
[arXiv:2404.05892; hf]
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,  # 4096 / 64 rwkv heads
    n_kv_heads=64,
    d_ff=14336,
    vocab_size=65536,
    rwkv_head_dim=64,
    notes="attention-free: runs long_500k with O(1) decode state",
)
