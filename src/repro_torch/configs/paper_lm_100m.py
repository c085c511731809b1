"""paper-lm-100m — the ~100M-parameter dense LM used by the end-to-end
training example and the dispatch/configuration-wall benchmarks (the paper's
own evaluation is a GEMM workload; this is the framework-native stand-in)."""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="paper-lm-100m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=4,
    d_ff=2048,
    vocab_size=32000,
)
