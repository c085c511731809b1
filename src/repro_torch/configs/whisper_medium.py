"""whisper-medium [audio] — encoder-decoder, conv frontend (STUB).

24L d_model=1024 16H (MHA kv=16) d_ff=4096 vocab=51865.
[arXiv:2212.04356; HF openai/whisper-medium]

The conv1d+GELU audio frontend is a stub, as in the reference: the
encoder takes 1500 precomputed frame embeddings (30 s at 50 Hz after the
2x downsampling conv stack). GELU 2-matrix MLPs, LayerNorm with bias, tied
decoder embedding, sinusoidal positions, no projection biases.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    n_encoder_layers=24,
    encoder_seq_len=1500,
    mlp_kind="gelu",
    tie_embeddings=True,
    frontend="audio_stub",
)
