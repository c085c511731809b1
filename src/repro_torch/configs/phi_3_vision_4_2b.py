"""phi-3-vision-4.2b [vlm] — phi3-mini backbone + CLIP vision tower (STUB).

32L d_model=3072 32H (GQA kv=32 = MHA) d_ff=8192 vocab=32064.
[hf:microsoft/Phi-3-vision-128k-instruct; hf]

Per the assignment the modality frontend is a stub: ``input_specs()``
provides 576 precomputed patch embeddings (CLIP ViT-L/14 @ 336px) prepended
to the token sequence.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    family="vlm",
    n_layers=32,
    d_model=3072,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    frontend="vision_stub",
    frontend_tokens=576,
)
