"""Architecture registry of the port: the configurations it can run.

Every configuration of the reference's registry (``repro.configs``), in
its order: ``ARCHS`` holds the hybrid jamba-1.5-large-398b, the MoE
phi3.5-moe-42b-a6.6b and kimi-k2-1t-a32b, the dense phi4-mini-3.8b,
qwen2.5-32b, minitron-4b and qwen2-0.5b, the vision-language (vlm)
phi-3-vision-4.2b, the encoder-decoder (encdec) whisper-medium and the
RWKV-6 (ssm) rwkv6-7b; the front ends of the vlm and the encoder are stubs
in both packages (the encoder takes precomputed frame embeddings, the vlm
precomputed patch embeddings). ``EXTRAS`` holds paper-lm-100m, as the
reference's does. jamba-1.5-large-398b (796 GB of bf16 weights) and
kimi-k2-1t-a32b (2.08 TB) need many cards whole; one card runs them cut
in depth (one Jamba group, one kimi-k2 layer), the sharding across cards
being queued in ``ROADMAP.md``, Queue 1, item 6.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import (
    jamba_1_5_large_398b,
    kimi_k2_1t_a32b,
    minitron_4b,
    paper_lm_100m,
    phi3_5_moe_42b_a6_6b,
    phi4_mini_3_8b,
    phi_3_vision_4_2b,
    qwen2_0_5b,
    qwen2_5_32b,
    rwkv6_7b,
    whisper_medium,
)

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        jamba_1_5_large_398b,
        phi3_5_moe_42b_a6_6b,
        kimi_k2_1t_a32b,
        phi4_mini_3_8b,
        qwen2_5_32b,
        minitron_4b,
        qwen2_0_5b,
        phi_3_vision_4_2b,
        whisper_medium,
        rwkv6_7b,
    )
}

EXTRAS: dict[str, ModelConfig] = {paper_lm_100m.CONFIG.name: paper_lm_100m.CONFIG}


def get(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    if name in EXTRAS:
        return EXTRAS[name]
    raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS) + sorted(EXTRAS)}")
