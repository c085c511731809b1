"""Architecture registry of the port: the configurations it can run.

The reference registry (``repro.configs``) holds eleven architectures and
the paper-native LM; the port adds each one when its model family is
ported. ``ARCHS`` holds the dense qwen2-0.5b, phi4-mini-3.8b, minitron-4b
and qwen2.5-32b, the MoE phi3.5-moe-42b-a6.6b, the RWKV-6 (ssm) rwkv6-7b,
the encoder-decoder (encdec) whisper-medium and the vision-language (vlm)
phi-3-vision-4.2b; the front ends of the last two are stubs in both
packages (the encoder takes precomputed frame embeddings, the vlm
precomputed patch embeddings). ``EXTRAS`` holds paper-lm-100m, as the
reference's does. The hybrid jamba-1.5-large-398b and the MoE
kimi-k2-1t-a32b, which need more than one card, are not ported: such a
name raises, pointing at ``ROADMAP.md``, where they are queued.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import (
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
        phi3_5_moe_42b_a6_6b,
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
    raise KeyError(
        f"arch {name!r} is not ported (ported: {sorted(ARCHS) + sorted(EXTRAS)}); the "
        f"configurations that need more than one card are queued in ROADMAP.md, Queue 1")
