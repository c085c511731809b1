"""Architecture registry of the port: only the configurations it can run.

The reference registry (``repro.configs``) holds eleven architectures; the
port adds each one when its model family is ported. It holds the dense
qwen2-0.5b, the MoE phi3.5-moe-42b-a6.6b, the RWKV-6 (ssm) rwkv6-7b and the
encoder-decoder (encdec) whisper-medium, whose audio front end is a stub
in both packages: its encoder takes precomputed frame embeddings. The
hybrid (jamba) and vlm (phi-3-vision) families and the other dense and
MoE configurations are not ported: such a name raises, pointing at
``ROADMAP.md``, where they are queued.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import phi3_5_moe_42b_a6_6b, qwen2_0_5b, rwkv6_7b, whisper_medium

ARCHS: dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen2_0_5b, phi3_5_moe_42b_a6_6b, rwkv6_7b, whisper_medium)
}


def get(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    raise KeyError(
        f"arch {name!r} is not ported (ported: {sorted(ARCHS)}); the other "
        f"model families are queued in ROADMAP.md, Queue 1, \"The other families\"")
