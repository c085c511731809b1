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
in depth (one Jamba group, one kimi-k2 layer); ``launch.dryrun`` places
them whole on the production meshes, on meta tensors.

``SHAPES``, :func:`applicable` and :func:`cells` are the reference's input
shapes and its dry-run cells, in its order.
"""

from __future__ import annotations

from dataclasses import dataclass

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


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runs?, reason). long_500k needs sub-quadratic attention."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "full-attention arch: 500k decode skipped per assignment"
    return True, ""


def cells(include_inapplicable: bool = False):
    """All (arch, shape, runs?, reason) dry-run cells in a stable order."""
    out = []
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            ok, reason = applicable(arch, shape)
            if ok or include_inapplicable:
                out.append((arch, shape, ok, reason))
    return out
