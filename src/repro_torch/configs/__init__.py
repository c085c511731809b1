"""Architecture registry of the port: only the configurations it can run.

The reference registry (``repro.configs``) holds eleven architectures; the
port adds each one when its model family is ported. A name that is not
here raises, pointing at ``ROADMAP.md``, where the other families are
queued.
"""

from __future__ import annotations

from repro_torch.models.config import ModelConfig

from . import qwen2_0_5b

ARCHS: dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in (qwen2_0_5b,)}


def get(name: str) -> ModelConfig:
    if name in ARCHS:
        return ARCHS[name]
    raise KeyError(
        f"arch {name!r} is not ported (ported: {sorted(ARCHS)}); the other "
        f"model families are queued in ROADMAP.md, Queue 1, \"The other families\"")
