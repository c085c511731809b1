"""Plain PyTorch versions of the port's kernels.

Each hand-written kernel has its plain version here: the wrappers run it on
CPU tensors, the CPU tests hold it against the JAX package, and
``chip_smoke.py`` holds each kernel against it on the card.
"""

from __future__ import annotations

import torch


def greedy_sample_ref(logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the last axis of (B, V) logits → (B,) int32, lowest index
    winning ties and the first NaN winning over every number (the
    ``jnp.argmax`` contract, which ``torch.argmax`` shares)."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
