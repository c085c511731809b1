"""Public kernel entry points, each chosen by its tensor's device.

Unlike ``repro.kernels.ops`` there is no ``backend=`` switch: a CUDA tensor
always runs the hand-written kernel, a CPU tensor its plain version, so
nothing can send a CUDA tensor to the plain version by choice.
"""

from __future__ import annotations

import torch

from .sampling import greedy_sample


def sample_op(logits: torch.Tensor) -> torch.Tensor:
    """Greedy sampling over (B, V) logits → (B,) int32 ids, lowest index
    winning ties — the decode launch's fused epilogue."""
    return greedy_sample(logits)
