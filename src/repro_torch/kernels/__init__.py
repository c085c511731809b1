"""Hand-written Hopper kernels (CUDA C++ for ``sm_90a`` under ``csrc/``),
each with a wrapper that checks its input and counts its launches, and a
plain PyTorch version in ``ref.py`` that runs on CPU tensors."""

from . import ops, ref
from .sampling import greedy_sample

__all__ = ["greedy_sample", "ops", "ref"]
