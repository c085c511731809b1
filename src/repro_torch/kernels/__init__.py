"""Hand-written Hopper kernels (CUDA C++ for ``sm_90a`` under ``csrc/``),
each with a wrapper that checks its input and counts its launches, and a
plain PyTorch version in ``ref.py`` that runs on CPU tensors."""

from . import ops, ref
from .decode_attention import decode_attention
from .flash_attention import flash_attention
from .matmul import configured_matmul, matmul
from .sampling import greedy_sample, top_k

__all__ = ["configured_matmul", "decode_attention", "flash_attention", "greedy_sample", "matmul",
           "ops", "ref", "top_k"]
