"""PyTorch/CUDA port of the ``repro`` serving stack, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package mirrors its layout
and names (``repro_torch/models/layers.py`` is the counterpart of
``repro/models/layers.py``, and so on) and imports nothing from it. Each
Pallas kernel of the reference becomes a kernel written by hand for
``sm_90a`` under ``kernels/csrc/``, built with ``nvcc`` at first use.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
nothing falls back to the CPU when there is no card. On a CPU tensor a
kernel wrapper runs its plain PyTorch version, which is what the CPU tests
hold against the JAX package. What is ported so far, and what is still
queued, is listed in ``ROADMAP.md``.
"""
