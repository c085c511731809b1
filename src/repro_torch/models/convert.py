"""Carry the reference's parameters across to the port, bit-exactly.

:func:`params_from_numpy` takes a parameter tree of numpy arrays (the
reference's ``Model.init`` tree, turned into numpy by the caller) and
returns the same tree of tensors on a chosen device. bfloat16 arrays (numpy
dtype from ``ml_dtypes``) cannot go through ``torch.from_numpy``, so they
cross as their 16-bit patterns and are viewed back as ``torch.bfloat16``.
"""

from __future__ import annotations

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray, device: str | torch.device = "cuda") -> torch.Tensor:
    a = np.array(a, copy=True, order="C")  # writable and contiguous
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: dict, device: str | torch.device = "cuda") -> dict:
    return {k: params_from_numpy(v, device) if isinstance(v, dict)
            else tensor_from_numpy(v, device) for k, v in tree.items()}
