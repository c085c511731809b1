"""Shared set-up of the PyTorch port's tests: the reduced qwen2-0.5b in both
packages, on the same parameters (the JAX ``Model.init`` tree, carried
across bit-exactly through numpy), with the port on the CPU."""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import torch

from repro.configs import get
from repro.models.model import Model
from repro_torch.configs import get as torch_get
from repro_torch.models.convert import params_from_numpy, tensor_from_numpy
from repro_torch.models.model import Model as TorchModel


def reduced_pair():
    """(cfg, jax_model, jax_params, torch_model, torch_params)."""
    cfg = dataclasses.replace(get("qwen2-0.5b").reduced(), remat="none")
    tcfg = dataclasses.replace(torch_get("qwen2-0.5b").reduced(), remat="none")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    jmodel = Model(cfg)
    jparams = jmodel.init(jax.random.key(0))
    tmodel = TorchModel(tcfg, device="cpu")
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    return cfg, jmodel, jparams, tmodel, tparams


def to_torch(a) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor, bit-exactly (bf16 included)."""
    return tensor_from_numpy(np.asarray(a), "cpu")


def to_numpy32(t) -> np.ndarray:
    """A tensor or JAX array as float32 numpy, for comparison."""
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)
