"""Shared set-up of the PyTorch port's tests: a reduced configuration (by
default qwen2-0.5b) in both packages, on the same parameters (the JAX
``Model.init`` tree, carried across bit-exactly through numpy), with the
port on the CPU."""

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


def reduced_pair(seed: int = 0, arch: str = "qwen2-0.5b"):
    """(cfg, jax_model, jax_params, torch_model, torch_params) of ``arch``
    reduced, the parameters drawn by the JAX ``Model.init`` from ``seed``."""
    cfg = dataclasses.replace(get(arch).reduced(), remat="none")
    tcfg = dataclasses.replace(torch_get(arch).reduced(), remat="none")
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    jmodel = Model(cfg)
    jparams = jmodel.init(jax.random.key(seed))
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


def assert_sampled_ids_within_ties(pair, steps: int = 6, rtol: float = 0.05,
                                   atol: float = 0.15, seed: int = 1) -> None:
    """``decode_and_sample`` of both packages over ``steps`` steps of three
    slots at their own positions (slot 2 dead, host overrides at steps 0 and
    3), each side fed its own ids. At every step the live rows' ids are
    equal, or, where they differ, the JAX ``decode_step`` logits of that
    step at the two ids lie within ``test_decode_parity``'s tolerance
    (``rtol``, ``atol``) of each other: a bf16 tie the frameworks round
    apart, as ``test_decode_and_sample_bf16_tie_stays_within_parity`` holds
    it. After the first such tie the two sides feed other tokens, so the
    run stops comparing there."""
    import jax.numpy as jnp

    cfg, jmodel, jparams, tmodel, tparams = pair
    b, max_len = 3, 16
    rng = np.random.default_rng(seed)
    jcache, tcache = jmodel.init_cache(b, max_len), tmodel.init_cache(b, max_len)
    jstep, jlogits = jax.jit(jmodel.decode_and_sample), jax.jit(jmodel.decode_step)
    pos = np.array([0, 3, 0], np.int32)
    live = np.array([True, True, False])
    jprev = jnp.zeros((b, 1), jnp.int32)
    tprev = torch.zeros((b, 1), dtype=torch.int32)
    for i in range(steps):
        overrides = np.zeros(b, np.int32)
        mask = np.zeros(b, bool)
        if i in (0, 3):
            overrides = rng.integers(0, cfg.vocab_size, b).astype(np.int32)
            mask = np.array([True, i == 0, False])
        args = (jnp.asarray(overrides), jnp.asarray(mask), jnp.asarray(pos), jnp.asarray(live))
        tokens = jnp.where(args[1][:, None], args[0][:, None], jprev)
        want = np.asarray(jlogits(jparams, jcache, tokens, args[2], args[3])[0][:, 0], np.float32)
        jprev, jcache = jstep(jparams, jcache, jprev, *args)
        tprev, tcache = tmodel.decode_and_sample(
            tparams, tcache, tprev, *(torch.from_numpy(a) for a in (overrides, mask, pos, live)))
        assert tprev.dtype == torch.int32 and tprev.shape == (b, 1)
        got, ref = tprev.numpy()[:, 0], np.asarray(jprev)[:, 0]
        tied = [r for r in np.flatnonzero(live) if got[r] != ref[r]]
        for r in tied:
            hi, other = want[r, ref[r]], want[r, got[r]]
            assert hi - other <= atol + rtol * abs(hi), (i, r, hi, other)
        if tied:
            return
        pos = pos + live
