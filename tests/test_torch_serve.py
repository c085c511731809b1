"""The port's batched serving loop (``repro_torch.launch.serve``) against
the JAX package's, on the same parameters.

For each mode the port's ids must equal those of a JAX loop built from the
reference's own lines (``repro/launch/serve.py``: ``jax.jit`` decode with
``jnp.argmax``, ``lax.scan`` for fused). Exact equality across frameworks
holds where no step's top-two logits lie within the bf16 rounding the two
place differently (ROADMAP.md, Queue 3), so every compared step asserts
JAX's top-two margin above twice the 0.03 gap recorded there. The
parameters are drawn from seed 3, whose runs below stay clear of such a tie
in every mode.

The reference's fused warm-up runs ``fuse`` steps that feed each other,
where the other modes' warm-up is one step; so at ``fuse > 1`` the fused
ids follow another token chain, in the reference as in the port. Across
modes the port is held to what the schedule makes equal: sequential and
concurrent give bit-identical ids, and so does fused at ``fuse = 1``.

The CUDA graph path runs only on a card: its test is marked ``gpu`` and
skips here. JAX is imported inside the CPU tests so that test also collects
on a machine without it."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get as torch_get
from repro_torch.kernels import ops as kernel_ops
from repro_torch.launch.serve import MODES, serve
from repro_torch.models.model import Model as TorchModel

SEED = 3
BATCH, STEPS, CACHE_LEN, FUSE = 2, 19, 24, 4  # fused: launches of 4, 4, 4 and a tail of 3
MARGIN = 0.06  # twice the 0.03 cross-framework logit gap (ROADMAP.md, Queue 3)


@pytest.fixture(scope="module")
def pair():
    from _torch_port import reduced_pair

    return reduced_pair(SEED)


def _margin(logits):
    import jax.numpy as jnp

    top = jnp.sort(logits.astype(jnp.float32), axis=-1)
    return top[..., -1] - top[..., -2]


def _jax_serve(jmodel, jparams, mode: str, *, batch: int, steps: int, cache_len: int,
               fuse: int, compiler_options: dict | None = None) -> tuple[np.ndarray, np.ndarray]:
    """The reference's decode loop (``repro/launch/serve.py``), returning the
    timed loop's ids (produced, B) and each step's top-two logit margins.
    ``compiler_options`` go to both ``jax.jit`` calls."""
    import jax
    import jax.numpy as jnp

    cache = jmodel.init_cache(batch, cache_len)
    tokens = jnp.ones((batch, 1), jnp.int32)
    decode = jax.jit(jmodel.decode_step, donate_argnums=(1,), compiler_options=compiler_options)

    def fused_decode(params, cache, tokens, pos0, k):
        def body(carry, i):
            cache, toks = carry
            logits, cache = jmodel.decode_step(params, cache, toks, pos0 + i)
            nxt = jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32)
            return (cache, nxt), (nxt[:, 0], _margin(logits[:, -1]))
        (cache, _), out = jax.lax.scan(
            body, (cache, tokens), jnp.arange(k, dtype=jnp.int32)
        )
        return out, cache

    fused = jax.jit(fused_decode, static_argnames=("k",), donate_argnums=(1,),
                    compiler_options=compiler_options)
    ids, margins = [], []
    if mode == "fused":
        _, cache = fused(jparams, cache, tokens, jnp.int32(0), fuse)
        pos = fuse
        while pos < steps:
            k = min(fuse, steps - pos)
            (out, margin), cache = fused(jparams, cache, tokens, jnp.int32(pos), k)
            tokens = out[-1:, :].T.astype(jnp.int32)
            pos += k
            ids.append(out)
            margins.append(margin)
    else:
        logits, cache = decode(jparams, cache, tokens, jnp.int32(0))
        for i in range(1, steps):
            logits, cache = decode(jparams, cache, tokens, jnp.int32(i))
            margins.append(_margin(logits[:, -1])[None])
            tokens = jnp.argmax(logits, axis=-1).astype(jnp.int32)
            ids.append(tokens.T)
    return np.concatenate(ids), np.concatenate(margins)


def _serve(model, params, mode: str, **kw):
    return serve(model, params, **{"batch": BATCH, "steps": STEPS, "cache_len": CACHE_LEN,
                                   "fuse": FUSE, "mode": mode, **kw})


@pytest.mark.parametrize("mode", MODES)
def test_serve_ids_equal_jax(pair, mode):
    _, jmodel, jparams, tmodel, tparams = pair
    want, margins = _jax_serve(jmodel, jparams, mode, batch=BATCH, steps=STEPS,
                               cache_len=CACHE_LEN, fuse=FUSE)
    assert margins.min() > MARGIN, margins.min()
    run = _serve(tmodel, tparams, mode)
    produced = STEPS - (FUSE if mode == "fused" else 1)
    assert run.ids.dtype == torch.int32 and tuple(run.ids.shape) == (produced, BATCH)
    np.testing.assert_array_equal(run.ids.numpy(), want)
    assert run.device_ms is None and run.graphs == [] and run.sample_launches == 0
    assert run.launches == (-(-produced // FUSE) if mode == "fused" else produced)
    assert min(run.issue_ms) > 0 and sum(run.issue_ms) <= run.wall_s * 1e3
    assert run.tokens_per_s > 0


def test_modes_give_bit_identical_ids(pair):
    """Sequential and concurrent run the same steps; a fused launch of one
    step takes the sequential schedule, warm-up included."""
    *_, tmodel, tparams = pair
    seq = _serve(tmodel, tparams, "sequential").ids
    torch.testing.assert_close(_serve(tmodel, tparams, "concurrent").ids, seq, rtol=0, atol=0)
    torch.testing.assert_close(_serve(tmodel, tparams, "fused", fuse=1).ids, seq, rtol=0, atol=0)


@pytest.mark.parametrize("mode,steps,fuse", [("sequential", 17, 4), ("concurrent", 17, 4),
                                             ("fused", 17, 4), ("fused", 8, 17)])
def test_a_run_past_the_cache_raises_before_any_launch(pair, monkeypatch, mode, steps, fuse):
    *_, tmodel, tparams = pair
    calls = []
    monkeypatch.setattr(tmodel, "decode_step", lambda *a, **k: calls.append(a))
    monkeypatch.setattr(kernel_ops, "sample_op", lambda *a, **k: calls.append(a))
    with pytest.raises(ValueError, match="past a cache of 16"):
        serve(tmodel, tparams, batch=BATCH, steps=steps, cache_len=16, mode=mode, fuse=fuse)
    assert calls == []


@pytest.mark.parametrize("mode", MODES)
def test_a_run_that_fills_the_cache_runs(pair, mode):
    *_, tmodel, tparams = pair
    run = serve(tmodel, tparams, batch=BATCH, steps=8, cache_len=8, mode=mode, fuse=3)
    assert tuple(run.ids.shape) == (8 - (3 if mode == "fused" else 1), BATCH)


def test_reference_clamps_a_scalar_pos_past_max_len_onto_the_last_row(pair):
    """The documented divergence that ``serve``'s check keeps out of the port:
    the reference's scalar write (``lax.dynamic_update_slice``) clamps a
    position past ``max_len`` and overwrites the last cache row, its
    per-slot write drops the same row, and the port's model refuses it."""
    import jax
    import jax.numpy as jnp

    _, jmodel, jparams, tmodel, tparams = pair
    b, max_len = 2, 4
    decode = jax.jit(jmodel.decode_step)
    cache = jmodel.init_cache(b, max_len)
    for i in range(max_len):
        _, cache = decode(jparams, cache, jnp.full((b, 1), 5 + i, jnp.int32), jnp.int32(i))
    toks = jnp.full((b, 1), 9, jnp.int32)
    _, clamped = decode(jparams, cache, toks, jnp.int32(max_len + 1))
    _, dropped = decode(jparams, cache, toks, jnp.full((b,), max_len + 1, jnp.int32))
    for name in ("k", "v"):
        before, after = np.asarray(cache[name]), np.asarray(clamped[name])
        np.testing.assert_array_equal(after[:, :, :-1], before[:, :, :-1])
        assert not np.array_equal(after[:, :, -1], before[:, :, -1])
        np.testing.assert_array_equal(np.asarray(dropped[name]), before)
    tcache = tmodel.init_cache(b, max_len)
    with pytest.raises(IndexError):
        tmodel.decode_step(tparams, tcache, torch.full((b, 1), 9, dtype=torch.int32),
                           max_len + 1)


def _eager_fused_ids(model, params, *, batch: int, steps: int, cache_len: int,
                     fuse: int) -> torch.Tensor:
    """The reference's fused schedule as a plain loop of ``decode_step`` and
    ``sample_op`` calls, with an int position."""
    cache = model.init_cache(batch, cache_len)
    ones = torch.ones((batch, 1), dtype=torch.int32, device=model.device)
    tokens, ids = ones, []
    for pos in range(steps if steps > fuse else fuse):
        logits, cache = model.decode_step(params, cache, tokens, pos)
        tokens = kernel_ops.sample_op(logits[:, -1])[:, None]
        if pos >= fuse:
            ids.append(tokens.T)
        if pos == fuse - 1:
            tokens = ones  # the warm-up's ids are not fed forward
    return torch.cat(ids).cpu()


@pytest.mark.gpu
def test_cuda_fused_graph_replay_equals_the_eager_loop():
    """On the card: the fused mode's graph replays (one graph of 4 steps,
    one of the 3-step tail) give the eager loop's ids, bit for bit, with one
    greedy_sample launch a token; sequential, concurrent and fused at
    ``fuse = 1`` agree."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: CUDA graphs and the kernel have no CPU mode")
    cfg = dataclasses.replace(torch_get("qwen2-0.5b").reduced(), remat="none")
    model = TorchModel(cfg, device="cuda")
    params = model.init(SEED)
    run = _serve(model, params, "fused")
    assert sorted((g.k, g.launches, g.replays) for g in run.graphs) == [(3, 3, 1), (4, 4, 3)]
    assert run.sample_launches == run.produced == STEPS - FUSE
    assert run.device_ms > 0
    want = _eager_fused_ids(model, params, batch=BATCH, steps=STEPS, cache_len=CACHE_LEN,
                            fuse=FUSE)
    torch.testing.assert_close(run.ids, want, rtol=0, atol=0)
    seq = _serve(model, params, "sequential")
    assert seq.sample_launches == seq.produced == STEPS - 1
    for mode, fuse in (("concurrent", FUSE), ("fused", 1)):
        torch.testing.assert_close(_serve(model, params, mode, fuse=fuse).ids, seq.ids,
                                   rtol=0, atol=0)
