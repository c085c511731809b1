"""The port's dense model against the JAX package's, on the same parameters.

The reduced qwen2-0.5b runs in both packages on the CPU: logits are held at
``tests/test_decode_parity.py``'s tolerances (bf16 rounds at other places in
the two frameworks), sampled ids exactly, and masked cache rows bit for bit."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import reduced_pair, to_numpy32, to_torch
from repro.configs import get
from repro_torch.configs import get as torch_get
from repro_torch.dispatch.executor import flatten_with_path
from repro_torch.models.model import Model as TorchModel

RTOL, ATOL, TOP1 = 0.05, 0.15, 0.9  # tests/test_decode_parity.py


@pytest.fixture(scope="module")
def pair():
    return reduced_pair()


def _assert_logits_close(want, got):
    a, b = to_numpy32(want), to_numpy32(got)
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= TOP1


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def test_config_and_registry_match_reference():
    assert dataclasses.asdict(torch_get("qwen2-0.5b")) == dataclasses.asdict(get("qwen2-0.5b"))
    with pytest.raises(KeyError, match="unknown arch"):
        torch_get("no-such-arch")


@pytest.mark.parametrize("change", [
    {"family": "hybrid"},
    {"family": "hybrid", "attn_period": 8, "n_experts": 4, "experts_per_token": 2,
     "moe_period": 2}])  # jamba's layout: Mamba, attention a group of 8, MoE every other layer
def test_model_rejects_what_is_not_ported(change):
    """The hybrid family is ported (``tests/test_torch_hybrid.py``); a
    hybrid that is not whole groups of ``attn_period`` layers is refused
    before any weights are drawn (the reference divides by a zero period,
    or drops the 2 layers here short of a group of 8), and so is a family
    the reference does not have."""
    cfg = dataclasses.replace(torch_get("qwen2-0.5b").reduced(), **change)
    with pytest.raises(ValueError, match="whole groups"):
        TorchModel(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="not one of the reference's"):
        TorchModel(dataclasses.replace(cfg, family="mamba2"), device="cpu")


@pytest.mark.parametrize("change", [{"cache_quant": "int8"}, {"attn_chunk": 64}])
def test_model_admits_the_int8_cache_and_chunked_attention(change):
    """Both knobs are ported (``tests/test_torch_int8_kv.py``,
    ``tests/test_torch_chunked_attention.py``): the model builds, and its
    cache and forward take them."""
    cfg = dataclasses.replace(torch_get("qwen2-0.5b").reduced(), remat="none", **change)
    model = TorchModel(cfg, device="cpu")
    cache = model.init_cache(2, 8)
    assert (cache["k"].dtype == torch.int8) == (cfg.cache_quant == "int8")
    assert ("k_scale" in cache) == (cfg.cache_quant == "int8")
    logits, _ = model.forward(model.init(0), {"tokens": torch.ones((1, 80), dtype=torch.int32)})
    assert tuple(logits.shape) == (1, 80, cfg.vocab_size)


def test_init_draws_the_reference_tree(pair):
    """Seeded init: the reference's tree, shapes and dtypes, and its
    N(0, 1/fan_in) scale (the numbers themselves differ by framework)."""
    cfg, jmodel, _, tmodel, _ = pair
    want = jax.tree_util.tree_flatten_with_path(jmodel.abstract_params())[0]
    got = flatten_with_path(tmodel.init(3))
    assert [jax.tree_util.keystr(k) for k, _ in want] == [k for k, _ in got]
    for (_, w), (_, g) in zip(want, got):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
    params = tmodel.init(3)
    wq = params["layers"]["attn"]["wq"].float()
    assert abs(wq.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.1
    torch.testing.assert_close(params["embed"], tmodel.init(3)["embed"], rtol=0, atol=0)


def test_params_cross_bit_exactly(pair):
    _, _, jparams, _, tparams = pair
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = flatten_with_path(tparams)
    assert len(want) == len(got)
    for (_, w), (_, g) in zip(want, got):
        w = np.asarray(w)
        bits = g.view(torch.int16).numpy() if g.dtype == torch.bfloat16 else g.numpy()
        np.testing.assert_array_equal(bits, w.view(np.int16) if w.dtype.name == "bfloat16" else w)


@pytest.mark.parametrize("layer", ["rms_norm", "layer_norm", "rope"])
def test_layers_match_jax(layer):
    """The f32 islands: each layer computes in f32 and casts back to bf16
    at the reference's place, so outputs agree to within one bf16 rounding."""
    from repro.models import layers as JL
    from repro_torch.models import layers as TL

    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.standard_normal((2, 5, 4, 16)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal(16), jnp.float32)
    bias = jnp.asarray(rng.standard_normal(16), jnp.float32)
    pos = jnp.asarray(rng.integers(0, 500, (2, 5)), jnp.int32)
    args = {"rms_norm": (x, w), "layer_norm": (x, w, bias), "rope": (x, pos)}[layer]
    want = getattr(JL, layer)(*args)
    got = getattr(TL, layer)(*(to_torch(a) for a in args))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(to_numpy32(got), to_numpy32(want), rtol=2 ** -7, atol=2 ** -7)


def test_forward_matches_jax(pair):
    cfg, jmodel, jparams, tmodel, tparams = pair
    toks = _tokens(cfg, (2, 8))
    want, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks)})
    got, aux = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16 and float(aux) == 0.0
    _assert_logits_close(want, got)


def test_teacher_forced_decode_matches_jax_and_forward(pair):
    cfg, jmodel, jparams, tmodel, tparams = pair
    b, s = 2, 8
    toks = _tokens(cfg, (b, s))
    jcache, tcache = jmodel.init_cache(b, s), tmodel.init_cache(b, s)
    step = jax.jit(jmodel.decode_step)
    want, got = [], []
    for i in range(s):
        lg, jcache = step(jparams, jcache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        want.append(to_numpy32(lg[:, 0]))
        lt, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(toks[:, i:i + 1]), i)
        got.append(to_numpy32(lt[:, 0]))
    _assert_logits_close(np.stack(want, 1), np.stack(got, 1))
    full, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    _assert_logits_close(full, np.stack(got, 1))


def _fused_run(pair, late_override: int, steps: int):
    """A multi-step fused run of both models with per-slot positions, a dead
    slot and host overrides at steps 0 and 3 (``late_override`` is slot 0's
    token at step 3). Checks every step's ids for equality and returns the
    state both sides reached: (jcache, tcache, prev ids, positions, live)."""
    cfg, jmodel, jparams, tmodel, tparams = pair
    b, max_len = 3, 16
    jcache, tcache = jmodel.init_cache(b, max_len), tmodel.init_cache(b, max_len)
    jstep = jax.jit(jmodel.decode_and_sample)
    pos = np.array([0, 3, 0], np.int32)
    live = np.array([True, True, False])
    jprev = jnp.zeros((b, 1), jnp.int32)
    tprev = torch.zeros((b, 1), dtype=torch.int32)
    for i in range(steps):
        overrides = np.array([5 if i == 0 else late_override, 9, 0], np.int32) \
            if i in (0, 3) else np.zeros(b, np.int32)
        mask = np.array([True, i == 0, False]) if i in (0, 3) else np.zeros(b, bool)
        jprev, jcache = jstep(jparams, jcache, jprev, jnp.asarray(overrides),
                              jnp.asarray(mask), jnp.asarray(pos), jnp.asarray(live))
        tprev, tcache = tmodel.decode_and_sample(
            tparams, tcache, tprev, torch.from_numpy(overrides), torch.from_numpy(mask),
            torch.from_numpy(pos), torch.from_numpy(live))
        assert tprev.dtype == torch.int32 and tprev.shape == (b, 1)
        np.testing.assert_array_equal(tprev.numpy()[live], np.asarray(jprev)[live])
        pos = pos + live
    return jcache, tcache, np.array(jprev), pos, live


def test_decode_and_sample_ids_equal_jax(pair):
    """The sampled ids equal the JAX model's, step by step, over six steps.
    Exact equality across frameworks holds where no step's top-two logits
    lie within the bf16 rounding the two place differently; these inputs
    keep clear of such a tie (the next test holds the one they avoid)."""
    _fused_run(pair, late_override=12, steps=6)


def test_decode_and_sample_bf16_tie_stays_within_parity(pair):
    """The input the test above avoids: an override of 8 at step 3 meets a
    tie at step 5, where JAX's top two logits lie one bf16 ulp apart and the
    port may round them equal. Steps 0-4 agree exactly; at step 5 the logits
    agree at ``test_decode_parity``'s tolerances, and wherever the two
    argmaxes differ, JAX's logits at the two ids lie within that tolerance
    of each other (a tie under it, not a different choice)."""
    cfg, jmodel, jparams, tmodel, tparams = pair
    jcache, tcache, prev, pos, live = _fused_run(pair, late_override=8, steps=5)
    want, _ = jax.jit(jmodel.decode_step)(jparams, jcache, jnp.asarray(prev),
                                          jnp.asarray(pos), jnp.asarray(live))
    got, _ = tmodel.decode_step(tparams, tcache, torch.from_numpy(prev),
                                torch.from_numpy(pos), torch.from_numpy(live))
    want, got = to_numpy32(want[:, 0])[live], to_numpy32(got[:, 0])[live]
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    for w, g in zip(want, got):
        hi, other = w[w.argmax()], w[g.argmax()]
        assert hi - other <= ATOL + RTOL * abs(hi)


def test_prefill_chunk_partial_leaves_unselected_rows_bit_identical(pair):
    """A chunk with n_valid=3 of 8 for slot 1: slot 0's rows and slot 1's
    rows past the three valid steps keep their bits; the probe and the
    written rows agree with the JAX model."""
    cfg, jmodel, jparams, tmodel, tparams = pair
    b, max_len = 2, 16
    rng = np.random.default_rng(5)
    junk = {k: rng.standard_normal((cfg.n_layers, b, max_len, cfg.n_kv_heads,
                                    cfg.head_dim_)).astype(jnp.bfloat16) for k in ("k", "v")}
    jcache = {k: jnp.asarray(v) for k, v in junk.items()}
    tcache = {k: to_torch(v) for k, v in junk.items()}
    before = {k: v.clone() for k, v in tcache.items()}
    chunk = np.array([4, 8, 15, 0, 0, 0, 0, 0], np.int32)
    pos0, n_valid, slot_mask = np.array([5, 2], np.int32), np.int32(3), np.array([False, True])
    jprobe, jcache = jax.jit(jmodel.prefill_chunk)(
        jparams, jcache, jnp.asarray(chunk), jnp.asarray(pos0), jnp.asarray(n_valid),
        jnp.asarray(slot_mask))
    tprobe, tcache = tmodel.prefill_chunk(
        tparams, tcache, torch.from_numpy(chunk), torch.from_numpy(pos0),
        torch.as_tensor(n_valid), torch.from_numpy(slot_mask))
    np.testing.assert_array_equal(tprobe.numpy(), np.asarray(jprobe))
    assert tprobe[0, 0] == 0
    for k in ("k", "v"):
        torch.testing.assert_close(tcache[k][:, 0], before[k][:, 0], rtol=0, atol=0)
        torch.testing.assert_close(tcache[k][:, 1, :2], before[k][:, 1, :2], rtol=0, atol=0)
        torch.testing.assert_close(tcache[k][:, 1, 5:], before[k][:, 1, 5:], rtol=0, atol=0)
        assert not torch.equal(tcache[k][:, 1, 2:5], before[k][:, 1, 2:5])
        np.testing.assert_allclose(to_numpy32(tcache[k]), to_numpy32(jcache[k]),
                                   rtol=RTOL, atol=ATOL)


def test_resident_slot_near_max_len_survives_padded_prefill(pair):
    """Slot 0 sits at position 6 of max_len 8 while slot 1 prefills a padded
    chunk: slot 0 rides along at positions up to 13, past the cache. Its
    rows must come out bit-identical, with no index error (JAX drops the
    out-of-range writes; the port never makes them)."""
    cfg, _, _, tmodel, tparams = pair
    cache = tmodel.init_cache(2, 8)
    tmodel.decode_step(tparams, cache, torch.tensor([[3], [4]], dtype=torch.int32),
                       torch.tensor([6, 0], dtype=torch.int32))
    before = {k: v.clone() for k, v in cache.items()}
    probe, cache = tmodel.prefill_chunk(
        tparams, cache, torch.tensor([1, 2, 0, 0, 0, 0, 0, 0], dtype=torch.int32),
        torch.tensor([6, 1], dtype=torch.int32), torch.tensor(2, dtype=torch.int32),
        torch.tensor([False, True]))
    for k in ("k", "v"):
        torch.testing.assert_close(cache[k][:, 0], before[k][:, 0], rtol=0, atol=0)
        assert not torch.equal(cache[k][:, 1, 1:3], before[k][:, 1, 1:3])
    assert probe[0, 0] == 0
