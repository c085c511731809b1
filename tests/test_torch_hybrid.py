"""The port's hybrid (Jamba) family against the JAX package's, on the same
parameters.

The reduced jamba-1.5-large-398b (one group of 8 layers: attention with its
dense MLP, then seven Mamba layers whose MLP is MoE at the even in-group
positions; d_model 64, d_in 128, state 16, 4 experts top-2, vocab 256)
runs in both packages on the CPU, its weights drawn by the JAX
``Model.init`` and carried across through ``models.convert``; inputs come
from numpy seeds.

As for RWKV-6 (``tests/test_torch_ssm.py``), under ``jax.jit`` XLA keeps
bf16 intermediates in f32 across a fusion; the port rounds every bf16 op
as written, as the reference does with ``xla_allow_excess_precision`` off
(``EXACT``), and there it gives the reference's forward and decode logits
bit for bit. At that setting the reference's own forward and decode part:
the forward's convolution is a Python ``sum`` of bf16 products, each add
rounded in bf16, and decode's an ``einsum`` summed in f32 and rounded once,
and through seven Mamba layers their logits lie up to ≈ 2.5 apart. XLA's
default rounds neither sum, which is how ``test_decode_parity`` holds
them within its tolerances; so each path is held to the reference's own
here, not to the other path.

A slot freed by one request and taken by the next starts from a zero
Mamba state in the port (a step at position 0 reads none), where the
reference reads the last occupant's ``h`` and ``conv`` on (ROADMAP.md
Queue 3); the engine is held to JAX on runs that reuse no slot.

JAX is imported inside the CPU tests, so the ``gpu`` tests also collect on a
machine without it."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get as torch_get
from repro_torch.launch.serve import MODES, serve
from repro_torch.models import layers as TL
from repro_torch.models.model import Model as TorchModel
from test_torch_ssm import EXACT, Logits, _assert_nearly_bits, _bits, _jit

ARCH = "jamba-1.5-large-398b"
SEED = 0
CUT = {"n_layers": 4, "attn_period": 4}  # chip_smoke.py's [hybrid]: one group, widths as published
CHUNK_TOL = dict(rtol=2e-2, atol=2e-2)  # test_mamba_chunked.py: chunked against the one scan
STEP_TOL = dict(rtol=5e-2, atol=5e-2)  # test_mamba_chunked.py: the recurrence against chunked
STATE_TOL = dict(rtol=1e-6, atol=1e-6)  # the f32 state: products summed in another order
GRAD_REL_L2 = 3e-2  # bf16 backward rounding between the frameworks; 0.023 at most measured
PROMPTS = [[5, 9, 2], [7, 1], [3, 3, 3, 3]]
MAX_NEW, PREFILL_CHUNK = 4, 2
SERVE = dict(batch=2, steps=11, cache_len=16, fuse=4)  # fused: launches of 4 and a tail of 3


@pytest.fixture(scope="module")
def pair():
    return _pair_of(SEED)


@functools.cache
def _pair_of(seed: int):
    from _torch_port import reduced_pair

    return reduced_pair(seed, ARCH)


def _drop_free(cfg):
    """``cfg`` at drop-free capacity: rows then never meet in an expert's
    buffer, so a row's numbers depend on its own inputs alone."""
    return dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _bf16(shape, seed: int):
    import jax.numpy as jnp

    return jnp.asarray(np.random.default_rng(seed).standard_normal(shape), jnp.bfloat16)


# ------------------------------------------------------------ configuration


def test_config_and_cut_match_reference():
    """The config is the reference's; its parameter count is the published
    ≈ 398e9 (≈ 94e9 active), and the one-group cut that ``chip_smoke.py``
    serves counts 22,970,204,160 in both packages (45.94 GB in bf16)."""
    from repro.configs import get

    assert dataclasses.asdict(torch_get(ARCH)) == dataclasses.asdict(get(ARCH))
    cfg = torch_get(ARCH)
    assert abs(cfg.param_count() - 398e9) / 398e9 < 0.05
    assert abs(cfg.active_param_count() - 94e9) / 94e9 < 0.05
    cut = dataclasses.replace(cfg, **CUT)
    assert cut.param_count() == dataclasses.replace(get(ARCH), **CUT).param_count() \
        == 22_970_204_160
    assert (cut.n_attn_layers(), cut.n_ssm_layers(), cut.n_moe_layers()) == (1, 3, 2)


def test_init_draws_the_reference_tree(pair):
    """``groups.{attn_norm, attn, attn_mlp_norm, attn_mlp, mamba_norm, mamba,
    mamba_mlp_norm, mamba_moe, mamba_mlp}``: the reference's tree, shapes and
    dtypes (nested (g, m, …), (g, n_moe, …), (g, m − n_moe, …) stacks), the
    Mamba constants (f32 ``a_log`` = log(1 … N), ``dt_bias`` zeros,
    ``d_skip`` ones) and N(0, 1/fan_in) matrices drawn afresh a layer."""
    import jax

    from repro_torch.dispatch.executor import flatten_with_path

    cfg, jmodel, _, tmodel, _ = pair
    want = jax.tree_util.tree_flatten_with_path(jmodel.abstract_params())[0]
    params = tmodel.init(3)
    got = flatten_with_path(params)
    assert [jax.tree_util.keystr(k) for k, _ in want] == [k for k, _ in got]
    for (_, w), (_, g) in zip(want, got):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
    mamba = params["groups"]["mamba"]
    n = cfg.ssm_state_dim
    log = torch.log(torch.arange(1, n + 1, dtype=torch.float32))
    assert torch.equal(mamba["a_log"], log.expand_as(mamba["a_log"]))
    assert torch.equal(mamba["dt_bias"], torch.zeros_like(mamba["dt_bias"]))
    assert torch.equal(mamba["d_skip"], torch.ones_like(mamba["d_skip"]))
    for w, fan_in in ((mamba["in_proj"], cfg.d_model), (mamba["out_proj"], 2 * cfg.d_model),
                      (params["groups"]["mamba_moe"]["wo"], cfg.d_ff)):
        assert abs(w.float().std().item() * fan_in ** 0.5 - 1.0) < 0.1
    assert not torch.equal(mamba["in_proj"][0, 0], mamba["in_proj"][0, 1])


# ---------------------------------------------------------- Mamba functions


def _mamba_layer(pair, seed: int = 4):
    """Group 0's first Mamba layer on both sides, with a random ``dt_bias``
    and ``d_skip`` (the drawn ones are constants)."""
    import jax
    import jax.numpy as jnp

    from _torch_port import to_torch

    cfg, _, jparams, _, _ = pair
    rng = np.random.default_rng(seed)
    d_in = cfg.ssm_expand * cfg.d_model
    lp = dict(jax.tree.map(lambda a: a[0, 0], jparams["groups"]["mamba"]))
    lp["dt_bias"] = jnp.asarray(rng.uniform(-2, 1, d_in), jnp.float32)
    lp["d_skip"] = jnp.asarray(rng.standard_normal(d_in), jnp.float32)
    return lp, {k: to_torch(v) for k, v in lp.items()}


@pytest.mark.parametrize("n", [1, 2, 3, 5, 8, 13, 16, 17])
def test_associative_scan_combines_in_the_references_order(n):
    """``layers.associative_scan`` of the Mamba combine over seeded f32
    (a, b) pairs gives ``lax.associative_scan``'s bits at every length."""
    import jax
    import jax.numpy as jnp
    from repro.models import layers as JL

    rng = np.random.default_rng(n)
    a = rng.uniform(0.5, 1.0, (2, n, 3)).astype(np.float32)
    b = rng.standard_normal((2, n, 3)).astype(np.float32)
    want = jax.lax.associative_scan(JL._mamba_scan_combine, (jnp.asarray(a), jnp.asarray(b)),
                                    axis=1)
    got = TL.associative_scan(TL._mamba_scan_combine, (torch.from_numpy(a), torch.from_numpy(b)),
                              1)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_softplus_is_the_references():
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) within two f32 ulps: the CPU's
    ``exp`` and ``log1p`` round apart between the frameworks on ≈ 5 %
    of these inputs; ``F.softplus`` would return x itself above 20."""
    import jax

    x = np.concatenate([np.linspace(-40, 40, 4001), [0.0, -0.0, 1e-8, 88.0]]).astype(np.float32)
    np.testing.assert_allclose(TL._softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(x)), rtol=2 ** -22, atol=0)


@pytest.mark.parametrize("chunk", [0, 8, 16, 32, 24])
def test_mamba_apply_matches_jax(pair, chunk):
    """``mamba_apply`` over (2, 64, d) seeded bf16 inputs in the one-scan
    form (0), chunked at 8, 16 and 32, and at 24, which does not divide 64
    and falls back to the one scan: nearly bit for bit the reference's
    (eager, as ``test_mamba_chunked.py`` calls it); chunked within
    ``CHUNK_TOL`` of the one scan, and the fallback equal to it."""
    from _torch_port import to_torch
    from repro.models import layers as JL

    cfg = dataclasses.replace(pair[0], ssm_chunk=chunk)
    jlp, tlp = _mamba_layer(pair)
    x = _bf16((2, 64, cfg.d_model), 8)
    got = TL.mamba_apply(tlp, cfg, to_torch(x))
    _assert_nearly_bits(got, JL.mamba_apply(jlp, cfg, x))
    one = TL.mamba_apply(tlp, dataclasses.replace(cfg, ssm_chunk=0), to_torch(x))
    if chunk in (0, 24):
        assert torch.equal(got, one)
    else:
        np.testing.assert_allclose(got.float().numpy(), one.float().numpy(), **CHUNK_TOL)


def test_mamba_step_matches_jax_and_chunked_apply(pair):
    """``mamba_step`` over the same 64 positions from a zero state: each
    output nearly bit for bit the reference's step, the f32 state within
    ``STATE_TOL`` and the bf16 window bit for bit; and within ``STEP_TOL``
    of ``mamba_apply`` chunked at 16 (``test_mamba_chunked.py``'s)."""
    import jax.numpy as jnp

    from _torch_port import to_torch
    from repro.models import layers as JL

    cfg = pair[0]
    jlp, tlp = _mamba_layer(pair)
    x = _bf16((2, 64, cfg.d_model), 8)
    d_in = cfg.ssm_expand * cfg.d_model
    jstate = {"h": jnp.zeros((2, d_in, cfg.ssm_state_dim), jnp.float32),
              "conv": jnp.zeros((2, cfg.ssm_conv_dim, d_in), jnp.bfloat16)}
    tstate = {k: to_torch(v) for k, v in jstate.items()}
    want, got = [], []
    for i in range(x.shape[1]):
        yj, jstate = JL.mamba_step(jlp, cfg, x[:, i:i + 1], jstate)
        yt, tstate = TL.mamba_step(tlp, cfg, to_torch(x[:, i:i + 1]), tstate)
        want.append(yj)
        got.append(yt)
    got = torch.cat(got, 1)
    _assert_nearly_bits(got, jnp.concatenate(want, 1))
    np.testing.assert_allclose(tstate["h"].numpy(), np.asarray(jstate["h"]), **STATE_TOL)
    np.testing.assert_array_equal(_bits(tstate["conv"]), _bits(jstate["conv"]))
    chunked = TL.mamba_apply(tlp, dataclasses.replace(cfg, ssm_chunk=16), to_torch(x))
    np.testing.assert_allclose(got.float().numpy(), chunked.float().numpy(), **STEP_TOL)


# ------------------------------------------------------------ whole model


def test_forward_matches_jax(pair):
    """``forward`` at ``EXACT``: the logits and the MoE aux loss, bit for
    bit but for the rare element at a rounding boundary."""
    import jax.numpy as jnp

    cfg, jmodel, jparams, tmodel, tparams = pair
    toks = _tokens(cfg, (2, 8))
    want, want_aux = _jit(jmodel.forward, "exact")(jparams, {"tokens": jnp.asarray(toks)})
    got, aux = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 8, cfg.vocab_size)
    _assert_nearly_bits(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)


def _teacher_forced(step, params, cache, toks, wrap):
    out = []
    for i in range(toks.shape[1]):
        logits, cache = step(params, cache, wrap(toks[:, i:i + 1]), i)
        out.append(logits[:, 0])
    return out, cache


def test_teacher_forced_decode_matches_jax(pair):
    """Step-by-step decode from an empty cache at ``EXACT``: each step's
    logits nearly bit for bit the reference's, and after the last step its
    ``k``, ``v`` and ``conv`` bit for bit and ``h`` within ``STATE_TOL``."""
    import jax.numpy as jnp

    cfg, jmodel, jparams, tmodel, tparams = pair
    b, s = 2, 8
    toks = _tokens(cfg, (b, s))
    want, jcache = _teacher_forced(_jit(jmodel.decode_step, "exact"), jparams,
                                   jmodel.init_cache(b, s), toks, jnp.asarray)
    got, tcache = _teacher_forced(tmodel.decode_step, tparams, tmodel.init_cache(b, s), toks,
                                  torch.from_numpy)
    _assert_nearly_bits(torch.stack(got, 1), jnp.stack(want, 1))
    for k in ("k", "v", "conv"):
        np.testing.assert_array_equal(_bits(tcache[k]), _bits(jcache[k]))
    np.testing.assert_allclose(tcache["h"].numpy(), np.asarray(jcache["h"]), **STATE_TOL)


def test_forward_and_decode_part_in_the_reference_where_bf16_rounds_as_written(pair):
    """The reference's own divergence, which the port keeps: at ``EXACT``
    the forward's convolution sums bf16 products in bf16 and decode's sums
    them in f32, and the reference's forward and teacher-forced decode lie
    further apart than ``test_decode_parity``'s tolerances (which they meet
    under XLA's default excess precision); the port's two paths lie apart
    by the same bits."""
    import jax.numpy as jnp

    from _torch_port import to_numpy32

    cfg, jmodel, jparams, tmodel, tparams = pair
    b, s = 2, 8
    toks = _tokens(cfg, (b, s))
    jfwd = to_numpy32(_jit(jmodel.forward, "exact")(jparams, {"tokens": jnp.asarray(toks)})[0])
    jdec, _ = _teacher_forced(_jit(jmodel.decode_step, "exact"), jparams,
                              jmodel.init_cache(b, s), toks, jnp.asarray)
    jdec = to_numpy32(jnp.stack(jdec, 1))
    assert not np.allclose(jdec, jfwd, rtol=0.05, atol=0.15)
    tfwd = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})[0].float().numpy()
    tdec, _ = _teacher_forced(tmodel.decode_step, tparams, tmodel.init_cache(b, s), toks,
                              torch.from_numpy)
    tdec = torch.stack(tdec, 1).float().numpy()
    assert np.abs(tdec - tfwd).max() == np.abs(jdec - jfwd).max()


def _junk_cache(cfg, b: int, max_len: int, seed: int = 5) -> dict:
    """Seeded normal values in every leaf of the reference's cache, in numpy."""
    from repro.models.model import Model

    rng = np.random.default_rng(seed)
    shapes = Model(cfg).init_cache(b, max_len, concrete=False)
    return {k: rng.standard_normal(v.shape).astype(v.dtype) for k, v in shapes.items()}


def test_masked_decode_step_freezes_the_masked_rows_state(pair):
    """Slots 1 and 3 masked out of four, over a random cache, each slot at
    its own position: the masked rows' ``k``, ``v``, ``h`` and ``conv`` come
    out bit-identical in every layer (as the reference's do), the live
    rows' take the reference's (``h`` within ``STATE_TOL``), and every row's
    logits equal the reference's at ``EXACT``."""
    import jax.numpy as jnp

    from _torch_port import to_torch

    cfg, jmodel, jparams, tmodel, tparams = pair
    junk = _junk_cache(cfg, 4, 12)
    tokens = np.array([[4], [9], [17], [30]], np.int32)
    pos = np.array([5, 2, 9, 7], np.int32)
    mask = np.array([True, False, True, False])
    jcache = {k: jnp.asarray(v) for k, v in junk.items()}
    tcache = {k: to_torch(v) for k, v in junk.items()}
    addresses = {k: v.data_ptr() for k, v in tcache.items()}
    want, jcache = _jit(jmodel.decode_step, "exact")(
        jparams, jcache, jnp.asarray(tokens), jnp.asarray(pos), jnp.asarray(mask))
    got, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(tokens),
                                     torch.from_numpy(pos), torch.from_numpy(mask))
    _assert_nearly_bits(got, want)
    for k, before in junk.items():
        ax = 2 if k in ("h", "conv") else 1
        after, jafter, was = (np.moveaxis(a, ax, 0) for a in
                              (_bits(tcache[k]), _bits(jcache[k]), _bits(before)))
        assert tcache[k].data_ptr() == addresses[k]  # updated in place
        for slot in (1, 3):
            np.testing.assert_array_equal(after[slot], was[slot])
            np.testing.assert_array_equal(jafter[slot], was[slot])
        for slot in (0, 2):
            assert not np.array_equal(after[slot], was[slot])
            if k == "h":
                np.testing.assert_allclose(np.moveaxis(tcache[k].numpy(), 2, 0)[slot],
                                           np.moveaxis(np.asarray(jcache[k]), 2, 0)[slot],
                                           **STATE_TOL)
            else:
                np.testing.assert_array_equal(after[slot], jafter[slot])


def test_a_step_at_position_0_starts_from_a_zero_state(pair):
    """Over a random cache, slots at positions (0, 3, 0, 7) with slot 2
    masked, at drop-free capacity: slot 0's Mamba layers start from a zero
    ``h`` and ``conv`` (its logits and new state are the bits of a step over
    a zeroed state), slots 1 and 3 from their own (the bits of the step at
    nonzero positions), and the masked slot 2 keeps its state's bits though
    its position is 0."""
    from _torch_port import to_torch

    cfg, *_, tparams = pair
    tmodel = TorchModel(_drop_free(cfg), device="cpu")
    junk = {k: to_torch(v) for k, v in _junk_cache(cfg, 4, 12, seed=9).items()}
    tokens = torch.tensor([[4], [9], [17], [30]], dtype=torch.int32)
    mask = torch.tensor([True, True, False, True])

    def step(cache, pos):
        cache = {k: v.clone() for k, v in cache.items()}
        logits, cache = tmodel.decode_step(tparams, cache, tokens, torch.tensor(pos), mask)
        return logits, cache

    zeroed = {k: torch.zeros_like(v) if k in ("h", "conv") else v for k, v in junk.items()}
    got, after = step(junk, [0, 3, 0, 7])
    fresh, fresh_after = step(zeroed, [0, 3, 0, 7])
    carried, carried_after = step(junk, [5, 3, 5, 7])
    assert torch.equal(got[0], fresh[0]) and torch.equal(got[[1, 3]], carried[[1, 3]])
    for k in ("h", "conv"):
        assert torch.equal(after[k][:, :, 0], fresh_after[k][:, :, 0])
        assert torch.equal(after[k][:, :, [1, 3]], carried_after[k][:, :, [1, 3]])
        assert torch.equal(after[k][:, :, 2], junk[k][:, :, 2])
        assert not torch.equal(after[k][:, :, 0], carried_after[k][:, :, 0])


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_the_cache_ignores_cache_quant(pair, quant):
    """The reference's attention quantizes only a cache with ``k_scale``,
    and its hybrid cache has none: with ``cache_quant="int8"`` both caches
    keep bf16 ``k``/``v`` and no scales, and the port's decode gives the
    logits of the unquantized model bit for bit."""
    from repro.models.model import Model

    cfg, _, _, tmodel, tparams = pair
    qcfg = dataclasses.replace(cfg, cache_quant=quant)
    want = Model(qcfg).init_cache(2, 8, concrete=False)
    qmodel = TorchModel(qcfg, device="cpu")
    got = qmodel.init_cache(2, 8)
    assert sorted(got) == sorted(want) == ["conv", "h", "k", "v"]
    for k, leaf in want.items():
        assert tuple(got[k].shape) == leaf.shape
        assert str(got[k].dtype).removeprefix("torch.") == str(leaf.dtype)
    toks = torch.from_numpy(_tokens(cfg, (2, 3)))
    plain, _ = _teacher_forced(tmodel.decode_step, tparams, tmodel.init_cache(2, 8), toks,
                               lambda t: t)
    quantized, _ = _teacher_forced(qmodel.decode_step, tparams, got, toks, lambda t: t)
    assert all(torch.equal(a, b) for a, b in zip(plain, quantized))


def test_prefill_chunk_probe_equals_jax(pair, monkeypatch):
    """A chunk of 3 valid steps of 6 for slot 1 while slot 0 rides along
    masked, over a random cache: the probe equals the reference's (every
    taken row clear, ``Logits``), slot 0's leaves keep their bits, and slot
    1's take the reference's."""
    import jax.numpy as jnp

    from _torch_port import to_torch

    cfg, jmodel, jparams, tmodel, tparams = pair
    junk = _junk_cache(cfg, 2, 12, seed=7)
    jcache = {k: jnp.asarray(v) for k, v in junk.items()}
    tcache = {k: to_torch(v) for k, v in junk.items()}
    chunk = np.array([4, 8, 15, 0, 0, 0], np.int32)
    pos0, n_valid, slot_mask = np.array([5, 2], np.int32), np.int32(3), np.array([False, True])
    logits = Logits(monkeypatch, jmodel, tmodel)
    jprobe, jcache = _jit(jmodel.prefill_chunk, "exact")(
        jparams, jcache, jnp.asarray(chunk), jnp.asarray(pos0), jnp.asarray(n_valid),
        jnp.asarray(slot_mask))
    tprobe, tcache = tmodel.prefill_chunk(
        tparams, tcache, torch.from_numpy(chunk), torch.from_numpy(pos0),
        torch.as_tensor(n_valid), torch.from_numpy(slot_mask))
    assert logits.assert_taken_rows_agree()[1] == 3
    np.testing.assert_array_equal(tprobe.numpy(), np.asarray(jprobe))
    for k in junk:
        ax = 2 if k in ("h", "conv") else 1
        np.testing.assert_array_equal(np.take(_bits(tcache[k]), 0, ax),
                                      np.take(_bits(junk[k]), 0, ax))
        np.testing.assert_allclose(np.take(tcache[k].float().numpy(), 1, ax),
                                   np.take(np.asarray(jcache[k], np.float32), 1, ax),
                                   **STATE_TOL)


# ------------------------------------------------------------------ serving


def _engine_run(engine_cls, request_cls, model, params, slots: int = len(PROMPTS),
                prompts=PROMPTS, **kw):
    """Every prompt through an engine of ``slots`` slots: with a slot for each
    prompt (the default) no slot is reused."""
    engine = engine_cls(model, params, max_slots=slots, max_len=32,
                        prefill_chunk=PREFILL_CHUNK, **kw)
    for i, p in enumerate(prompts):
        engine.submit(request_cls(uid=i, prompt=list(p), max_new_tokens=MAX_NEW))
    streams = {r.uid: r.generated for r in engine.run_until_done()}
    return streams, engine.config_traffic(), engine.sync_bytes


def _jax_engine_fns(jmodel, sampling: str) -> dict:
    """The JAX engine's ``compile_decode`` / ``compile_prefill`` jits at ``EXACT``."""
    decode = (functools.partial(jmodel.decode_and_sample, sample_backend="xla")
              if sampling == "fused" else jmodel.decode_step)
    return {"decode_fn": _jit(decode, "exact", donate_argnums=(1,)),
            "prefill_fn": _jit(jmodel.prefill_chunk, "exact", donate_argnums=(1,))}


@pytest.mark.parametrize("sampling", ["fused", "host"])
def test_engine_streams_equal_jax_engine(pair, monkeypatch, sampling):
    """A slot for each of three requests (each slot's first request fresh),
    chunked prefill, at ``EXACT``: streams, config traffic and host sync
    bytes equal the JAX engine's, and every taken row of every step is
    bit-identical or clear (``Logits``)."""
    from repro.serving import Request as JaxRequest
    from repro.serving import ServingEngine as JaxEngine
    from repro_torch.serving import Request, ServingEngine

    _, jmodel, jparams, tmodel, tparams = pair
    logits = Logits(monkeypatch, jmodel, tmodel)
    want = _engine_run(JaxEngine, JaxRequest, jmodel, jparams, sampling=sampling,
                       **_jax_engine_fns(jmodel, sampling))
    got = _engine_run(ServingEngine, Request, tmodel, tparams, sampling=sampling)
    assert logits.assert_taken_rows_agree()[1] >= MAX_NEW * len(PROMPTS)
    assert sorted(len(g) for g in got[0].values()) == [MAX_NEW] * len(PROMPTS)
    assert got == want


@pytest.mark.parametrize("sampling", ["fused", "host"])
def test_a_reused_slot_serves_as_a_fresh_one(pair, sampling):
    """Two slots over the three prompts and then the same three again, at
    drop-free capacity (else a stream depends on which requests share its
    experts' slots): each copy lands in a slot another request has freed,
    and its stream equals the original's, which ran in a fresh slot."""
    from repro_torch.serving import Request, ServingEngine

    cfg, *_, tparams = pair
    tmodel = TorchModel(_drop_free(cfg), device="cpu")
    n = len(PROMPTS)
    streams, *_ = _engine_run(ServingEngine, Request, tmodel, tparams, slots=2,
                              prompts=PROMPTS * 2, sampling=sampling)
    assert sorted(streams) == list(range(2 * n))
    for uid in range(n):
        assert len(streams[uid]) == MAX_NEW
        assert streams[uid + n] == streams[uid]


def test_the_reference_reads_a_freed_slots_state_on(pair):
    """The divergence the port settles: the reference's engine frees a slot
    by setting its position to 0, and ``mamba_step`` reads no position, so a
    request in a freed slot starts from its last occupant's ``h`` and
    ``conv``; in the run of ``test_a_reused_slot_serves_as_a_fresh_one``
    its copies' streams differ from their originals' (at drop-free capacity,
    so nothing but the state tells the runs apart)."""
    from repro.models.model import Model
    from repro.serving import Request as JaxRequest
    from repro.serving import ServingEngine as JaxEngine

    cfg, _, jparams, *_ = pair
    jmodel = Model(_drop_free(cfg))
    n = len(PROMPTS)
    streams, *_ = _engine_run(JaxEngine, JaxRequest, jmodel, jparams, slots=2,
                              prompts=PROMPTS * 2, sampling="fused",
                              **_jax_engine_fns(jmodel, "fused"))
    assert any(streams[uid + n] != streams[uid] for uid in range(n))


@pytest.mark.parametrize("mode", MODES)
def test_serve_ids_equal_jax(pair, monkeypatch, mode):
    """``launch.serve``'s loop in each mode against the reference's loop at
    ``EXACT``: the ids equal, every step's rows bit-identical or clear."""
    from test_torch_serve import _jax_serve

    _, jmodel, jparams, tmodel, tparams = pair
    logits = Logits(monkeypatch, jmodel, tmodel)
    want, _ = _jax_serve(jmodel, jparams, mode, **SERVE, compiler_options=EXACT)
    run = serve(tmodel, tparams, mode=mode, **SERVE)
    assert logits.assert_taken_rows_agree()[1] == SERVE["batch"] * SERVE["steps"]
    produced = SERVE["steps"] - (SERVE["fuse"] if mode == "fused" else 1)
    assert tuple(run.ids.shape) == (produced, SERVE["batch"])
    np.testing.assert_array_equal(run.ids.numpy(), want)


# ----------------------------------------------------------------- training


def _grads(model, params, batch: dict):
    from repro_torch.tree import leaves, unflatten

    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss, parts = model.loss(unflatten(params, flat),
                             {k: torch.from_numpy(v) for k, v in batch.items()})
    return loss, parts, torch.autograd.grad(loss, flat)


def test_loss_and_gradients_match_jax(pair):
    """``Model.loss`` at B = 2, S = 16 on the reference's data stream: the
    loss and its parts (the MoE aux loss included) equal the reference's
    jitted ``value_and_grad`` at ``EXACT`` to f32 rounding, and every
    gradient leaf within relative L2 ``GRAD_REL_L2``."""
    import jax

    from repro.data.pipeline import SyntheticLMDataset

    cfg, jmodel, jparams, tmodel, tparams = pair
    batch = SyntheticLMDataset(cfg.vocab_size, 16, 2, seed=1).batch(0)
    (jloss, jparts), jgrads = _jit(jax.value_and_grad(jmodel.loss, has_aux=True), "exact")(
        jparams, batch)
    loss, parts, grads = _grads(tmodel, tparams, batch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    for k in ("ce", "zloss", "moe_aux"):
        np.testing.assert_allclose(float(parts[k].detach()), float(jparts[k]), rtol=1e-6)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(grads) == 28
    for (path, j), t in zip(jflat, grads):
        j = np.asarray(j, np.float32)
        assert tuple(t.shape) == j.shape, path
        rel = np.linalg.norm(j - t.float().numpy()) / max(np.linalg.norm(j), 1e-30)
        assert rel <= GRAD_REL_L2, (jax.tree_util.keystr(path), rel)


def test_remat_full_gives_the_gradients_of_none(pair):
    """Checkpointing a group changes memory, not numbers: the loss, its
    parts and every gradient leaf at ``remat="full"`` equal ``"none"``'s
    bit for bit."""
    from repro.data.pipeline import SyntheticLMDataset

    cfg, *_, tparams = pair
    batch = SyntheticLMDataset(cfg.vocab_size, 16, 2, seed=1).batch(0)
    runs = [_grads(TorchModel(dataclasses.replace(cfg, remat=r), device="cpu"), tparams, batch)
            for r in ("none", "full")]
    (loss, parts, grads), (rloss, rparts, rgrads) = runs
    assert torch.equal(rloss, loss) and all(torch.equal(rparts[k], parts[k]) for k in parts)
    assert all(torch.equal(a, b) for a, b in zip(rgrads, grads))


# ------------------------------------------------------------------- card


def _cuda_model():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: greedy_sample, top_k and CUDA graphs have "
                    "no CPU mode")
    model = TorchModel(dataclasses.replace(torch_get(ARCH).reduced(), remat="none"),
                       device="cuda")
    return model, model.init(SEED)


@pytest.mark.gpu
def test_cuda_masked_fused_step_makes_no_read_back():
    """One masked ``decode_and_sample`` step on the card under
    ``set_sync_debug_mode("error")``: nothing reads the card back, so a
    CUDA graph can capture it; the masked row's ``k``, ``v``, ``h`` and
    ``conv`` keep their bits, at their addresses."""
    model, params = _cuda_model()
    b = 4
    cache = model.init_cache(b, 8)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for v in cache.values():
        v.copy_(torch.randn(v.shape, generator=gen, device="cuda").to(v.dtype))
    ones = torch.ones((b, 1), dtype=torch.int32, device="cuda")
    overrides = torch.zeros((b,), dtype=torch.int32, device="cuda")
    pos = torch.tensor([0, 3, 5, 0], dtype=torch.int32, device="cuda")
    live = torch.tensor([True, True, True, False], device="cuda")
    model.decode_and_sample(params, {k: v.clone() for k, v in cache.items()}, ones, overrides,
                            live, pos, live)  # builds the kernels
    before = {k: v.clone() for k, v in cache.items()}
    addresses = {k: v.data_ptr() for k, v in cache.items()}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ids, out = model.decode_and_sample(params, cache, ones, overrides, live, pos, live)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert out is cache and ids.shape == (b, 1)
    for k, v in cache.items():
        ax = 2 if k in ("h", "conv") else 1
        assert v.data_ptr() == addresses[k]
        assert torch.equal(v.select(ax, 3), before[k].select(ax, 3))
        assert not torch.equal(v.select(ax, 1), before[k].select(ax, 1))


@pytest.mark.gpu
def test_cuda_fused_graph_replay_equals_the_eager_steps():
    """On the card: the fused mode's graph replays give the eager loop's
    ids bit for bit, with one greedy_sample launch a token; sequential,
    concurrent and fused at ``fuse = 1`` agree."""
    from test_torch_serve import _eager_fused_ids

    model, params = _cuda_model()
    run = serve(model, params, mode="fused", **SERVE)
    assert run.sample_launches == run.produced == SERVE["steps"] - SERVE["fuse"]
    torch.testing.assert_close(run.ids, _eager_fused_ids(model, params, **SERVE), rtol=0, atol=0)
    seq = serve(model, params, mode="sequential", **SERVE)
    for mode, fuse in (("concurrent", SERVE["fuse"]), ("fused", 1)):
        torch.testing.assert_close(serve(model, params, mode=mode, **{**SERVE, "fuse": fuse}).ids,
                                   seq.ids, rtol=0, atol=0)


@pytest.mark.gpu
def test_cuda_mamba_step_ignores_the_tf32_switches():
    """The state contraction and the convolution sum elementwise products,
    so a Mamba step's state and output are the same bits with PyTorch's
    TF32 switches on and off."""
    model, params = _cuda_model()
    cfg = model.cfg
    d_in = cfg.ssm_expand * cfg.d_model
    gen = torch.Generator(device="cuda").manual_seed(2)
    x = torch.randn((4, 1, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    state = {"h": torch.randn((4, d_in, cfg.ssm_state_dim), generator=gen, device="cuda"),
             "conv": torch.randn((4, cfg.ssm_conv_dim, d_in), generator=gen,
                                 device="cuda").to(torch.bfloat16)}
    lp = {k: v[0, 0] for k, v in params["groups"]["mamba"].items()}
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    outs = []
    try:
        for tf32 in (False, True):
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
            y, st = TL.mamba_step(lp, cfg, x, state)
            outs.append((y, st["h"], st["conv"]))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
    assert all(torch.equal(a, b) for a, b in zip(*outs))
