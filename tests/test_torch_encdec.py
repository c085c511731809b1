"""The port's encoder-decoder (encdec) family against the JAX package's, on
the same parameters.

The reduced whisper-medium (2 encoder and 2 decoder layers, d_model 64, 4
heads over 2 KV heads of 16, d_ff 128, 16 frames, vocab 256) runs in both
packages on the CPU, its weights drawn by the JAX ``Model.init`` and
carried across through ``models.convert``; inputs (frames, tokens, caches)
are drawn with numpy from a seed and given to both.

Tolerances. Every bf16 op of the port rounds as written, as eager JAX does
and as jitted JAX does with ``xla_allow_excess_precision`` off (``EXACT``).
Even then a bf16 product rounds apart in about one element in 2,000 (the
two frameworks sum in other orders on the CPU), and non-causal attention
spreads each such element over the whole window. So single layers are held
to ``LAYER_TOL`` with at least ``LAYER_BITS`` of their elements
bit-identical, whole models to ``test_decode_parity``'s tolerances, and at
``EXACT`` also to ``MODEL_ATOL``. Runs that sample ids record the logits of
every ``decode_step`` of both packages (``test_torch_ssm.Logits``): each
taken row is bit-identical or has a JAX top-two margin above twice its
largest gap to the port's, so the ids compared cannot have met a tie the
two sides round apart.

The reference never fills the cross-attention's ``xk``/``xv``: its
``init_cache`` gives zeros and no function of the JAX package writes them,
so a decode over them adds exactly 0 from cross-attention. The tests
therefore also write seeded ``xk``/``xv`` into both caches, and in the
engine tests the reference's own encoder output (recorded from its
``forward``) projected by each layer's ``cross_attn.wk``/``wv``.

JAX is imported inside the CPU tests, so the ``gpu`` tests also collect on a
machine without it."""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import get as torch_get
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from test_torch_ssm import Logits, _bits, _jax_engine_fns

ARCH = "whisper-medium"
SEED = 0
EXACT = {"xla_allow_excess_precision": False}  # the reference rounding bf16 as written
RTOL, ATOL, TOP1 = 0.05, 0.15, 0.9  # tests/test_decode_parity.py
LAYER_TOL = dict(rtol=2 ** -7, atol=2 ** -7)  # test_layers_match_jax's
LAYER_BITS = 0.98  # share of a layer's bf16 outputs bit-identical at EXACT
MODEL_ATOL = 2 ** -5  # a whole model's logits at EXACT
PROMPTS = [[5, 9, 2], [7, 1], [3, 3, 3, 3]]
MAX_NEW, PREFILL_CHUNK, MAX_LEN = 4, 2, 32
WHISPER_V = 51_865


@pytest.fixture(scope="module")
def pair():
    return _pair_of(SEED)


@functools.cache
def _pair_of(seed: int):
    from _torch_port import reduced_pair

    return reduced_pair(seed, ARCH)


def _jit(fn, precision: str, **kw):
    import jax

    return jax.jit(fn, compiler_options=EXACT if precision == "exact" else None, **kw)


def _assert_layer_close(got, want):
    from _torch_port import to_numpy32

    assert got.dtype == torch.bfloat16 and tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(to_numpy32(got), to_numpy32(want), **LAYER_TOL)
    assert (_bits(got) == _bits(want)).mean() >= LAYER_BITS


def _assert_logits_close(want, got, precision: str = "xla"):
    from _torch_port import to_numpy32

    a, b = to_numpy32(want), to_numpy32(got)
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= TOP1
    if precision == "exact":
        np.testing.assert_allclose(b, a, rtol=0, atol=MODEL_ATOL)


def _bf16(shape, seed: int, scale: float = 1.0):
    import jax.numpy as jnp

    return jnp.asarray(np.random.default_rng(seed).standard_normal(shape) * scale, jnp.bfloat16)


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _frames(cfg, b: int, seed: int = 3):
    return _bf16((b, cfg.encoder_seq_len, cfg.d_model), seed)


def _cross(cfg, b: int, seed: int = 7) -> dict:
    """Seeded ``xk``/``xv`` (n_layers, B, encoder_seq_len, Hkv, D) bf16."""
    shape = (cfg.n_layers, b, cfg.encoder_seq_len, cfg.n_kv_heads, cfg.head_dim_)
    return {"xk": _bf16(shape, seed), "xv": _bf16(shape, seed + 1)}


def _reference_encoder_output(monkeypatch, jmodel, jparams, frames, precision: str):
    """The encoder output of the reference's own ``forward`` at
    ``precision``: the ``kv`` its decoder layers pass to
    ``attention_apply``, read by an ordered debug callback."""
    import jax
    import jax.numpy as jnp

    from repro.models import layers as JL

    seen, apply = [], JL.attention_apply

    def recording(*args, kv=None, **kw):
        if kv is not None:
            jax.debug.callback(lambda e: seen.append(np.asarray(e)), kv, ordered=True)
        return apply(*args, kv=kv, **kw)

    jax.clear_caches()  # a function traced before would skip the recorder
    monkeypatch.setattr(JL, "attention_apply", recording)
    toks = jnp.zeros((frames.shape[0], 1), jnp.int32)
    jax.block_until_ready(_jit(jmodel.forward, precision)(
        jparams, {"frontend_embeds": frames, "tokens": toks}))
    monkeypatch.setattr(JL, "attention_apply", apply)
    jax.clear_caches()
    assert seen and all(np.array_equal(s.view(np.int16), seen[0].view(np.int16)) for s in seen)
    return jnp.asarray(seen[0])


def _jax_cross_kv(cfg, jparams, enc, precision: str) -> dict:
    """The reference's cross-attention K and V of ``enc``: each decoder
    layer's ``src @ wk`` / ``src @ wv`` (``layers.attention_apply``)."""
    import jax.numpy as jnp

    def kv(params, enc):
        ca = params["dec_layers"]["cross_attn"]
        b, t, _ = enc.shape

        def heads(w):
            return jnp.stack([(enc @ w[i]).reshape(b, t, cfg.n_kv_heads, -1)
                              for i in range(cfg.n_layers)])

        return {"xk": heads(ca["wk"]), "xv": heads(ca["wv"])}

    return _jit(kv, precision)(jparams, enc)


# ------------------------------------------------------------ configuration


def test_config_and_registry_match_reference():
    from repro.configs import get

    assert dataclasses.asdict(torch_get(ARCH)) == dataclasses.asdict(get(ARCH))
    cfg = torch_get(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.n_encoder_layers, cfg.d_model, cfg.n_heads,
            cfg.n_kv_heads, cfg.d_ff, cfg.vocab_size, cfg.encoder_seq_len, cfg.mlp_kind,
            cfg.tie_embeddings) == ("encdec", 24, 24, 1024, 16, 16, 4096, 51_865, 1500, "gelu",
                                    True)
    reduced = TM.Model(torch_get(ARCH).reduced(), device="cpu")
    assert reduced.cache_has_positions


def test_the_published_tree_counts_758_002_688_parameters():
    """whisper-medium whole: the reference's tree (shapes only) holds
    758,002,688 parameters, which ``chip_smoke.py`` counts from the port's
    tree on the card: the encoder layers' 302,088,192, the decoder layers'
    402,800,640, the tied embedding's 53,109,760 and two final LayerNorms
    of 2,048."""
    import jax

    from repro.configs import get
    from repro.models.model import Model

    tree = Model(get(ARCH)).abstract_params()
    count = lambda t: sum(int(np.prod(a.shape)) for a in jax.tree.leaves(t))  # noqa: E731
    assert count(tree) == 758_002_688
    assert count(tree["enc_layers"]) == 302_088_192
    assert count(tree["dec_layers"]) == 402_800_640
    assert count(tree["enc_final_norm"]) == count(tree["final_norm"]) == 2048
    assert count(tree["embed"]) == 53_109_760 and "head" not in tree


def test_init_draws_the_reference_tree(pair):
    """``enc_layers.{ln1, attn, ln2, mlp}``, ``enc_final_norm``,
    ``dec_layers.{ln1, self_attn, ln2, cross_attn, ln3, mlp}``, ``embed``
    and ``final_norm``, no ``head``: the reference's tree, shapes and
    dtypes; every norm a LayerNorm with a zero bias; the two-matrix GELU
    MLP; N(0, 1/fan_in) matrices drawn afresh a layer."""
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
    enc, dec = params["enc_layers"], params["dec_layers"]
    for norm in (params["final_norm"], params["enc_final_norm"], enc["ln1"], enc["ln2"],
                 dec["ln1"], dec["ln2"], dec["ln3"]):
        assert torch.equal(norm["w"], torch.ones_like(norm["w"]))
        assert torch.equal(norm["b"], torch.zeros_like(norm["b"]))
    assert sorted(enc["mlp"]) == sorted(dec["mlp"]) == ["wi", "wo"]
    for w, fan_in in ((enc["attn"]["wq"], cfg.d_model), (dec["cross_attn"]["wk"], cfg.d_model),
                      (dec["mlp"]["wo"], cfg.d_ff)):
        assert abs(w.float().std().item() * fan_in ** 0.5 - 1.0) < 0.1
    assert not torch.equal(dec["self_attn"]["wq"][0], dec["self_attn"]["wq"][1])
    torch.testing.assert_close(params["embed"], tmodel.init(3)["embed"], rtol=0, atol=0)


def test_params_cross_bit_exactly(pair):
    import jax

    from repro_torch.dispatch.executor import flatten_with_path

    _, _, jparams, _, tparams = pair
    want = jax.tree_util.tree_flatten_with_path(jparams)[0]
    got = flatten_with_path(tparams)
    assert [jax.tree_util.keystr(k) for k, _ in want] == [k for k, _ in got]
    for (_, w), (_, g) in zip(want, got):
        np.testing.assert_array_equal(_bits(g), _bits(w))


# ----------------------------------------------------------- functions


@pytest.mark.parametrize("d", [64, 1024])
def test_sinusoidal_matches_jax(d):
    """Positions 0-1,499 (a whole 30 s window): at most one element in a
    thousand differs, by one bf16 step (2^-8 below 1): the two frameworks'
    f32 ``exp`` give another last bit for a tenth of the frequencies."""
    import jax.numpy as jnp

    from _torch_port import to_numpy32
    from repro.models import model as JM

    pos = np.arange(1500, dtype=np.int32)
    want = JM._sinusoidal(jnp.asarray(pos), d)
    got = TM._sinusoidal(torch.from_numpy(pos), d)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape == (1500, d)
    assert (_bits(got) != _bits(want)).mean() <= 1e-3
    np.testing.assert_allclose(to_numpy32(got), to_numpy32(want), rtol=0, atol=2 ** -8)


def test_gelu_rounds_as_the_reference():
    """``jax.nn.gelu`` on bf16 rounds each op of its tanh approximation;
    the port's ``_gelu`` does the same and equals it on every one of
    200,000 seeded inputs, where ``F.gelu``, rounding once, differs on
    about four in ten (either approximation)."""
    import jax

    from _torch_port import to_torch

    x = _bf16((200_000,), 12, scale=3.0)
    want = _bits(jax.jit(jax.nn.gelu)(x))
    np.testing.assert_array_equal(_bits(TL._gelu(to_torch(x))), want)
    for approximate in ("tanh", "none"):
        f = torch.nn.functional.gelu(to_torch(x), approximate=approximate)
        assert (_bits(f) != want).mean() > 0.3


def _layer0(pair, trunk: str) -> tuple[dict, dict]:
    import jax

    from _torch_port import to_torch

    _, _, jparams, _, _ = pair
    lp = jax.tree.map(lambda a: a[0], jparams[trunk])
    return lp, jax.tree.map(to_torch, lp)


@pytest.mark.parametrize("precision", ["exact", "xla"])
def test_gelu_mlp_matches_jax(pair, precision):
    from _torch_port import to_torch
    from repro.models import layers as JL

    cfg = pair[0]
    jlp, tlp = _layer0(pair, "enc_layers")
    x = _bf16((2, 7, cfg.d_model), 8)
    want = _jit(JL.mlp_apply, precision)(jlp["mlp"], x)
    _assert_layer_close(TL.mlp_apply(tlp["mlp"], to_torch(x)), want)


@pytest.mark.parametrize("precision", ["exact", "xla"])
@pytest.mark.parametrize("kind", ["encoder", "decoder_self", "cross"])
def test_attention_apply_matches_jax(pair, kind, precision):
    """The three full-sequence forms: the encoder's non-causal unrotated
    self-attention, the decoder's causal unrotated self-attention, and
    cross-attention to a (B, 16, d) encoder output (K and V from ``kv``)."""
    from _torch_port import to_torch
    from repro.models import layers as JL

    cfg = pair[0]
    jlp, tlp = _layer0(pair, "enc_layers" if kind == "encoder" else "dec_layers")
    name = {"encoder": "attn", "decoder_self": "self_attn", "cross": "cross_attn"}[kind]
    kw = {"encoder": dict(causal=False), "decoder_self": dict(causal=True),
          "cross": dict(causal=False)}[kind]
    x = _bf16((2, 7 if kind != "encoder" else cfg.encoder_seq_len, cfg.d_model), 9)
    enc = _bf16((2, cfg.encoder_seq_len, cfg.d_model), 10) if kind == "cross" else None

    def ref(p, x, enc):
        return JL.attention_apply(p, cfg, x, None, use_rope=False, kv=enc, **kw)[0]

    want = _jit(ref, precision)(jlp[name], x, enc)
    got = TL.attention_apply(tlp[name], cfg, to_torch(x), None, use_rope=False,
                             kv=None if enc is None else to_torch(enc), **kw)
    _assert_layer_close(got, want)
    if kind == "decoder_self":  # the causal mask holds: position 0 sees itself alone
        alone = TL.attention_apply(tlp[name], cfg, to_torch(x)[:, :1], None, use_rope=False)
        torch.testing.assert_close(got[:, :1], alone, rtol=0, atol=0)


@pytest.mark.parametrize("precision", ["exact", "xla"])
def test_decoder_self_attention_on_a_cache_matches_jax(pair, precision):
    """One token a slot at per-slot positions over a random cache, slot 1
    masked out: the output of every row within ``LAYER_TOL`` of JAX's, the
    selected rows' K/V written where JAX writes them, the masked row's
    cache bit-identical."""
    import jax.numpy as jnp

    from _torch_port import to_numpy32, to_torch
    from repro.models import layers as JL

    cfg = pair[0]
    jlp, tlp = _layer0(pair, "dec_layers")
    b, t = 3, 12
    shape = (b, t, cfg.n_kv_heads, cfg.head_dim_)
    cache = {"k": _bf16(shape, 11), "v": _bf16(shape, 12)}
    x = _bf16((b, 1, cfg.d_model), 13)
    pos = np.array([4, 7, 0], np.int32)
    mask = np.array([True, False, True])

    def ref(p, x, cache, pos):
        return JL.attention_apply(p, cfg, x, pos[:, None], use_rope=False, cache=cache,
                                  cache_pos=pos)

    want, jcache = _jit(ref, precision)(jlp["self_attn"], x, cache, jnp.asarray(pos))
    tcache = {k: to_torch(v) for k, v in cache.items()}
    got = TL.attention_apply(tlp["self_attn"], cfg, to_torch(x), None, use_rope=False,
                             cache=tcache, cache_pos=torch.from_numpy(pos),
                             update_mask=torch.from_numpy(mask))
    _assert_layer_close(got, want)
    for k in ("k", "v"):
        np.testing.assert_array_equal(_bits(tcache[k])[1], _bits(cache[k])[1])
        for r in (0, 2):
            np.testing.assert_allclose(to_numpy32(tcache[k][r, pos[r]]),
                                       to_numpy32(jcache[k][r, pos[r]]), **LAYER_TOL)


# -------------------------------------------------------------- whole model


@pytest.mark.parametrize("precision", ["exact", "xla"])
def test_forward_matches_jax(pair, precision):
    """Encoder and decoder: the logits of 8 tokens over a 16-frame window."""
    import jax.numpy as jnp

    from _torch_port import to_torch

    cfg, jmodel, jparams, tmodel, tparams = pair
    frames, toks = _frames(cfg, 2), _tokens(cfg, (2, 8))
    want, want_aux = _jit(jmodel.forward, precision)(
        jparams, {"frontend_embeds": frames, "tokens": jnp.asarray(toks)})
    got, aux = tmodel.forward(tparams, {"frontend_embeds": to_torch(frames),
                                        "tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16 and float(aux) == float(want_aux) == 0.0
    assert tuple(got.shape) == (2, 8, cfg.vocab_size)
    _assert_logits_close(want, got, precision)


@pytest.mark.parametrize("precision", ["exact", "xla"])
def test_encoder_and_cross_kv_match_the_references(pair, monkeypatch, precision):
    """The port's ``encode`` against the encoder output the reference's
    ``forward`` hands its cross-attention, and ``cross_kv`` against that
    output's projections: the cross-attention K and V a caller writes into
    a cache."""
    from _torch_port import to_torch

    cfg, jmodel, jparams, tmodel, tparams = pair
    frames = _frames(cfg, 2)
    want = _reference_encoder_output(monkeypatch, jmodel, jparams, frames, precision)
    enc = tmodel.encode(tparams, to_torch(frames))
    assert enc.dtype == torch.bfloat16 and tuple(enc.shape) == want.shape
    _assert_logits_close(want, enc, precision)
    jkv = _jax_cross_kv(cfg, jparams, want, precision)
    xk, xv = tmodel.cross_kv(tparams, to_torch(want))  # the same encoder output
    assert tuple(xk.shape) == (cfg.n_layers, 2, cfg.encoder_seq_len, cfg.n_kv_heads,
                               cfg.head_dim_)
    _assert_layer_close(xk, jkv["xk"])
    _assert_layer_close(xv, jkv["xv"])


def _write_cross(tcache: dict, jcache: dict, cross: dict) -> dict:
    """The same ``xk``/``xv`` bits into the port's cache (in place) and the
    JAX one (returned)."""
    from _torch_port import to_torch

    for k, v in cross.items():
        tcache[k].copy_(to_torch(v))
    return {**jcache, **cross}


@pytest.mark.parametrize("positions", ["int", "per_slot"])
@pytest.mark.parametrize("precision", ["exact", "xla"])
def test_teacher_forced_decode_matches_jax(pair, precision, positions):
    """Eight teacher-forced steps over seeded ``xk``/``xv``, the position an
    int or a (B,) vector: the port's logits against JAX's steps, and the
    K/V rows written against JAX's."""
    import jax.numpy as jnp

    from _torch_port import to_numpy32

    cfg, jmodel, jparams, tmodel, tparams = pair
    b, s = 2, 8
    toks = _tokens(cfg, (b, s))
    tcache = tmodel.init_cache(b, s)
    jcache = _write_cross(tcache, jmodel.init_cache(b, s), _cross(cfg, b))
    step = _jit(jmodel.decode_step, precision)
    want, got = [], []
    for i in range(s):
        jpos, tpos = ((jnp.int32(i), i) if positions == "int" else
                      (jnp.full((b,), i, jnp.int32), torch.full((b,), i, dtype=torch.int32)))
        lj, jcache = step(jparams, jcache, jnp.asarray(toks[:, i:i + 1]), jpos)
        lt, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(toks[:, i:i + 1]), tpos)
        want.append(to_numpy32(lj[:, 0]))
        got.append(lt[:, 0].float().numpy())
    _assert_logits_close(np.stack(want, 1), np.stack(got, 1), precision)
    tol = LAYER_TOL if precision == "exact" else dict(rtol=RTOL, atol=ATOL)
    for k in ("k", "v"):
        np.testing.assert_allclose(to_numpy32(tcache[k]), to_numpy32(jcache[k]), **tol)
    for k in ("xk", "xv"):
        np.testing.assert_array_equal(_bits(tcache[k]), _bits(jcache[k]))


def test_cross_attention_reads_the_cross_cache(pair):
    """The seeded ``xk``/``xv`` move the logits (zeros add exactly nothing,
    so a wrong index into them would not show), and each slot reads its
    own: swapping two slots' ``xk``/``xv`` swaps their logits."""
    cfg, *_, tmodel, tparams = pair
    b = 2
    toks = torch.from_numpy(_tokens(cfg, (b, 1)))
    same = torch.from_numpy(np.array([[17], [17]], np.int32))

    def step(cross: dict | None, tokens) -> torch.Tensor:
        cache = tmodel.init_cache(b, 4)
        if cross is not None:
            _write_cross(cache, {}, cross)
        return tmodel.decode_step(tparams, cache, tokens, 0)[0]

    cross = _cross(cfg, b)
    swapped = {k: v[:, ::-1] for k, v in cross.items()}
    assert not torch.equal(step(None, toks), step(cross, toks))
    one, two = step(cross, same), step(swapped, same)
    assert not torch.equal(one[0], one[1])
    torch.testing.assert_close(two, one.flip(0), rtol=0, atol=0)


def _random_cache(tmodel, cfg, b: int, t: int, seed: int = 5) -> dict:
    import jax.numpy as jnp

    shape = (cfg.n_layers, b, t, cfg.n_kv_heads, cfg.head_dim_)
    rng = np.random.default_rng(seed)
    cache = {k: jnp.asarray(rng.standard_normal(shape), jnp.bfloat16) for k in ("k", "v")}
    return {**cache, **_cross(cfg, b, seed + 1)}


@pytest.mark.parametrize("masked", [True, False])
def test_decode_step_leaves_the_cross_cache_where_and_as_it_was(pair, masked):
    """One step over a random cache, slots at positions (5, 2, 9, 40) of 16,
    slots 1 and 3 masked out (or no mask, and slot 3 at 11): every row's
    logits against JAX's; the masked rows' ``k``/``v`` bit-identical (as
    JAX's), the selected rows' new K/V written where JAX writes them;
    ``xk``/``xv`` keep their address and every bit, as every leaf keeps its
    address."""
    import jax.numpy as jnp

    from _torch_port import to_numpy32, to_torch

    cfg, jmodel, jparams, tmodel, tparams = pair
    junk = _random_cache(tmodel, cfg, 4, 16)
    tokens = np.array([[4], [9], [17], [30]], np.int32)
    pos = np.array([5, 2, 9, 40 if masked else 11], np.int32)
    mask = np.array([True, False, True, False]) if masked else None
    tcache = {k: to_torch(v) for k, v in junk.items()}
    addresses = {k: v.data_ptr() for k, v in tcache.items()}
    want, jcache = _jit(jmodel.decode_step, "exact")(
        jparams, junk, jnp.asarray(tokens), jnp.asarray(pos),
        None if mask is None else jnp.asarray(mask))
    got, out = tmodel.decode_step(tparams, tcache, torch.from_numpy(tokens),
                                  torch.from_numpy(pos),
                                  None if mask is None else torch.from_numpy(mask))
    assert out is tcache
    _assert_logits_close(want, got, "exact")
    for k, before in junk.items():
        assert tcache[k].data_ptr() == addresses[k]
        after = _bits(tcache[k])
        if k in ("xk", "xv"):
            np.testing.assert_array_equal(after, _bits(before))
            continue
        live = (0, 2) if masked else (0, 1, 2, 3)
        for slot in range(4):
            if slot not in live:
                np.testing.assert_array_equal(after[:, slot], _bits(before)[:, slot])
                np.testing.assert_array_equal(_bits(jcache[k])[:, slot], _bits(before)[:, slot])
                continue
            p = pos[slot]
            np.testing.assert_allclose(to_numpy32(tcache[k])[:, slot, p],
                                       to_numpy32(jcache[k])[:, slot, p], **LAYER_TOL)
            rest = np.arange(16) != p
            np.testing.assert_array_equal(after[:, slot, rest], _bits(before)[:, slot, rest])


@pytest.mark.parametrize("masked", [True, False])
def test_a_decode_step_reads_the_cross_cache_in_place(pair, masked):
    """Every operation of a decode step (slots 1 and 3 masked out, or no
    mask) that takes ``xk`` or ``xv``, or a view of them, is a view or a
    ``bmm``: nothing copies them, not even into a temporary."""
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    from _torch_port import to_torch

    cfg, *_, tmodel, tparams = pair
    cache = {k: to_torch(v) for k, v in _random_cache(tmodel, cfg, 4, 16).items()}
    cross = {cache[k].untyped_storage().data_ptr() for k in ("xk", "xv")}
    readers = []

    def on_cross(x) -> bool:
        return isinstance(x, torch.Tensor) and x.untyped_storage().data_ptr() in cross

    class Watch(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            if any(map(on_cross, tree_leaves((args, kwargs)))) and not all(
                    map(on_cross, tree_leaves(out))):
                readers.append(str(func))
            return out

    mask = torch.tensor([True, False, True, False]) if masked else None
    with Watch():
        tmodel.decode_step(tparams, cache, torch.tensor([[4], [9], [17], [30]]),
                           torch.tensor([5, 2, 9, 11], dtype=torch.int32), mask)
    assert readers and set(readers) == {"aten.bmm.default"}
    assert len(readers) == 2 * 4 * cfg.n_layers  # scores and combine, a batch row each


def test_forward_equals_its_own_teacher_forced_decode(pair):
    """The port's two paths: ``forward`` over frames and tokens, and
    teacher-forced ``decode_step`` over ``xk``/``xv`` the port's own
    ``encode`` and ``cross_kv`` made of the same frames, at
    ``test_decode_parity``'s tolerances (on the CPU, bit for bit)."""
    from _torch_port import to_torch

    cfg, *_, tmodel, tparams = pair
    b, s = 2, 8
    frames, toks = to_torch(_frames(cfg, b)), torch.from_numpy(_tokens(cfg, (b, s)))
    full, _ = tmodel.forward(tparams, {"frontend_embeds": frames, "tokens": toks})
    cache = tmodel.init_cache(b, s)
    xk, xv = tmodel.cross_kv(tparams, tmodel.encode(tparams, frames))
    cache["xk"].copy_(xk)
    cache["xv"].copy_(xv)
    steps = []
    for i in range(s):
        lg, cache = tmodel.decode_step(tparams, cache, toks[:, i:i + 1], i)
        steps.append(lg[:, 0])
    got = torch.stack(steps, 1)
    _assert_logits_close(full, got)
    torch.testing.assert_close(got, full, rtol=0, atol=0)


def test_prefill_chunk_probe_equals_jax(pair, monkeypatch):
    """A chunk of 3 valid steps of 6 for slot 1 while slot 0 rides along
    masked, over a random cache: the probe equals JAX's (its rows clear,
    ``Logits``), slot 0's ``k``/``v`` keep their bits, ``xk``/``xv`` all of
    theirs."""
    import jax.numpy as jnp

    from _torch_port import to_torch

    cfg, jmodel, jparams, tmodel, tparams = pair
    junk = _random_cache(tmodel, cfg, 2, 16, seed=8)
    tcache = {k: to_torch(v) for k, v in junk.items()}
    chunk = np.array([4, 8, 15, 0, 0, 0], np.int32)
    pos0, n_valid, slot_mask = np.array([5, 2], np.int32), np.int32(3), np.array([False, True])
    logits = Logits(monkeypatch, jmodel, tmodel)
    jprobe, jcache = _jit(jmodel.prefill_chunk, "exact")(
        jparams, junk, jnp.asarray(chunk), jnp.asarray(pos0), jnp.asarray(n_valid),
        jnp.asarray(slot_mask))
    tprobe, tcache = tmodel.prefill_chunk(
        tparams, tcache, torch.from_numpy(chunk), torch.from_numpy(pos0),
        torch.as_tensor(n_valid), torch.from_numpy(slot_mask))
    assert logits.assert_taken_rows_agree()[1] == 3
    np.testing.assert_array_equal(tprobe.numpy(), np.asarray(jprobe))
    assert tprobe[0, 0] == 0 and tprobe.dtype == torch.int32
    for k in ("k", "v"):
        np.testing.assert_array_equal(_bits(tcache[k])[:, 0], _bits(junk[k])[:, 0])
    for k in ("xk", "xv"):
        np.testing.assert_array_equal(_bits(tcache[k]), _bits(junk[k]))


def _engine_run(engine_cls, request_cls, model, params, prompts=PROMPTS, *, slots=None,
                windows=None, write=None, **kw):
    """The prompts through an engine of ``slots`` slots (one a prompt by
    default), chunked prefill. ``write(engine)``, where given, runs before the
    first launch (the reference's way: its caller writes ``xk``/``xv`` into
    ``engine.cache``); ``windows[i]``, where given, is the ``cross_kv`` of
    the i-th request (the port's way)."""
    engine = engine_cls(model, params, max_slots=slots or len(prompts), max_len=MAX_LEN,
                        prefill_chunk=PREFILL_CHUNK, **kw)
    if write is not None:
        write(engine)
    for i, p in enumerate(prompts):
        extra = {} if windows is None else {"cross_kv": windows[i]}
        engine.submit(request_cls(uid=i, prompt=list(p), max_new_tokens=MAX_NEW, **extra))
    streams = {r.uid: r.generated for r in engine.run_until_done()}
    return streams, engine.config_traffic(), engine.sync_bytes


def _windows(xk, xv) -> list[tuple]:
    """Each slot's rows of ``xk``/``xv`` ((n_layers, B, T, Hkv, D) each) as
    one request's ``cross_kv``."""
    from _torch_port import to_torch

    xk, xv = (t if isinstance(t, torch.Tensor) else to_torch(t) for t in (xk, xv))
    return [(xk[:, i], xv[:, i]) for i in range(xk.shape[1])]


def _encoded_windows(tmodel, tparams, n: int, seed: int = 21) -> list[tuple]:
    """``n`` seeded 16-frame windows through the port's encoder and cross
    projections, one request's ``cross_kv`` each."""
    from _torch_port import to_torch

    frames = to_torch(_frames(tmodel.cfg, n, seed=seed))
    xk, xv = tmodel.cross_kv(tparams, tmodel.encode(tparams, frames))
    return _windows(xk, xv)


@pytest.mark.parametrize("cross", ["zero", "encoded"])
@pytest.mark.parametrize("sampling", ["fused", "host"])
def test_engine_streams_equal_jax_engine(monkeypatch, sampling, cross):
    """A slot for each of three requests, chunked prefill, over zero
    ``xk``/``xv`` (the reference's) or over each request's own 16-frame
    window through the reference's encoder and cross projections (written
    into the JAX engine's cache, carried by the port's requests): streams,
    config traffic and host sync bytes equal the JAX engine's; every taken
    row of every step is bit-identical or clear (``Logits``)."""
    import jax.numpy as jnp

    from repro.serving import Request as JaxRequest
    from repro.serving import ServingEngine as JaxEngine
    from repro_torch.serving import Request, ServingEngine

    cfg, jmodel, jparams, tmodel, tparams = _pair_of(SEED)
    write = windows = None
    if cross == "encoded":
        enc = _reference_encoder_output(monkeypatch, jmodel, jparams,
                                        _frames(cfg, len(PROMPTS), seed=21), "exact")
        kv = {k: np.asarray(v) for k, v in _jax_cross_kv(cfg, jparams, enc, "exact").items()}

        def write(engine):
            engine.cache = {**engine.cache, **{k: jnp.array(v) for k, v in kv.items()}}

        windows = _windows(kv["xk"], kv["xv"])
    logits = Logits(monkeypatch, jmodel, tmodel)
    want = _engine_run(JaxEngine, JaxRequest, jmodel, jparams, write=write,
                       sampling=sampling, **_jax_engine_fns(jmodel, sampling, "exact"))
    got = _engine_run(ServingEngine, Request, tmodel, tparams, windows=windows,
                      sampling=sampling)
    taken = logits.assert_taken_rows_agree()[1]
    assert taken >= MAX_NEW * len(PROMPTS)
    assert sorted(len(g) for g in got[0].values()) == [MAX_NEW] * len(PROMPTS)
    assert got == want


def test_engine_streams_depend_on_the_cross_cache():
    """The same requests over zero and over encoded windows give other
    streams: the engine's decode reads the window each request carries."""
    from repro_torch.serving import Request, ServingEngine

    cfg, *_, tmodel, tparams = _pair_of(SEED)
    windows = _encoded_windows(tmodel, tparams, len(PROMPTS))
    zero, *_ = _engine_run(ServingEngine, Request, tmodel, tparams)
    encoded, *_ = _engine_run(ServingEngine, Request, tmodel, tparams, windows=windows)
    assert zero != encoded


@pytest.mark.parametrize("sampling", ["fused", "host"])
def test_a_reused_slot_reads_its_own_window(sampling):
    """Two slots over the three prompts, each with its own encoded window,
    and then the same three with the same windows again: each copy lands in
    a slot whose last occupant had another window (window 0 after 1, 1
    after 2, 2 after 0), and its stream equals the original's, which ran in
    a fresh slot, and is not the stream over zero windows."""
    from repro_torch.serving import Request, ServingEngine

    cfg, *_, tmodel, tparams = _pair_of(SEED)
    n = len(PROMPTS)
    windows = _encoded_windows(tmodel, tparams, n)
    streams, *_ = _engine_run(ServingEngine, Request, tmodel, tparams, PROMPTS * 2, slots=2,
                              windows=windows * 2, sampling=sampling)
    zero, *_ = _engine_run(ServingEngine, Request, tmodel, tparams, sampling=sampling)
    assert sorted(streams) == list(range(2 * n))
    for uid in range(n):
        assert len(streams[uid]) == MAX_NEW
        assert streams[uid + n] == streams[uid]
    assert [streams[uid] for uid in range(n)] != [zero[uid] for uid in range(n)]


def test_a_request_without_a_window_reads_zeros_in_a_reused_slot():
    """Requests without a window, each in a slot an encoded request freed,
    serve as over the zero ``xk``/``xv`` of a fresh engine."""
    from repro_torch.serving import Request, ServingEngine

    cfg, *_, tmodel, tparams = _pair_of(SEED)
    n = len(PROMPTS)
    zero, *_ = _engine_run(ServingEngine, Request, tmodel, tparams)
    windows = _encoded_windows(tmodel, tparams, n) + [None] * n
    streams, *_ = _engine_run(ServingEngine, Request, tmodel, tparams, PROMPTS * 2, slots=2,
                              windows=windows)
    assert [streams[uid + n] for uid in range(n)] == [zero[uid] for uid in range(n)]
    assert [streams[uid] for uid in range(n)] != [zero[uid] for uid in range(n)]


def test_the_reference_reads_a_freed_slots_window_on(pair):
    """The divergence the port settles: the reference's engine has no window
    in a request; its caller writes ``xk``/``xv`` once, and a request in a
    freed slot reads the window its last occupant read. Two slots over the
    prompts twice, slot i's cache holding window i: each copy lands in the
    other slot than its original's and reads the other window, and the
    copies' streams are not all their originals'."""
    import jax.numpy as jnp

    from repro.serving import Request as JaxRequest
    from repro.serving import ServingEngine as JaxEngine

    cfg, jmodel, jparams, *_ = pair
    n = len(PROMPTS)
    kv = {k: jnp.asarray(v) for k, v in _cross(cfg, 2, seed=31).items()}

    def write(engine):
        engine.cache = {**engine.cache, **kv}

    streams, *_ = _engine_run(JaxEngine, JaxRequest, jmodel, jparams, PROMPTS * 2, slots=2,
                              write=write, sampling="fused",
                              **_jax_engine_fns(jmodel, "fused", "exact"))
    assert any(streams[uid + n] != streams[uid] for uid in range(n))


def test_submit_checks_a_requests_window():
    """A window of another shape, or one given to a model with no
    cross-attention, is refused at ``submit``."""
    from repro_torch.serving import Request, ServingEngine

    cfg, *_, tmodel, tparams = _pair_of(SEED)
    engine = ServingEngine(tmodel, tparams, max_slots=2, max_len=MAX_LEN)
    xk, xv = _encoded_windows(tmodel, tparams, 1)[0]
    with pytest.raises(ValueError, match="cross_kv of shapes"):
        engine.submit(Request(uid=0, prompt=[1], max_new_tokens=1, cross_kv=(xk[:, :4], xv)))
    dense = TM.Model(dataclasses.replace(torch_get("qwen2-0.5b").reduced(), remat="none"),
                     device="cpu")
    other = ServingEngine(dense, dense.init(0), max_slots=1, max_len=MAX_LEN)
    with pytest.raises(ValueError, match="no cross-attention"):
        other.submit(Request(uid=0, prompt=[1], max_new_tokens=1, cross_kv=(xk, xv)))


def test_serve_driver_refuses_encdec_before_drawing_weights(monkeypatch):
    """``python -m repro_torch.launch.serve --arch whisper-medium`` exits
    with the reference driver's message, and no weights are drawn; the
    reference's driver refuses it with the same words."""
    import sys

    from repro.launch import serve as jax_serve
    from repro_torch.launch import serve as port_serve

    def no_init(*a, **kw):
        raise AssertionError("weights drawn")

    monkeypatch.setattr(TM.Model, "init", no_init)
    with pytest.raises(SystemExit) as port:
        port_serve.main(["--arch", ARCH, "--device", "cpu", "--reduced"])
    monkeypatch.setattr(sys, "argv", ["serve", "--arch", ARCH, "--reduced"])
    with pytest.raises(SystemExit) as ref:
        jax_serve.main()
    assert str(port.value) == str(ref.value)
    assert str(port.value).startswith("serve driver targets decoder-only archs")


# ----------------------------------------------------------------- sampling


def _whisper_head_cases(b: int) -> tuple[int, dict]:
    """(offset, cases): (b, 51,865) f32 rows for ``greedy_sample``, to be laid
    out in bf16 with row 0 ``offset`` bytes past a 16-byte boundary (2 at
    B = 1, so its one row is misaligned; 0 otherwise, where every row but
    the first is, 103,730 B after the last). Cases: ties of 5 across every
    chunk boundary of the plan at B = b; a NaN on each side of each
    boundary; the maximum in the last element of each row's scalar head
    (element 0 of an aligned row, which has none); the maximum in the last
    element, which every row's scalar tail holds at B <= 4."""
    from repro_torch.kernels.sampling import plan_greedy_sample

    v, offset = WHISPER_V, 2 if b == 1 else 0
    rows = lambda: np.full((b, v), -1.0, np.float32)  # noqa: E731
    ties, nans, head, tail = rows(), rows(), rows(), rows()
    for start, _ in plan_greedy_sample(b, v).bounds(v)[1:]:
        ties[:, start - 3:start + 3] = 5.0
        nans[:, start - 1:start + 1] = np.nan
    for r in range(b):
        lead = (16 - (offset + r * 2 * v) % 16) % 16 // 2  # elements before a boundary
        head[r, max(lead - 1, 0)] = 7.0
    tail[:, v - 1] = 7.0
    return offset, {"ties": ties, "nans": nans, "head": head, "tail": tail}


@pytest.mark.parametrize("b", [1, 4])
def test_greedy_sample_at_the_whisper_head(b):
    """At the head's (B, 51,865) ``greedy_sample`` plans a cluster of 4
    blocks of 12,968; 51,865 is odd, so every bf16 row but the first starts
    off 16-byte alignment and runs the kernel's scalar head and tail. The
    plain version, which a CPU tensor takes, equals ``jnp.argmax`` on rows
    whose ties and NaNs straddle every chunk boundary of that plan and
    whose maximum lies in a misaligned row's head or tail."""
    import jax.numpy as jnp

    from _torch_port import to_torch
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels.sampling import GreedyPlan, plan_greedy_sample

    v = torch_get(ARCH).vocab_size
    assert v == WHISPER_V and (v * 2) % 16 == 2  # row r starts 2r bytes off a boundary
    assert plan_greedy_sample(b, v) == GreedyPlan(4, 12_968)
    _, cases = _whisper_head_cases(b)
    want = {"ties": 12_968 - 3, "nans": 12_968 - 1, "tail": v - 1}
    for name, rows in cases.items():
        x = jnp.asarray(rows, jnp.bfloat16)
        got = kernel_ops.sample_op(to_torch(x))
        assert got.dtype == torch.int32 and tuple(got.shape) == (b,)
        np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.argmax(x, axis=-1)))
        if name in want:
            assert got.tolist() == [want[name]] * b
    heads = kernel_ops.sample_op(to_torch(jnp.asarray(cases["head"], jnp.bfloat16))).tolist()
    assert heads == ([6] if b == 1 else [0, 6, 5, 4])


# ------------------------------------------------------------------- card


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 4])
def test_cuda_greedy_sample_at_the_whisper_head(b):
    """The same rows on the card, laid out as the cases say (row 0
    ``offset`` bytes past a 16-byte boundary): the hand-written kernel,
    with a cluster of 4, equals its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: greedy_sample has no CPU mode")
    from repro_torch.kernels import ref
    from repro_torch.kernels.sampling import greedy_sample

    offset, cases = _whisper_head_cases(b)
    for name, rows in cases.items():
        buf = torch.empty(b * WHISPER_V + offset // 2, dtype=torch.bfloat16, device="cuda")
        x = buf[offset // 2:].view(b, WHISPER_V)
        x.copy_(torch.from_numpy(rows))
        assert x.data_ptr() % 16 == offset
        before = greedy_sample.launches_by_cluster[4]
        got = greedy_sample(x)
        assert greedy_sample.launches_by_cluster[4] == before + 1
        torch.testing.assert_close(got, ref.greedy_sample_ref(x), rtol=0, atol=0, msg=name)


@pytest.mark.gpu
def test_cuda_masked_fused_step_leaves_the_cross_cache():
    """One masked ``decode_and_sample`` step of the reduced model on the card
    under ``set_sync_debug_mode("error")``: nothing reads the card back; the
    masked row's ``k``/``v`` and every ``xk``/``xv`` byte keep their bits,
    every leaf its address."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: greedy_sample has no CPU mode")
    model = TM.Model(dataclasses.replace(torch_get(ARCH).reduced(), remat="none"),
                     device="cuda")
    params = model.init(SEED)
    b = 4
    cache = model.init_cache(b, 8)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for v in cache.values():
        v.copy_(torch.randn(v.shape, generator=gen, device="cuda").to(v.dtype))
    ones = torch.ones((b, 1), dtype=torch.int32, device="cuda")
    overrides = torch.zeros((b,), dtype=torch.int32, device="cuda")
    pos = torch.tensor([0, 3, 5, 2], dtype=torch.int32, device="cuda")
    live = torch.tensor([True, True, True, False], device="cuda")
    model.decode_and_sample(params, {k: v.clone() for k, v in cache.items()}, ones, overrides,
                            live, pos, live)  # builds the kernel
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
        assert v.data_ptr() == addresses[k]
        assert torch.equal(v[:, 3], before[k][:, 3])
    assert torch.equal(cache["xk"], before["xk"]) and torch.equal(cache["xv"], before["xv"])
    assert not torch.equal(cache["k"][:, 0], before["k"][:, 0])
