"""The port's vision-language (vlm) family against the JAX package's, on the
same parameters.

phi-3-vision-4.2b is the dense trunk plus a prefix: ``forward`` puts the
vision front end's patch embeddings (``frontend_embeds``, a stub in both
packages) before the token embeddings, runs positions 0 … P+S−1 and drops
the P prefix rows before the head. The reduced config (2 layers, d_model
64, 4 heads of 16, d_ff 128, vocab 256, an 8-row prefix) runs in both
packages on the CPU, its weights drawn by the JAX ``Model.init`` and carried
across through ``models.convert``; one test runs the published widths cut
to 2 layers. Logits are held at ``tests/test_decode_parity.py``'s
tolerances (bf16 rounds at other places in the two frameworks) and
sampled ids by the top-two margin rule of ``test_torch_ssm.Logits``.

The reference serves a vlm as its text backbone: only ``forward`` reads
the prefix, and its engine decodes a request's tokens from position 0 with
no image. The port mirrors that; the last tests pin both sides of it."""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import assert_sampled_ids_within_ties, reduced_pair, to_numpy32
from repro.configs import get
from repro.models.model import Model
from repro_torch.configs import get as torch_get
from repro_torch.dispatch.executor import flatten_with_path
from repro_torch.models.convert import params_from_numpy
from repro_torch.models.model import Model as TorchModel
from repro_torch.models.model import _norm

ARCH = "phi-3-vision-4.2b"
SEED, ENGINE_SEED = 0, 11  # parameter seeds; see test_engine_streams_equal_jax_engine
RTOL, ATOL, TOP1 = 0.05, 0.15, 0.9  # tests/test_decode_parity.py
PROMPTS = [[5, 9, 2], [7, 1], [3, 3, 3, 3]]
MAX_NEW, PREFILL_CHUNK = 4, 2


@pytest.fixture(scope="module")
def pair():
    return reduced_pair(SEED, ARCH)


def _assert_logits_close(want, got):
    a, b = to_numpy32(want), to_numpy32(got)
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= TOP1


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _prefix(cfg, b: int, rows: int, seed: int = 2) -> np.ndarray:
    """Seeded patch embeddings (B, rows, d) in f32, as the front end's stub
    would hand them over; both packages cast them to bf16."""
    return np.random.default_rng(seed).standard_normal((b, rows, cfg.d_model)).astype(np.float32)


def _forward_both(pair, toks, prefix):
    cfg, jmodel, jparams, tmodel, tparams = pair
    want, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks),
                                                "frontend_embeds": jnp.asarray(prefix)})
    got, aux = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks),
                                        "frontend_embeds": torch.from_numpy(prefix)})
    return want, got, aux


# ------------------------------------------------------------ configuration


def test_model_admits_vlm_and_draws_the_reference_tree(pair):
    """``init``: the reference's tree (the dense trunk with its MLP, an
    untied head), shapes and dtypes, matrices at N(0, 1/fan_in)."""
    cfg, jmodel, _, tmodel, _ = pair
    assert cfg.family == "vlm" and cfg.frontend_tokens == 8
    want = jax.tree_util.tree_flatten_with_path(jmodel.abstract_params())[0]
    params = tmodel.init(3)
    got = flatten_with_path(params)
    assert [jax.tree_util.keystr(k) for k, _ in want] == [k for k, _ in got]
    for (_, w), (_, g) in zip(want, got):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)
    assert "mlp" in params["layers"] and "head" in params
    wi = params["layers"]["mlp"]["wi"].float()
    assert abs(wi.std().item() * cfg.d_model ** 0.5 - 1.0) < 0.1


# -------------------------------------------------------------- forward


def test_forward_with_a_prefix_matches_jax(pair):
    """An 8-row prefix before 8 tokens: the tokens' (2, 8, V) logits, at
    ``test_decode_parity``'s tolerances."""
    cfg = pair[0]
    toks = _tokens(cfg, (2, 8))
    want, got, aux = _forward_both(pair, toks, _prefix(cfg, 2, cfg.frontend_tokens))
    assert got.shape == (2, 8, cfg.vocab_size) and got.dtype == torch.bfloat16
    assert float(aux) == 0.0
    _assert_logits_close(want, got)


def test_forward_is_the_dense_trunk_over_the_prefix_and_the_tokens(pair):
    """The vlm's logits equal, bit for bit, the dense trunk of the same
    weights run over a sequence whose first P embedding rows are the
    prefix (cast to bf16), with those rows dropped before the head; another
    prefix moves the text's logits."""
    cfg, *_, tmodel, tparams = pair
    toks = _tokens(cfg, (2, 8))
    prefix = torch.from_numpy(_prefix(cfg, 2, cfg.frontend_tokens))
    got, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks), "frontend_embeds": prefix})
    dense = TorchModel(dataclasses.replace(tmodel.cfg, family="dense"), device="cpu")
    x = torch.cat([prefix.to(torch.bfloat16), tparams["embed"][torch.from_numpy(toks)]], 1)
    x, _ = dense._uniform_trunk(tparams["layers"], x)
    x = _norm(tparams["final_norm"], x, cfg.norm_eps)
    want = x[:, cfg.frontend_tokens:] @ tparams["head"]
    assert torch.equal(got, want)
    other, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks),
                                        "frontend_embeds": prefix.flip(0)})
    assert not torch.equal(other, got)


def test_an_empty_prefix_gives_the_text_backbones_forward(pair):
    """A (B, 0, d) prefix: the vlm's forward is the dense model's on the
    same weights, bit for bit."""
    cfg, *_, tmodel, tparams = pair
    toks = torch.from_numpy(_tokens(cfg, (2, 8)))
    got, _ = tmodel.forward(tparams, {"tokens": toks,
                                      "frontend_embeds": torch.zeros((2, 0, cfg.d_model))})
    dense = TorchModel(dataclasses.replace(tmodel.cfg, family="dense"), device="cpu")
    assert torch.equal(got, dense.forward(tparams, {"tokens": toks})[0])


def _published_pair(n_layers: int = 2):
    """phi-3-vision-4.2b at its published widths (d_model 3,072, 32 heads of
    96, d_ff 8,192, vocab 32,064) cut to ``n_layers`` layers: 423,505,920
    parameters at 2, drawn by the JAX ``Model.init`` and carried across."""
    cfg = dataclasses.replace(get(ARCH), n_layers=n_layers, remat="none")
    jmodel = Model(cfg)
    jparams = jax.jit(jmodel.init)(jax.random.key(SEED))
    tmodel = TorchModel(dataclasses.replace(torch_get(ARCH), n_layers=n_layers, remat="none"),
                        device="cpu")
    return cfg, jmodel, jparams, tmodel, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                                           "cpu")


def test_forward_at_published_widths_matches_jax():
    """Full-width logits against JAX: 2 of 32 layers at the published widths,
    B = 1, a 16-row seeded prefix and 8 tokens, through both packages'
    ``forward``, at ``test_decode_parity``'s tolerances with top-1 held."""
    pair = _published_pair()
    cfg = pair[0]
    n = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(pair[2]))
    assert n == cfg.param_count() + cfg.d_model == 423_505_920 + 3_072  # and the final norm
    toks = _tokens(cfg, (1, 8))
    with torch.no_grad():
        want, got, _ = _forward_both(pair, toks, _prefix(cfg, 1, 16))
    assert got.shape == (1, 8, 32_064)
    _assert_logits_close(want, got)


# --------------------------------------------------------------- decode


def test_teacher_forced_decode_matches_jax_and_the_text_backbone(pair):
    """``decode_step`` from position 0 over the tokens alone (no image, as
    the reference decodes a vlm): the JAX decode's logits, and the vlm's
    ``forward`` over an empty prefix, at the tolerances."""
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
    full, _ = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks),
                                       "frontend_embeds": torch.zeros((b, 0, cfg.d_model))})
    _assert_logits_close(full, np.stack(got, 1))


def test_decode_and_sample_ids_equal_jax(pair):
    """Six fused steps with per-slot positions, a dead slot and host
    overrides: ids equal the JAX model's, or meet a bf16 tie within the
    tolerance."""
    assert_sampled_ids_within_ties(pair)


# --------------------------------------------------------------- serving


def _engine_run(engine_cls, request_cls, model, params, **kw):
    engine = engine_cls(model, params, max_slots=len(PROMPTS), max_len=32,
                        prefill_chunk=PREFILL_CHUNK, **kw)
    for i, p in enumerate(PROMPTS):
        engine.submit(request_cls(uid=i, prompt=list(p), max_new_tokens=MAX_NEW))
    streams = {r.uid: r.generated for r in engine.run_until_done()}
    return streams, engine.config_traffic(), engine.sync_bytes


@pytest.mark.parametrize("sampling", ["fused", "host"])
def test_engine_streams_equal_jax_engine(monkeypatch, sampling):
    """A slot for each of three requests, chunked prefill, no image on
    either side: streams, config traffic and host sync bytes equal the JAX
    engine's, and every taken row of every step is bit-identical or clear
    of a tie (``test_torch_ssm.Logits``: JAX's top-two margin above twice
    its largest gap to the port's). Few runs of this size clear that rule:
    of parameter seeds 0-18 only 11, 14 and 18 do (the others meet a row
    whose top two lie within twice their cross-framework gap, at XLA's
    default precision and at ``xla_allow_excess_precision=False`` alike),
    so the weights come from ``ENGINE_SEED``."""
    from repro.serving import Request as JaxRequest
    from repro.serving import ServingEngine as JaxEngine
    from repro_torch.serving import Request, ServingEngine
    from test_torch_ssm import Logits

    _, jmodel, jparams, tmodel, tparams = reduced_pair(ENGINE_SEED, ARCH)
    logits = Logits(monkeypatch, jmodel, tmodel)
    want = _engine_run(JaxEngine, JaxRequest, jmodel, jparams, sampling=sampling)
    got = _engine_run(ServingEngine, Request, tmodel, tparams, sampling=sampling)
    assert logits.assert_taken_rows_agree()[1] >= MAX_NEW * len(PROMPTS)
    assert sorted(len(g) for g in got[0].values()) == [MAX_NEW] * len(PROMPTS)
    assert got == want


def test_the_reference_serves_a_vlm_as_its_text_backbone(pair):
    """The divergence inside the reference that the port mirrors: its engine
    serves a prompt's greedy continuation over the text alone (``forward``
    over an empty prefix, token by token), and the logits it serves on
    differ from ``forward``'s with an image before the same text by more
    than the tolerance."""
    from repro.serving import Request as JaxRequest
    from repro.serving import ServingEngine as JaxEngine

    cfg, jmodel, jparams, *_ = pair
    fwd = jax.jit(jmodel.forward)
    prompt = PROMPTS[0]
    engine = JaxEngine(jmodel, jparams, max_slots=1, max_len=32, prefill_chunk=PREFILL_CHUNK)
    engine.submit(JaxRequest(uid=0, prompt=list(prompt), max_new_tokens=MAX_NEW))
    (served,) = engine.run_until_done()

    def last_logits(tokens: list[int], prefix: np.ndarray) -> np.ndarray:
        lg, _ = fwd(jparams, {"tokens": jnp.asarray([tokens], jnp.int32),
                              "frontend_embeds": jnp.asarray(prefix)})
        return np.asarray(lg[0, -1], np.float32)

    empty = np.zeros((1, 0, cfg.d_model), np.float32)
    text = list(prompt)
    for _ in range(MAX_NEW):
        lg = last_logits(text, empty)
        top = np.sort(lg)
        assert top[-1] - top[-2] > 0.05  # clear of a tie between forward and decode
        text.append(int(lg.argmax()))
    assert served.generated == text[len(prompt):]
    with_image = last_logits(list(prompt), _prefix(cfg, 1, cfg.frontend_tokens))
    assert not np.allclose(with_image, last_logits(list(prompt), empty), rtol=RTOL, atol=ATOL)
