"""The port's chunked attention (``cfg.attn_chunk``) against the JAX
package's, on the same inputs and parameters, on the CPU.

Tolerances, each stated where it is used:

* ``chunked_attention`` in f32 against the reference's: rtol = atol =
  1e-5 (the same f32 ops in the same order; the products' sums may round
  apart in the last bits);
* the chunk a pass takes: the reference's divisor rule exactly;
* ``forward`` with ``attn_chunk`` against JAX's with the same
  ``attn_chunk``: ``test_decode_parity``'s rtol 0.05, atol 0.15 and
  top-1 ≥ 0.9 (bf16 products round apart between the frameworks);
* the port chunked against the port unchunked: ``tests/test_perf_features.py``'s
  ``test_attn_chunk_config_end_to_end`` tolerance, rtol 0.05, atol 0.1
  (f32 probabilities against bf16 ones);
* a pass the rule sends to the plain path: bit for bit the unchunked one.

JAX is imported inside the CPU tests, so the ``gpu`` test also collects on
a machine without it."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get as torch_get
from repro_torch.models import layers as TL
from repro_torch.models.model import Model as TorchModel

RTOL, ATOL, TOP1 = 0.05, 0.15, 0.9  # tests/test_decode_parity.py
CHUNK_TOL = dict(rtol=1e-5, atol=1e-5)
SELF_TOL = dict(rtol=0.05, atol=0.1)  # tests/test_perf_features.py
MOE_SEED = 17  # test_torch_moe's parameter seed for forward, whose routes clear the gap
# (arch, parameter seed, tokens, attn_chunk, the (chunk, causal) of each chunked pass a layer)
FORWARDS = {
    "dense": ("qwen2-0.5b", 0, 32, 8, [(8, True)]),
    "moe": ("phi3.5-moe-42b-a6.6b", MOE_SEED, 8, 4, [(4, True)]),
    "vlm": ("phi-3-vision-4.2b", 0, 24, 8, [(8, True)]),  # 8 prefix rows + 24 tokens
    # the encoder (16 frames) and, with q above the chunk, the decoder's self-
    # (12 keys: chunk 6) and cross-attention (16 keys); with q below it, the encoder alone
    "encdec q above": ("whisper-medium", 0, 12, 8, [(8, False), (6, True), (8, False)]),
    "encdec q below": ("whisper-medium", 0, 4, 8, [(8, False)]),
}


def _qkv(b: int, s: int, hq: int, hkv: int, d: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32) for h in (hq, hkv, hkv)]


def _batch(cfg, b: int, s: int) -> dict:
    """Seeded tokens, and the front end's rows for vlm (its 8-row prefix)
    and encdec (an encoder window), as numpy."""
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    rows = {"vlm": cfg.frontend_tokens, "encdec": cfg.encoder_seq_len}.get(cfg.family)
    if rows:
        batch["frontend_embeds"] = rng.standard_normal((b, rows, cfg.d_model)).astype(np.float32)
    return batch


def _chunked_calls(monkeypatch) -> list:
    """Records the (chunk, causal) of every port ``chunked_attention`` call."""
    calls, run = [], TL.chunked_attention

    def recorded(q, k, v, n_kv, *, causal, chunk):
        calls.append((chunk, causal))
        return run(q, k, v, n_kv, causal=causal, chunk=chunk)

    monkeypatch.setattr(TL, "chunked_attention", recorded)
    return calls


def _port_forward(model, params, batch: dict, chunk: int):
    model = TorchModel(dataclasses.replace(model.cfg, attn_chunk=chunk), device="cpu")
    logits, _ = model.forward(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    return logits


# ------------------------------------------------------------ the function


@pytest.mark.parametrize("s,chunk", [(64, 16), (128, 32)])
@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_jax(s, chunk, causal):
    """GQA (4 query heads over 2 KV heads of 16), f32, B = 2."""
    from repro.models import layers as JL

    q, k, v = _qkv(2, s, 4, 2, 16)
    want = np.asarray(JL.chunked_attention(q, k, v, 2, causal=causal, chunk=chunk))
    got = TL.chunked_attention(*map(torch.from_numpy, (q, k, v)), 2, causal=causal, chunk=chunk)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **CHUNK_TOL)


@pytest.mark.parametrize("t, chunk", [(1500, 500), (4672, 292), (1009, 1), (512, 512),
                                      (100, 100)])
def test_the_chunk_is_the_largest_divisor_up_to_the_request(t, chunk):
    """At ``attn_chunk = 512``: the whisper encoder's 1,500 frames take 500,
    4,672 takes 292, a prime length 1 (the plain path), and a length up to
    the request itself."""
    assert TL.attention_chunk(t, 512) == chunk


@pytest.mark.parametrize("s", [11, 8])
def test_a_pass_the_rule_sends_to_the_plain_path_is_the_unchunked_one(monkeypatch, s):
    """At ``attn_chunk = 8``: 11 rows (prime: a chunk of 1) and 8 rows (not
    above the request) run the plain path, bit for bit."""
    from _torch_port import reduced_pair

    cfg, _, _, tmodel, tparams = reduced_pair(0, "qwen2-0.5b")
    calls = _chunked_calls(monkeypatch)
    batch = _batch(cfg, 2, s)
    assert torch.equal(_port_forward(tmodel, tparams, batch, 8),
                       _port_forward(tmodel, tparams, batch, 0))
    assert calls == []


# --------------------------------------------------------------- forward


@pytest.mark.parametrize("family", sorted(FORWARDS))
def test_forward_with_attn_chunk_matches_jax(monkeypatch, family):
    import jax

    from _torch_port import reduced_pair
    from repro.models.model import Model

    arch, seed, s, chunk, per_layer = FORWARDS[family]
    cfg, _, jparams, tmodel, tparams = reduced_pair(seed, arch)
    routes = None
    if cfg.family == "moe":
        from test_torch_moe import Routes

        routes = Routes(monkeypatch)
    calls = _chunked_calls(monkeypatch)
    batch = _batch(cfg, 4, s)
    jmodel = Model(dataclasses.replace(cfg, attn_chunk=chunk))
    want, _ = jax.jit(jmodel.forward)(jparams, batch)
    got = _port_forward(tmodel, tparams, batch, chunk)
    if routes is not None:
        routes.assert_clear_and_equal(cfg.experts_per_token, ordered=True)
    assert calls == _per_layer(per_layer, cfg)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (4, s, cfg.vocab_size)
    a, b = np.asarray(want, np.float32), got.float().numpy()
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= TOP1


def _per_layer(per_layer: list, cfg) -> list:
    """The chunked passes of a forward in call order: each layer's; for
    encdec the encoder's first, every layer, then the decoder's."""
    if cfg.family == "encdec":
        return per_layer[:1] * cfg.n_encoder_layers + per_layer[1:] * cfg.n_layers
    return per_layer * cfg.n_layers


@pytest.mark.parametrize("family", sorted(FORWARDS))
def test_chunked_forward_stays_near_the_unchunked_one(family):
    from _torch_port import reduced_pair

    arch, seed, s, chunk, _ = FORWARDS[family]
    cfg, _, _, tmodel, tparams = reduced_pair(seed, arch)
    batch = _batch(cfg, 2, s)
    chunked = _port_forward(tmodel, tparams, batch, chunk)
    plain = _port_forward(tmodel, tparams, batch, 0)
    assert not torch.equal(chunked, plain)
    np.testing.assert_allclose(chunked.float().numpy(), plain.float().numpy(), **SELF_TOL)


def test_the_encoder_takes_the_chunked_path(monkeypatch):
    """``encode`` alone, 16 frames at ``attn_chunk = 8``: non-causal chunks of
    8 in every encoder layer, within the tolerance above of the unchunked
    encoder."""
    from _torch_port import reduced_pair

    cfg, _, _, tmodel, tparams = reduced_pair(0, "whisper-medium")
    frames = torch.from_numpy(_batch(cfg, 2, 4)["frontend_embeds"])
    calls = _chunked_calls(monkeypatch)
    chunked = TorchModel(dataclasses.replace(cfg, attn_chunk=8), device="cpu").encode(
        tparams, frames)
    assert calls == [(8, False)] * cfg.n_encoder_layers
    plain = tmodel.encode(tparams, frames)
    np.testing.assert_allclose(chunked.float().numpy(), plain.float().numpy(), **SELF_TOL)


# ------------------------------------------------------------ on the card


@pytest.mark.gpu
def test_cuda_chunked_against_plain():
    """On the card: ``chunked_attention`` in f32 against the CPU port's at
    the tolerance above, and the reduced qwen2-0.5b's ``forward`` at
    ``attn_chunk = 8`` against its unchunked one at ``SELF_TOL``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    q, k, v = map(torch.from_numpy, _qkv(2, 128, 4, 2, 16))
    for causal in (True, False):
        want = TL.chunked_attention(q, k, v, 2, causal=causal, chunk=32)
        got = TL.chunked_attention(q.cuda(), k.cuda(), v.cuda(), 2, causal=causal, chunk=32)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **CHUNK_TOL)
    cfg = dataclasses.replace(torch_get("qwen2-0.5b").reduced(), remat="none")
    model = TorchModel(cfg, device="cuda")
    params = model.init(0)
    tokens = torch.from_numpy(_batch(cfg, 2, 32)["tokens"]).cuda()
    plain, _ = model.forward(params, {"tokens": tokens})
    chunked, _ = TorchModel(dataclasses.replace(cfg, attn_chunk=8), device="cuda").forward(
        params, {"tokens": tokens})
    np.testing.assert_allclose(chunked.float().cpu().numpy(), plain.float().cpu().numpy(),
                               **SELF_TOL)
