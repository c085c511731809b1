"""The port's serving engine held to every pin of ``tests/test_serving.py``,
and to the JAX engine's own token streams and config traffic on the same
parameters (the reduced qwen2-0.5b, on the CPU)."""

from __future__ import annotations

import numpy as np
import pytest

from _torch_port import reduced_pair
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.serving import Request, ServingEngine

PROMPTS = [[5, 9, 2], [7, 1], [3, 3, 3, 3], [11]]


@pytest.fixture(scope="module")
def pair():
    return reduced_pair()


@pytest.fixture(scope="module")
def small_model(pair):
    _, _, _, model, params = pair
    return model, params


def _run(engine_cls, request_cls, model, params, **kw):
    engine = engine_cls(model, params, max_slots=2, max_len=32, **kw)
    for i, p in enumerate(PROMPTS):
        engine.submit(request_cls(uid=i, prompt=list(p), max_new_tokens=6))
    streams = {r.uid: r.generated for r in engine.run_until_done()}
    return streams, engine.config_traffic(), engine.sync_bytes


@pytest.mark.parametrize("sampling", ["fused", "host"])
def test_streams_and_config_traffic_equal_jax_engine(pair, sampling):
    _, jmodel, jparams, tmodel, tparams = pair
    want = _run(JaxEngine, JaxRequest, jmodel, jparams, sampling=sampling)
    got = _run(ServingEngine, Request, tmodel, tparams, sampling=sampling)
    assert got[0] == want[0]
    assert got[1] == want[1]
    assert got[2] == want[2]


def test_engine_overlapping_lifetimes(small_model):
    model, params = small_model
    engine = ServingEngine(model, params, max_slots=2, max_len=32)
    engine.submit(Request(uid=0, prompt=[1], max_new_tokens=8))
    engine.submit(Request(uid=1, prompt=[2], max_new_tokens=2))
    engine.submit(Request(uid=2, prompt=[3], max_new_tokens=2))  # queued
    assert engine.step() == 2  # both live slots advance together
    finished = engine.run_until_done()
    assert sorted(r.uid for r in finished) == [0, 1, 2]
    assert all(len(r.generated) == r.max_new_tokens for r in finished)


def test_submit_rejects_empty_prompt(small_model):
    model, params = small_model
    engine = ServingEngine(model, params, max_slots=2, max_len=16)
    with pytest.raises(ValueError, match="empty prompt"):
        engine.submit(Request(uid=0, prompt=[], max_new_tokens=4))


def test_submit_rejects_prompt_at_or_over_max_len(small_model):
    model, params = small_model
    engine = ServingEngine(model, params, max_slots=2, max_len=8)
    with pytest.raises(ValueError, match="overrun"):
        engine.submit(Request(uid=0, prompt=list(range(8)), max_new_tokens=1))
    with pytest.raises(ValueError, match="overrun"):
        engine.submit(Request(uid=1, prompt=list(range(12)), max_new_tokens=1))
    # the boundary prompt fills positions 0..6 and leaves one decode step
    engine.submit(Request(uid=2, prompt=[1, 2, 3, 4, 5, 6, 7], max_new_tokens=100))
    (done,) = engine.run_until_done()
    assert len(done.generated) == 1


def test_max_len_terminates_at_exact_token_count(small_model):
    """max_len=8, prompt of 3: exactly 5 generated tokens, never 4 or 6;
    a max_new_tokens bound below the ceiling wins instead."""
    model, params = small_model
    engine = ServingEngine(model, params, max_slots=2, max_len=8)
    engine.submit(Request(uid=0, prompt=[5, 9, 2], max_new_tokens=100))
    (done,) = engine.run_until_done()
    assert len(done.generated) == 5
    engine.submit(Request(uid=1, prompt=[5, 9, 2], max_new_tokens=3))
    assert len(engine.run_until_done()[-1].generated) == 3


def test_masked_prefill_leaves_other_slots_bit_identical(small_model):
    """A resident slot's KV rows survive another request's whole prefill
    chain untouched, while the admitted slot's rows fill."""
    model, params = small_model
    engine = ServingEngine(model, params, max_slots=2, max_len=32, prefill_chunk=4)
    engine.submit(Request(uid=0, prompt=[5, 9, 2, 7, 1], max_new_tokens=20))
    engine.step()  # admit + first decode: slot 0 now holds live KV state
    engine.executor.drain()
    before_k = engine.cache["k"][:, 0].clone()
    before_v = engine.cache["v"][:, 0].clone()
    assert before_k.any(), "slot 0 should hold prefill state already"
    engine.submit(Request(uid=1, prompt=[3, 3, 4, 4, 6, 6, 8], max_new_tokens=4))
    engine._admit()
    engine.executor.drain()
    assert engine.cache["k"][:, 0].equal(before_k)
    assert engine.cache["v"][:, 0].equal(before_v)
    assert engine.cache["k"][:, 1].any(), "slot 1's rows should have been written"


def test_fused_descriptor_drops_tokens_leaf_and_pins_bytes(small_model):
    """Fused: positions 16 + live_mask 4 + token_overrides 16 +
    override_mask 4 + invariants 12 = 52 bytes, no ``tokens`` leaf; host:
    tokens (4×int32) instead of the override pair, 48 bytes."""
    model, params = small_model

    def steady_desc(sampling):
        captured = []
        engine = ServingEngine(model, params, max_slots=4, max_len=16,
                               sampling=sampling, on_launch=captured.append)
        engine.submit(Request(uid=0, prompt=[3], max_new_tokens=4))
        engine.run_until_done()
        decode = [d for d in captured if "prefill_tokens" not in d]
        assert len(decode) == 4
        return decode[-1]

    fused = steady_desc("fused")
    assert set(fused) == {"positions", "live_mask", "token_overrides",
                          "override_mask", "max_len", "eos_id", "n_slots"}
    assert sum(np.asarray(v).nbytes for v in fused.values()) == 52
    host = steady_desc("host")
    assert set(host) == {"positions", "live_mask", "tokens", "max_len", "eos_id", "n_slots"}
    assert sum(np.asarray(v).nbytes for v in host.values()) == 48


def test_freed_slot_token_state_is_zeroed(small_model):
    """A finished request's slot does not leak its last token: the host
    mirror and the fused override reset to 0, the relaunch carries the next
    admission's override, and the next occupant decodes as on a fresh
    engine."""
    model, params = small_model
    captured = []
    engine = ServingEngine(model, params, max_slots=1, max_len=32, on_launch=captured.append)
    engine.submit(Request(uid=0, prompt=[7, 7], max_new_tokens=2))
    engine.submit(Request(uid=1, prompt=[5, 9], max_new_tokens=4))
    done = engine.run_until_done()
    assert [r.uid for r in done] == [0, 1]
    assert engine.tokens[0, 0] == 0 and engine._overrides[0] == 0
    decode = [d for d in captured if "prefill_tokens" not in d]
    relaunch = decode[2]  # steps 0-1 served uid=0; step 2 admits uid=1
    assert relaunch["override_mask"][0]
    assert relaunch["token_overrides"][0] == 9 != int(done[0].generated[-1])
    fresh = ServingEngine(model, params, max_slots=1, max_len=32)
    fresh.submit(Request(uid=1, prompt=[5, 9], max_new_tokens=4))
    (want,) = fresh.run_until_done()
    assert done[1].generated == want.generated


def test_sampling_modes_bit_identical_streams(small_model):
    model, params = small_model
    fused = _run(ServingEngine, Request, model, params, sampling="fused")
    host = _run(ServingEngine, Request, model, params, sampling="host")
    assert fused[0] == host[0]
    assert fused[2] == 2 * 4  # (B, 1) int32 ids
    assert host[2] == 2 * model.cfg.vocab_size * 2  # (B, vocab) bf16 logits


def test_engine_rejects_unknown_options(small_model):
    model, params = small_model
    with pytest.raises(ValueError):
        ServingEngine(model, params, sampling="beam")
    with pytest.raises(ValueError):
        ServingEngine(model, params, prefill_chunk=0)
