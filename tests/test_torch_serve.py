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
from repro_torch.obs.export import chrome_trace, validate_trace

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


def _self_ns(span, host) -> int:
    """A host span's time outside its children (the spans that name it as
    their parent, a launch's by its ``launch`` tag too)."""
    kids = [s for s in host if s.tags["parent"] == span.name
            and s.tags.get("launch") == span.tags.get("launch", s.tags.get("launch"))]
    return span.cycles - sum(s.cycles for s in kids)


@pytest.mark.parametrize("mode", MODES)
def test_serve_records_one_span_tree_a_call(pair, mode):
    """One ``serve.call`` a call; its children nest inside it one after
    another, share its ``call`` id and leave it self time; ``wall_s``,
    ``capture_s`` and ``issue_ms`` read the spans; the ids are the plain
    loop's; the trace exports to a loadable Chrome trace."""
    *_, tmodel, tparams = pair
    run = _serve(tmodel, tparams, mode)
    again = _serve(tmodel, tparams, mode)
    assert run.trace.lanes() == ["host"]  # the device lane is a card's
    host = run.trace.spans
    (call,) = run.host("serve.call")
    assert call.tags["parent"] is None and call.cat == "launch"
    assert {s.tags["call"] for s in host} == {call.tags["call"]}
    assert again.host("serve.call")[0].tags["call"] != call.tags["call"]

    children = sorted((s for s in host if s.tags["parent"] == "serve.call"), key=lambda s: s.start)
    fused = mode == "fused"
    assert [s.name for s in children] == ["serve.cache", "serve.warmup",
                                          *(["serve.capture"] if fused else []),
                                          "serve.loop", "serve.gather"]
    assert call.start <= children[0].start and children[-1].end <= call.end
    assert all(a.end <= b.start for a, b in zip(children, children[1:]))
    (loop,) = run.host("serve.loop")
    launches = run.host("serve.launch")
    assert [s.tags["launch"] for s in launches] == list(range(len(launches)))
    assert all(s.tags["parent"] == "serve.loop" for s in launches)
    assert loop.start <= launches[0].start and launches[-1].end <= loop.end
    assert all(a.end <= b.start for a, b in zip(launches, launches[1:]))
    waits = run.host("serve.wait")
    assert len(waits) == (len(launches) if mode == "sequential" else 0)
    for wait, launch in zip(waits, launches):
        assert wait.tags["launch"] == launch.tags["launch"] and wait.cat == "stall"
        assert launch.start <= wait.start and wait.end <= launch.end
    assert all(_self_ns(s, host) >= 0 for s in host)
    assert sum(run.seconds_by_span().values()) == pytest.approx(call.cycles / 1e9)
    assert run.seconds_by_span()["self"] >= 0

    assert run.wall_s == loop.cycles / 1e9
    assert run.capture_s == sum(s.cycles for s in run.host("serve.capture")) / 1e9
    assert len(run.issue_ms) == len(launches) == run.launches
    assert run.issue_ms == [(s.cycles - sum(w.cycles for w in waits if w.tags["launch"] == i)) / 1e6
                            for i, s in enumerate(launches)]

    want = _eager_fused_ids(tmodel, tparams, batch=BATCH, steps=STEPS, cache_len=CACHE_LEN,
                            fuse=FUSE if fused else 1)
    torch.testing.assert_close(run.ids, want, rtol=0, atol=0)
    assert validate_trace(chrome_trace(run.trace)) == []


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


@pytest.mark.gpu
def test_cuda_spans_lie_on_the_profilers_clock():
    """On the card. Under ``torch.profiler``, each program ``serve.launch``
    span lies within 50 us of the profiler's range of that name. The device
    intervals are held to the host's spans on the one clock, with and
    without a profiler: a launch's interval starts no earlier than its host
    span, less 50 us (its start event is recorded just before the span), and
    ends no later than the next one starts; the last ends
    inside ``serve.loop``, whose synchronise waits for it; the warm-up's lies
    between its span's start and the end of ``serve.capture``, whose
    synchronise drains it. (The profiler's own device timestamps are no
    reference: on an H100 with torch 2.11 they sat 0.3 to 260 ms off its
    host events and drifted by up to 2 % within one profile.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: CUDA graphs and the kernel have no CPU mode")
    from torch.profiler import ProfilerActivity, profile

    model = TorchModel(dataclasses.replace(torch_get("qwen2-0.5b"), remat="none"), device="cuda")
    params = model.init(SEED)
    shape = dict(batch=4, steps=8 + 8 * 6, cache_len=64, mode="fused", fuse=8)
    serve(model, params, **shape)  # kernels built, shapes warm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = serve(model, params, **shape)
    plain = serve(model, params, **shape)
    tol = 50_000  # ns
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "serve.launch" and e.device_type() != torch.autograd.DeviceType.CUDA)
    spans = traced.host("serve.launch")
    assert len(ranges) == len(spans) == 6
    for (r0, r1), s in zip(ranges, spans):
        assert abs(s.start - r0) <= tol and abs(s.end - r1) <= tol, (s.start - r0, s.end - r1)

    lane = f"compute[cuda:{torch.cuda.current_device()}]"
    for run in (traced, plain):
        card = {(s.name, s.tags.get("launch")): s for s in run.trace.spans if s.cat == "compute"}
        assert {s.lane for s in card.values()} == {lane} and len(card) == 7
        launches = [card["serve.launch", i] for i in range(6)]
        edges = [(dev.start - host.start, dev.end - dev.start,
                  None if after is None else after.start - dev.end)
                 for host, dev, after in zip(run.host("serve.launch"), launches,
                                             launches[1:] + [None])]
        assert all(begun >= -tol and length >= 0 and (gap is None or gap >= -1_000)
                   for begun, length, gap in edges), edges
        assert launches[-1].end <= run.host("serve.loop")[0].end + tol
        warm = card["serve.warmup", None]
        (host_warm,), (capture,) = run.host("serve.warmup"), run.host("serve.capture")
        assert host_warm.start - tol <= warm.start <= warm.end <= capture.end + tol, \
            (warm.start - host_warm.start, warm.end - capture.end)
