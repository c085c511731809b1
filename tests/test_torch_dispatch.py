"""The port's dispatch layer against the JAX package's: the scheduled
executor sees the same descriptor leaves in the same order under the same
keys and reports the same traffic for the same launch stream; the planner
splits the same descriptors the same way; the sequential and concurrent
executors give the same results and byte counts.

PyTorch runs CPU ops before they return, so the concurrent executor can
overlap host preparation with the device only on a card: that test is
marked ``gpu`` and skips here. JAX is imported inside the CPU tests so it
also collects on a machine without it."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from repro_torch.dispatch import (ConcurrentExecutor, ConfigPlan, ScheduledExecutor,
                                  SequentialExecutor, StepDescriptor)
from repro_torch.dispatch.executor import flatten_with_path


def _descriptor(step: int) -> dict:
    return {
        "tokens": np.full((4, 1), step % 3, np.int32),
        "positions": np.arange(4, dtype=np.int32) + step,
        "live_mask": np.array([True, True, step < 2, False]),
        "meta": {"n_slots": np.int32(4), "eos_id": np.int32(-1)},
        "extra": [np.int32(7), None, (np.float32(step // 2),)],
    }


def test_flatten_matches_jax_keys_and_order():
    import jax

    tree = _descriptor(0)
    want = [(jax.tree_util.keystr(k), v)
            for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]]
    got = flatten_with_path(tree)
    assert [k for k, _ in got] == [k for k, _ in want]
    assert got[0][0] == "['extra'][0]"
    for (_, a), (_, b) in zip(got, want):
        assert a is b


def test_run_reports_the_jax_executors_traffic():
    """Same host_prep through both executors: identical bytes sent and
    elided per step, and the state threads through every launch."""
    from repro.dispatch import ScheduledExecutor as JaxExecutor

    def device_fn(state, args):
        return state + 1

    want_state, want = JaxExecutor(device_fn, _descriptor, depth=2).run(0, 6)
    got_state, got = ScheduledExecutor(device_fn, _descriptor, depth=2).run(0, 6)
    assert got_state == want_state == 6
    assert got.steps == want.steps == 6
    assert got.bytes_per_step == want.bytes_per_step
    assert got.bytes_elided_per_step == want.bytes_elided_per_step
    assert 0 < got.elision_ratio < 1


def test_tensor_leaves_compare_by_bits():
    """CPU tensor leaves (bf16 included) dedup like numpy ones."""
    ex = ScheduledExecutor(lambda state, args: state)
    leaf = torch.tensor([1.5, -2.0], dtype=torch.bfloat16)
    ex.launch(None, {"x": leaf})
    ex.launch(None, {"x": leaf.clone()})
    ex.launch(None, {"x": leaf + 1})
    stats = ex.cache.stats
    assert (stats.bytes_sent, stats.bytes_elided) == (8, 4)
    ex.drain()
    assert ex.launches == 3 and ex.report(1.0).steps == 3


_PLANS = {
    # tests/test_substrate.py's: one dynamic field among static ones
    "mixed": [{"lr": 1e-3, "pos": i, "table": np.arange(4)} for i in range(5)],
    "all static": [{"temp": np.float32(0.7), "slots": np.arange(8, dtype=np.int32)}] * 3,
    "all dynamic": [{"seed": np.uint32(i), "offsets": np.arange(3, dtype=np.int64) * i}
                    for i in range(4)],
}


@pytest.mark.parametrize("name", sorted(_PLANS))
def test_config_plan_matches_the_jax_planner(name):
    from repro.dispatch import ConfigPlan as JaxPlan
    from repro.dispatch import StepDescriptor as JaxDescriptor

    fields = _PLANS[name]
    want = JaxPlan.trace([JaxDescriptor(f) for f in fields])
    got = ConfigPlan.trace([StepDescriptor(f) for f in fields])
    assert got.dynamic == want.dynamic and got.total_fields == want.total_fields
    assert list(got.static) == list(want.static)
    for key in got.static:
        np.testing.assert_array_equal(got.static[key], want.static[key])
    for f in fields:
        jd, td = JaxDescriptor(f), StepDescriptor(f)
        assert got.bytes_baseline(td) == want.bytes_baseline(jd)
        assert got.bytes_deduped(td) == want.bytes_deduped(jd)
        assert got.i_oc_gain(td) == want.i_oc_gain(jd)
        assert list(got.dynamic_descriptor(td)) == list(want.dynamic_descriptor(jd))


def _prep(step: int) -> dict:
    return {"x": np.float32(step), "pos": np.arange(4, dtype=np.int32) + step,
            "meta": {"n": np.int32(4)}, "unused": None}


@pytest.mark.parametrize("kind", ["sequential", "concurrent"])
def test_executors_match_the_jax_executors(kind):
    """The JAX executors' steps, bytes per step and result
    (``tests/test_substrate.py``'s split), from the same host preparation;
    and the port's two executors give equal results."""
    import jax
    import jax.numpy as jnp

    from repro.dispatch import ConcurrentExecutor as JaxConcurrent
    from repro.dispatch import SequentialExecutor as JaxSequential

    def jax_fn(state, args):
        return state + args["x"] + jnp.sum(args["pos"])

    def torch_fn(state, args):
        return state + float(args["x"]) + torch.from_numpy(args["pos"]).sum()

    jax_ex, torch_ex = {"sequential": (JaxSequential, SequentialExecutor),
                        "concurrent": (JaxConcurrent, ConcurrentExecutor)}[kind]
    kw = {"depth": 3} if kind == "concurrent" else {}
    want_state, want = jax_ex(jax.jit(jax_fn), _prep, **kw).run(jnp.float32(0), 12)
    got_state, got = torch_ex(torch_fn, _prep, **kw).run(torch.zeros((), dtype=torch.float32), 12)
    assert got.steps == want.steps == 12
    assert got.bytes_per_step == want.bytes_per_step == 24
    assert float(got_state) == float(want_state)
    other = ConcurrentExecutor(torch_fn, _prep, depth=1) if kind == "sequential" \
        else SequentialExecutor(torch_fn, _prep)
    assert float(other.run(torch.zeros((), dtype=torch.float32), 12)[0]) == float(got_state)
    assert got.host_prep_s <= got.wall_s and got.steps_per_s > 0


@pytest.mark.gpu
def test_cuda_concurrent_executor_overlaps_host_prep():
    """The port's ``test_concurrent_executor_overlaps_host_prep``: with a
    4 ms host preparation beside a launch that keeps the card busy for
    longer, the concurrent executor hides the preparation behind the device
    work and the sequential one does not. Timed by CUDA events around each
    run: the concurrent run takes less than 0.9 of the sequential one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CPU ops finish before they return")
    n_steps, cycles = 15, 10_000_000  # several ms of device time a launch

    def device_fn(state, args):
        torch.cuda._sleep(cycles)
        return state + float(args["x"])

    def host_prep(step):
        time.sleep(0.004)  # blocking descriptor marshalling (T_calc)
        return {"x": np.float32(step)}

    def timed(executor) -> tuple[float, object]:
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        state = torch.zeros((), device="cuda")
        torch.cuda.synchronize()
        begin.record()
        state, report = executor.run(state, n_steps)
        end.record()
        end.synchronize()
        return begin.elapsed_time(end), (state, report)

    timed(SequentialExecutor(device_fn, host_prep))  # warm-up
    seq_ms, (seq_state, seq) = timed(SequentialExecutor(device_fn, host_prep))
    conc_ms, (conc_state, conc) = timed(ConcurrentExecutor(device_fn, host_prep, depth=2))
    assert float(seq_state) == float(conc_state) == sum(range(n_steps))
    assert seq.steps == conc.steps == n_steps
    assert conc_ms < 0.9 * seq_ms, (seq_ms, conc_ms)
