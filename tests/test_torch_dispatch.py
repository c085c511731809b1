"""The port's scheduled executor against the JAX package's: the same
descriptor leaves in the same order under the same keys, and the same
traffic report for the same launch stream."""

from __future__ import annotations

import jax
import numpy as np
import torch

from repro.dispatch import ScheduledExecutor as JaxExecutor
from repro_torch.dispatch import ScheduledExecutor
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
