"""The port's greedy-sampling kernel against the JAX package's.

On the CPU the wrapper runs its plain version, which must equal
``jnp.argmax`` (``repro.kernels.ref.greedy_sample_ref``) and the Pallas
kernel in interpret mode exactly, ties included; on a NaN it follows
``jnp.argmax``. The CUDA kernel itself runs only on a card: its test is
marked ``gpu`` and skips here. JAX is imported inside the CPU tests so the
``gpu`` test also collects on a machine without it."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.sampling import (GREEDY_CLUSTERS, GreedyPlan, greedy_sample,
                                          max_active_clusters, plan_greedy_sample)

SAMPLE_SHAPES = [(4, 256), (1, 151), (3, 1000), (8, 64)]  # tests/test_kernels.py


def _jax_ids(x: np.ndarray, dtype: str) -> tuple[np.ndarray, np.ndarray, torch.Tensor]:
    """(jnp.argmax ids, Pallas-interpret ids, the same logits as a tensor)."""
    import jax.numpy as jnp
    from _torch_port import to_torch
    from repro.kernels import ops as jax_ops
    from repro.kernels import ref as jax_ref

    logits = jnp.asarray(x).astype(getattr(jnp, dtype))
    return (np.asarray(jax_ref.greedy_sample_ref(logits)),
            np.asarray(jax_ops.sample_op(logits, backend="pallas_interpret")),
            to_torch(logits))


def _adversarial(v: int) -> np.ndarray:
    rows = np.full((4, v), -1.0, np.float32)
    rows[0, [5, 130, 300]] = 3.0  # tie across three 128-wide vocab blocks
    rows[1, [200, 201]] = 2.5  # adjacent tie inside one block
    rows[2, :] = 0.0  # all equal
    rows[3, v - 1] = 9.0  # winner in the final element
    return rows


@pytest.mark.parametrize("shape", SAMPLE_SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_op_matches_jax_exactly(shape, dtype):
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32)
    want, pallas, logits = _jax_ids(x, dtype)
    got = ops.sample_op(logits).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sample_op_ties_take_lowest_index(dtype):
    v = 512
    want, pallas, logits = _jax_ids(_adversarial(v), dtype)
    got = ops.sample_op(logits).numpy()
    np.testing.assert_array_equal(want, [5, 200, 0, v - 1])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)


def test_sample_op_nan_follows_jnp_argmax():
    """NaN ranks above every number and the first NaN wins, as in
    ``jnp.argmax`` (the engine's default sampler). The Pallas kernel
    returns a number's index here; the port follows jnp.argmax."""
    x = np.array([[1.0, np.nan, 3.0, 3.0],
                  [np.nan, 2.0, np.nan, np.inf],
                  [-np.inf, 0.5, np.inf, np.nan]], np.float32)
    for dtype in ("float32", "bfloat16"):
        want, _, logits = _jax_ids(x, dtype)
        np.testing.assert_array_equal(want, [1, 0, 3])
        np.testing.assert_array_equal(ops.sample_op(logits).numpy(), want)


@pytest.mark.parametrize("bad", ["int32", "rank3", "strided", "empty_vocab", "meta"])
def test_greedy_sample_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros((4, 64))
    bad_input = {
        "int32": x.to(torch.int32),
        "rank3": x[None],
        "strided": torch.zeros((64, 4)).T,
        "empty_vocab": torch.zeros((4, 0)),
        # a meta tensor takes the shape-only route, which keeps the kernel's
        # checks: a layout the kernel does not take still raises there
        "meta": torch.zeros((64, 4), device="meta").T,
    }[bad]
    with pytest.raises((TypeError, ValueError)):
        greedy_sample(bad_input)


def test_cpu_tensor_runs_the_plain_version_and_launches_nothing():
    before = greedy_sample.launches
    x = torch.randn((3, 100), generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(greedy_sample(x), ref.greedy_sample_ref(x), rtol=0, atol=0)
    assert greedy_sample.launches == before


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """No fallback: with no nvcc to be found, building a kernel raises."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build, "_builds", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("greedy_sample")


def test_builds_lists_each_nvcc_run_and_load_on_the_profilers_clock(monkeypatch, tmp_path):
    """With a stub ``nvcc`` (it writes its ``-o`` file and a line of log) and
    a stub ``ctypes.CDLL``: ``builds()`` holds one record a kernel built, in
    build order, however often it is built or loaded; its ``nvcc`` run and
    its load lie between two reads of ``time.time_ns`` around them, and
    ``seconds`` is the ``nvcc`` span's length."""
    import time

    stub = tmp_path / "nvcc"
    stub.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do if [ "$1" = -o ]; then shift; : > "$1"; '
                    'fi; shift; done\necho "ptxas info: stub"\n')
    stub.chmod(0o755)
    monkeypatch.setattr(_build.shutil, "which", lambda name: str(stub))
    monkeypatch.setattr(_build, "_builds", {})
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    loaded = []
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: loaded.append(path) or object())
    assert _build.builds() == []
    before = time.time_ns()
    first = _build.build("top_k")
    _build.build("top_k")
    _build.load("greedy_sample")
    _build.load("greedy_sample")
    after = time.time_ns()
    got = _build.builds()
    assert [b.name for b in got] == ["top_k", "greedy_sample"]
    assert loaded == [str(tmp_path / "build" / "libgreedy_sample.so")]
    assert got[0] is first and first.load_ns is None and "ptxas info: stub" in first.log
    for b in got:
        assert before <= b.nvcc_ns[0] <= b.nvcc_ns[1] <= after
        assert b.seconds == (b.nvcc_ns[1] - b.nvcc_ns[0]) / 1e9
    load = got[1].load_ns
    assert got[1].nvcc_ns[1] <= load[0] <= load[1] <= after


@pytest.mark.gpu
def test_cuda_kernel_matches_plain_version():
    """The hand-written kernel against its plain version on the card,
    exactly, at the decode shapes and on adversarial rows; every call adds
    one launch to the wrapper's count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = [torch.randn((b, v), generator=gen, device="cuda")
             for b, v in [(1, 151_936), (4, 151_936), (64, 151_936), *SAMPLE_SHAPES]]
    cases.append(torch.from_numpy(_adversarial(512)).cuda())
    nan_rows = torch.tensor([[1.0, float("nan"), 3.0, 3.0]] * 2, device="cuda")
    cases.append(nan_rows)
    for x in cases:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            before = greedy_sample.launches
            got = greedy_sample(x.to(dtype))
            torch.cuda.synchronize()
            assert greedy_sample.launches == before + 1
            torch.testing.assert_close(got, ref.greedy_sample_ref(x.to(dtype)),
                                       rtol=0, atol=0)


def _across_cluster_chunks(b: int, v: int) -> torch.Tensor:
    """(b, v) rows of -1 on the card whose ties and NaNs straddle each chunk
    boundary ``plan_greedy_sample`` gives: row r takes pattern r % 4, a tie
    of 5 across each boundary, a NaN on each side, +inf on both sides, or
    zeros of both signs everywhere."""
    x = torch.full((b, v), -1.0, device="cuda")
    for start, _ in plan_greedy_sample(b, v).bounds(v)[1:]:
        x[0::4, start - 3:start + 3] = 5.0
        x[1::4, start - 1:start + 1] = float("nan")
        x[2::4, start - 2:start + 2] = float("inf")
    x[3::4] = 0.0
    x[3::4, ::7] = -0.0
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 4, 64])
def test_cuda_kernel_is_exact_across_its_cluster_chunks(b):
    """Ties and NaNs on both sides of every chunk boundary, and random rows,
    exactly, in the three types; each launch is counted at the plan's
    cluster size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")
    v = 151_936
    plan = plan_greedy_sample(b, v)
    assert plan.cluster > 1
    gen = torch.Generator(device="cuda").manual_seed(b)
    for x in (_across_cluster_chunks(b, v), torch.randn((b, v), generator=gen, device="cuda")):
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            before = dict(greedy_sample.launches_by_cluster)
            got = greedy_sample(x.to(dtype))
            torch.cuda.synchronize()
            assert greedy_sample.launches_by_cluster[plan.cluster] == before[plan.cluster] + 1
            torch.testing.assert_close(got, ref.greedy_sample_ref(x.to(dtype)), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("cluster", GREEDY_CLUSTERS)
def test_cuda_kernel_is_exact_at_every_cluster_size(cluster):
    """Every cluster the kernel launches, 16 where the card places it, on
    rows whose chunks start off 16-byte alignment (V odd)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")
    if max_active_clusters(cluster) == 0:
        pytest.skip(f"this card places no cluster of {cluster} blocks")
    v = 151_935
    chunk = -(-(-(-v // cluster)) // 8) * 8
    plan = GreedyPlan(cluster, chunk)
    gen = torch.Generator(device="cuda").manual_seed(cluster)
    x = torch.randn((4, v), generator=gen, device="cuda")
    for start, _ in plan.bounds(v)[1:]:
        x[:, start - 1:start + 1] = 7.0
    for dtype in (torch.float32, torch.bfloat16, torch.float16):
        got = greedy_sample(x.to(dtype), plan)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, ref.greedy_sample_ref(x.to(dtype)), rtol=0, atol=0)
