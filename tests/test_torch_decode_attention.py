"""Decode attention over a K/V cache: ``kernels.ops.decode_attention_op``.

On the CPU the op runs its plain version, which must give the einsums that
``layers.attention_apply`` ran over a bf16 cache before the op took them
bit for bit, at every head width and group count the port's
configurations decode with, one shared position or one a row, and under an
``update_mask`` with a masked row inside the cache and one past it. An
int8 and a sharded (DTensor) cache keep the einsums and never reach the op.
The slice plan is a pure function of the batch, the K/V heads, the cache's
capacity and the SM count, and covers the cache exactly. A build of the
kernel started in the background is waited for, never started twice, and
its failure raises at the first load.

The CUDA kernel runs only on a card: those tests are marked ``gpu`` and skip
here. They hold it to the plain version on the card and within
``ref.decode_attention_f64``'s limit of a float64 computation, in a CUDA
graph whose position the card advances, at the engine's and the served
cells' shapes, and count its launches through a ``serve()`` call. This
file imports no JAX."""

from __future__ import annotations

import dataclasses
import inspect
import os
import sys
import threading
import time

import pytest
import torch

from repro_torch.configs import get
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.decode_attention import (DA_TILE, DecodePlan, decode_attention,
                                                  plan_decode_attention)
from repro_torch.models import layers as L
from repro_torch.models.model import Model

HEAD_DIMS = (64, 96, 112, 128)  # phi4-mini, minitron, qwen2.5-32b, phi-3.5-MoE, jamba: 128;
GROUPS = (1, 3, 4, 5, 7, 8)  # qwen2-0.5b, whisper, paper-lm: 64; phi-3-vision 96; kimi-k2 112
B, T, HKV = 3, 40, 2  # T past one of the kernel's 32-row tiles


def _cfg(d: int, g: int, **over):
    return dataclasses.replace(get("qwen2-0.5b").reduced(), d_model=64, n_heads=HKV * g,
                               n_kv_heads=HKV, head_dim=d, remat="none", **over)


def _layer(cfg, seed: int):
    """One layer's attention weights (bias too), an input and a filled cache."""
    gen = torch.Generator().manual_seed(seed)
    params = {k: w[0] for k, w in L.attention_init(gen, cfg, stack=1).items()}
    for name in ("bq", "bk", "bv"):  # nonzero biases, so a wrong one shows
        params[name] = torch.randn(params[name].shape, generator=gen).to(torch.bfloat16)
    x = torch.randn((B, 1, cfg.d_model), generator=gen).to(torch.bfloat16)
    shape = (B, T, cfg.n_kv_heads, cfg.head_dim_)
    cache = {k: torch.randn(shape, generator=gen).to(torch.bfloat16) for k in ("k", "v")}
    return params, x, cache


POSITIONS = {  # (cache_pos, update_mask): every row at one position, a position a row,
    # and a mask that leaves out a row inside the cache and one past it
    "shared": (torch.tensor(17).expand(B), None),
    "per_row": (torch.tensor([0, T - 1, 31], dtype=torch.int32), None),
    "masked": (torch.tensor([5, T + 3, T - 1], dtype=torch.int32),
               torch.tensor([True, False, False])),
}


def _apply(params, cfg, x, cache, pos, mask):
    return L.attention_apply(params, cfg, x, pos[:, None], cache=cache, cache_pos=pos,
                             update_mask=mask)


@pytest.mark.parametrize("case", list(POSITIONS))
@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_the_op_gives_the_einsum_route_bit_for_bit(d, g, case, monkeypatch):
    """``attention_apply`` over a bf16 cache goes to the op, whose plain
    version gives the einsums' output bit for bit and leaves the same cache."""
    cfg = _cfg(d, g)
    params, x, cache = _layer(cfg, seed=d * 10 + g)
    pos, mask = POSITIONS[case]
    calls = []
    op = ops.decode_attention_op
    monkeypatch.setattr(ops, "decode_attention_op",
                        lambda *a: calls.append(a[0].shape) or op(*a))
    ours = {k: v.clone() for k, v in cache.items()}
    got = _apply(params, cfg, x, ours, pos, mask)
    assert calls == [(B, 1, HKV * g, d)]
    monkeypatch.setattr(L, "_plain_bf16", lambda cache: False)  # the einsums, as before the op
    theirs = {k: v.clone() for k, v in cache.items()}
    want = _apply(params, cfg, x, theirs, pos, mask)
    assert len(calls) == 1
    assert got.dtype == want.dtype == torch.bfloat16
    assert torch.equal(got, want)
    for key in ("k", "v"):
        assert torch.equal(ours[key], theirs[key])
    if mask is not None:  # the masked rows' caches are untouched
        assert torch.equal(ours["k"][1:], cache["k"][1:])


def test_the_op_reads_the_cache_only_up_to_each_position():
    """Rows past a row's position, however large, change nothing; the own new
    K/V stands in for the cache's row at the position; a row past the cache
    attends to all of it."""
    cfg = _cfg(128, 3)
    _, _, cache = _layer(cfg, seed=1)
    gen = torch.Generator().manual_seed(2)
    q = torch.randn((B, 1, HKV * 3, 128), generator=gen).to(torch.bfloat16)
    k, v = (torch.randn((B, 1, HKV, 128), generator=gen).to(torch.bfloat16) for _ in range(2))
    pos = torch.tensor([4, 0, T + 7])
    out = ops.decode_attention_op(q, cache["k"], cache["v"], k, v, pos)
    far = {key: c.clone() for key, c in cache.items()}
    for key in far:
        far[key][0, 5:] = 1e4
        far[key][1, 1:] = -1e4
        far[key][0, 4] = far[key][1, 0] = 7.0  # stood in for by the own rows
    again = ops.decode_attention_op(q, far["k"], far["v"], k, v, pos)
    assert torch.equal(out[:2], again[:2])
    alone = ops.decode_attention_op(q[1:2], cache["k"][1:2, :1], cache["v"][1:2, :1],
                                    k[1:2], v[1:2], pos[1:2])
    assert torch.equal(alone[0, 0], v[1, 0].repeat_interleave(3, 0))  # one row: its own V
    assert torch.equal(out[2:], ref.decode_attention_ref(q[2:], cache["k"][2:], cache["v"][2:],
                                                         torch.zeros_like(k[2:]),
                                                         torch.zeros_like(v[2:]), pos[2:]))


def _f32_numerics(q, k_cache, v_cache, k, v, pos, drop=None):
    """The kernel's numerics in plain PyTorch: scores and softmax in f32, the
    probabilities rounded to bf16 for P.V summed in f32, the output rounded
    to bf16 once; ``drop`` (batch row, cache row) leaves one attended row out."""
    b, _, hq, d = q.shape
    cols = torch.arange(k_cache.shape[1])[None, :]
    own = (cols == pos[:, None])[:, :, None, None]
    k_all, v_all = torch.where(own, k, k_cache), torch.where(own, v, v_cache)
    valid = cols <= pos[:, None]
    if drop is not None:
        valid = valid.clone()
        valid[drop] = False
    scores = ref.gqa_scores(q.float(), k_all.float(), k_cache.shape[2])
    scores = scores.masked_fill(~valid[:, None, None, None, :], float("-inf"))
    p = torch.exp(scores - scores.amax(-1, keepdim=True))
    out = ref.gqa_combine(p.to(torch.bfloat16).float(), v_all.float())
    return (out / p.sum(-1).reshape(b, 1, hq, 1)).to(torch.bfloat16)


@pytest.mark.parametrize("case", list(POSITIONS))
@pytest.mark.parametrize("d", (64, 128))
def test_the_float64_limit_holds_the_kernels_numerics_and_not_a_dropped_row(d, case):
    """``ref.decode_attention_f64``'s limit, which the card's tests hold the
    kernel to, admits the kernel's numerics and refuses them with one
    attended row of one batch row left out."""
    cfg = _cfg(d, 7)
    _, _, cache = _layer(cfg, seed=d)
    gen = torch.Generator().manual_seed(d + 1)
    q = torch.randn((B, 1, HKV * 7, d), generator=gen).to(torch.bfloat16)
    k, v = (torch.randn((B, 1, HKV, d), generator=gen).to(torch.bfloat16) for _ in range(2))
    pos = POSITIONS[case][0]
    args = (q, cache["k"], cache["v"], k, v, pos)
    exact, limit = ref.decode_attention_f64(*args)
    assert exact.shape == limit.shape == q.shape and bool((limit > 0).all())
    assert bool(((_f32_numerics(*args).double() - exact).abs() <= limit).all())
    row = min(int(pos[2]), T - 1) // 2  # inside batch row 2's attended rows
    dropped = _f32_numerics(*args, drop=(2, row))
    assert bool(((dropped.double() - exact).abs() > limit).any())


def test_an_int8_cache_keeps_the_einsums(monkeypatch):
    cfg = _cfg(128, 3, cache_quant="int8")
    params, x, cache = _layer(cfg, seed=3)
    (kq, ks), (vq, vs) = L.quantize_kv(cache["k"]), L.quantize_kv(cache["v"])
    quant = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    monkeypatch.setattr(ops, "decode_attention_op", _never)
    pos, mask = POSITIONS["masked"]
    out = _apply(params, cfg, x, quant, pos, mask)
    assert out.shape == (B, 1, cfg.d_model) and torch.isfinite(out.float()).all()


def _never(*args):
    raise AssertionError("decode_attention_op was called")


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group and its mesh, ended after the test."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,))
    finally:
        dist.destroy_process_group()


def test_a_dtensor_cache_keeps_the_einsums(one_rank, monkeypatch):
    """A sharded step's DTensor cache takes ``_cached_kv`` and the einsums:
    the op is never called, and the output is the plain route's."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = _cfg(128, 3)
    params, x, cache = _layer(cfg, seed=4)
    pos, mask = POSITIONS["masked"]
    want = _apply(params, cfg, x, {k: c.clone() for k, c in cache.items()}, pos, mask)

    def rep(t):
        return DTensor.from_local(t, one_rank, [Replicate()], run_check=False)

    monkeypatch.setattr(ops, "decode_attention_op", _never)
    with implicit_replication():
        got = _apply({k: rep(w) for k, w in params.items()}, cfg, rep(x),
                     {k: rep(c.clone()) for k, c in cache.items()}, rep(pos), rep(mask))
    assert isinstance(got, DTensor)
    assert torch.equal(got.to_local(), want)


PLAN_CASES = [(128, 8, 1152, 132), (256, 8, 256, 132), (4, 2, 256, 132), (1, 8, 4096, 132),
              (4, 8, 24576, 132), (2, 16, 1, 132), (3, 1, 31, 78), (4, 8, 1152, 1)]


@pytest.mark.parametrize("b, hkv, t, sms", PLAN_CASES)
def test_the_slice_plan_covers_the_cache_and_reads_only_its_inputs(b, hkv, t, sms):
    plan = plan_decode_attention(b, hkv, t, sms)
    assert list(inspect.signature(plan_decode_attention).parameters) == ["b", "hkv", "t", "sms"]
    assert plan == plan_decode_attention(b, hkv, t, sms)
    bounds = plan.bounds(t)
    assert len(bounds) == plan.splits >= 1 and plan.chunk % DA_TILE == 0
    assert bounds[0][0] == 0 and bounds[-1][1] == t
    assert all(lo < hi for lo, hi in bounds)
    assert all(a[1] == b_[0] for a, b_ in zip(bounds, bounds[1:]))


def test_the_slice_plan_fills_one_wave_of_short_caches_and_not_more():
    assert plan_decode_attention(128, 8, 1152) == DecodePlan(1, 1152)  # 1,024 blocks already
    assert plan_decode_attention(4, 8, 4096) == DecodePlan(16, 256)  # 32 (row, head) pairs
    assert plan_decode_attention(4, 8, 256).splits == 2  # slices of 128 rows at least
    assert plan_decode_attention(4, 2, 512) == DecodePlan(4, 128)  # the qwen2-0.5b engine's


@pytest.mark.parametrize("bad", ["device", "rank", "group", "pos_shape", "pos_type", "new_kv"])
def test_the_op_rejects_what_it_does_not_take(bad):
    cfg = _cfg(64, 3)
    _, _, cache = _layer(cfg, seed=5)
    q = torch.zeros((B, 1, HKV * 3, 64), dtype=torch.bfloat16)
    k = v = torch.zeros((B, 1, HKV, 64), dtype=torch.bfloat16)
    pos = torch.zeros((B,), dtype=torch.int32)
    args = dict(q=q, k_cache=cache["k"], v_cache=cache["v"], k=k, v=v, pos=pos)
    args.update({"device": dict(q=q.to("meta")), "rank": dict(q=q[:, 0]),
                 "group": dict(q=q[:, :, :5]), "pos_shape": dict(pos=pos[:2]),
                 "pos_type": dict(pos=pos.float()), "new_kv": dict(v=v[:, :, :1])}[bad])
    with pytest.raises((ValueError, TypeError)):
        decode_attention(**args)


def _stub_nvcc(tmp_path, seconds: float, fail: bool = False):
    """An ``nvcc`` that sleeps, appends a line to ``runs`` and writes its
    ``-o`` file (or exits 1)."""
    stub, runs = tmp_path / "nvcc", tmp_path / "runs"
    body = "exit 1" if fail else ('while [ $# -gt 0 ]; do if [ "$1" = -o ]; then shift; '
                                  ': > "$1"; fi; shift; done')
    stub.write_text(f"#!/bin/sh\nsleep {seconds}\necho run >> {runs}\n{body}\n")
    stub.chmod(0o755)
    return str(stub), runs


@pytest.fixture
def stub_build(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "_builds", {})
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "_building", {})
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: object())

    def use(seconds: float, fail: bool = False):
        stub, runs = _stub_nvcc(tmp_path, seconds, fail)
        monkeypatch.setattr(_build.shutil, "which", lambda name: stub)
        return runs

    return use


def _lines(path) -> int:
    return len(path.read_text().splitlines()) if path.exists() else 0


def test_a_load_waits_for_the_background_build_and_runs_no_second_nvcc(stub_build):
    """More threads than cores load the kernel while its background build
    runs, under a short switch interval: one ``nvcc`` run, one record, the
    same build for every caller."""
    runs = stub_build(0.5)
    _build.build_in_background("decode_attention")
    _build.build_in_background("decode_attention")  # already building: nothing new
    got, errors = [], []

    def load():
        try:
            _build.load("decode_attention")
            got.append(_build.build("decode_attention"))
        except Exception as e:  # noqa: BLE001 — reported by the assertion below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=load) for _ in range(2 * (os.cpu_count() or 4))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not any(th.is_alive() for th in threads) and not errors
    assert _lines(runs) == 1
    assert len(got) == len(threads) and all(b is got[0] for b in got)
    assert [b.name for b in _build.builds()] == ["decode_attention"]


def test_a_failed_background_build_raises_at_the_first_load(stub_build):
    runs = stub_build(0.0, fail=True)
    _build.build_in_background("decode_attention")
    deadline = time.monotonic() + 30
    while _lines(runs) < 1 and time.monotonic() < deadline:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="kernel build failed: decode_attention"):
        _build.load("decode_attention")
    with pytest.raises(RuntimeError, match="kernel build failed"):  # tried anew, fails anew
        _build.load("decode_attention")
    assert _lines(runs) == 2 and _build.builds() == []


@pytest.mark.parametrize("arch, device, card, builds", [
    ("phi4-mini-3.8b", "cuda", True, True), ("jamba-1.5-large-398b", "cuda", True, True),
    ("rwkv6-7b", "cuda", True, False), ("phi4-mini-3.8b", "cpu", True, False),
    ("phi4-mini-3.8b", "cuda", False, False), ("phi4-mini-3.8b", "meta", True, False)])
def test_a_model_with_a_kv_cache_on_a_card_starts_the_build(arch, device, card, builds,
                                                            monkeypatch):
    started = []
    monkeypatch.setattr(_build, "build_in_background", started.append)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    Model(get(arch).reduced(), device=device)
    assert started == (["decode_attention"] if builds else [])


def test_serve_run_counts_attention_launches_with_a_default():
    from repro_torch.launch.serve import Graph, ServeRun, serve
    from repro_torch.obs.trace import Tracer

    assert ServeRun(torch.zeros((0, 1)), None, 0, Tracer()).attention_launches == 0
    assert Graph(8, 8).attention_launches == 0
    model = Model(dataclasses.replace(get("phi4-mini-3.8b").reduced(), remat="none"),
                  device="cpu")
    run = serve(model, model.init(0), batch=2, steps=12, cache_len=16, mode="fused", fuse=4)
    assert run.attention_launches == 0  # the plain version on the CPU launches nothing


# ------------------------------------------------------------------ on a card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernel has no CPU mode")


# bf16 output against the plain version, which rounds its scores to bf16 before
# the softmax where the kernel keeps them in f32, and sums in another order: the
# outputs lie within a few bf16 ulps (2**-8 relative) of values of size <= max|v|
RTOL, ATOL = 0.02, 0.02


def _assert_close(got, args, msg=""):
    """Within RTOL, ATOL of the plain version, and within the limit of a
    float64 computation that a result kept in f32 up to its bf16
    probabilities and output meets (``ref.decode_attention_f64``): the
    second check is the tight one, about 0.003 at the served cells."""
    torch.testing.assert_close(got, ref.decode_attention_ref(*args), rtol=RTOL, atol=ATOL,
                               msg=msg or None)
    exact, limit = ref.decode_attention_f64(*args)
    excess = float(((got.double() - exact).abs() - limit).max())
    assert excess <= 0, f"{msg} {excess} past the float64 limit"


def _on_card(b, t, hkv, g, d, seed, pos):
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)

    stacked = {k: randn(2, b, t, hkv, d) for k in ("k", "v")}  # views of a stacked cache
    return (randn(b, 1, hkv * g, d), stacked["k"][1], stacked["v"][1], randn(b, 1, hkv, d),
            randn(b, 1, hkv, d), pos)


@pytest.mark.gpu
@pytest.mark.parametrize("g", (*GROUPS, 2))
@pytest.mark.parametrize("d", (*HEAD_DIMS, 16))  # and the reduced configurations' 16, 2
def test_cuda_kernel_matches_plain_version(d, g):
    """At every (D, G) the port decodes with: one shared position, one a
    row (0, T - 1 and past T among them), on a cache of 300 rows (three
    slices and their merge) and of 100 (one slice), each held by
    ``_assert_close``; every call counts one launch."""
    _card()
    b = 5
    for t, splits in ((300, 3), (100, 1)):
        assert plan_decode_attention(b, 4, t, _build.sm_count(0)).splits == splits
        for pos in (torch.full((b,), t // 2, device="cuda"),
                    torch.tensor([0, t - 1, t + 5, 31, 32], dtype=torch.int32, device="cuda")):
            args = _on_card(b, t, 4, g, d, seed=d + g + t, pos=pos)
            before = decode_attention.launches
            got = decode_attention(*args)
            torch.cuda.synchronize()
            assert decode_attention.launches == before + 1
            _assert_close(got, args, f"T={t} positions {pos.tolist()}")


@pytest.mark.gpu
def test_cuda_kernel_at_the_engines_shape():
    """The continuous-batching engine's qwen2-0.5b decode: 4 slots of 512
    rows, Hkv 2, G 7, D 64, which the default plan cuts into 4 slices; one
    shared position, and one a slot with one at T - 1 and one past T."""
    _card()
    assert plan_decode_attention(4, 2, 512, _build.sm_count(0)).splits == 4
    for pos in (torch.full((4,), 300, device="cuda"), torch.tensor([0, 511, 515, 200],
                                                                   device="cuda")):
        args = _on_card(4, 512, 2, 7, 64, seed=7, pos=pos)
        _assert_close(decode_attention(*args), args, f"positions {pos.tolist()}")


@pytest.mark.gpu
@pytest.mark.parametrize("b, t, positions", [(128, 1152, (575, 1151)), (256, 256, (255,))])
def test_cuda_kernel_at_the_served_cells_shapes(b, t, positions):
    _card()
    for p in positions:
        args = _on_card(b, t, 8, 3, 128, seed=p, pos=torch.full((b,), p, device="cuda"))
        _assert_close(decode_attention(*args), args, f"position {p}")


@pytest.mark.gpu
def test_cuda_kernel_replays_in_a_graph_as_the_card_advances_the_position():
    """Captured once with a device position that the graph itself advances;
    each replay attends one row further, as the plain version at that
    position says, and a masked row past the cache stays on the whole cache."""
    _card()
    b, t = 4, 96
    pos = torch.tensor([0, 30, 60, t + 1], device="cuda")
    q, kc, vc, k, v, _ = _on_card(b, t, 8, 3, 128, seed=9, pos=pos)
    out = torch.empty((b, 1, 24, 128), dtype=torch.bfloat16, device="cuda")
    step = torch.tensor([1, 1, 1, 0], device="cuda")

    def body():
        out.copy_(decode_attention(q, kc, vc, k, v, pos))
        pos.add_(step)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention(q, kc, vc, k, v, pos)  # builds and loads before the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    pos.copy_(torch.tensor([0, 30, 60, t + 1]))
    for i in range(40):
        at = pos.clone()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(pos, at + step)
        _assert_close(out, (q, kc, vc, k, v, at), f"replay {i}")


@pytest.mark.gpu
def test_cuda_kernel_rejects_what_it_does_not_take():
    _card()
    pos = torch.zeros((2,), dtype=torch.int64, device="cuda")

    def call(d=64, g=2, dtype=torch.bfloat16, pos=pos, offset=False):
        q = torch.zeros((2, 1, 2 * g, d), dtype=dtype, device="cuda")
        kc = torch.zeros((2, 8, 2, d + (1 if offset else 0)), dtype=dtype, device="cuda")
        kc = kc[..., 1:] if offset else kc
        k = torch.zeros((2, 1, 2, d), dtype=dtype, device="cuda")
        return decode_attention(q, kc, kc, k, k, pos)

    for bad in (dict(d=136), dict(d=20), dict(d=24), dict(d=32), dict(d=80), dict(g=9),
                dict(dtype=torch.float16),
                dict(dtype=torch.float32), dict(pos=pos.cpu()), dict(offset=True)):
        with pytest.raises((ValueError, TypeError)):
            call(**bad)


@pytest.mark.gpu
def test_serve_counts_the_kernels_launches():
    """A fused ``serve()`` of phi4-mini at its widths, 2 of its layers: the
    wrapper counts a launch a layer for each eager warm-up step and each
    captured step, the run a launch a layer for each step its replays ran;
    RWKV-6, with no K/V cache, launches none."""
    _card()
    from repro_torch.launch.serve import serve

    cfg = dataclasses.replace(get("phi4-mini-3.8b"), n_layers=2, remat="none")
    model = Model(cfg, device="cuda")
    params = model.init(0)
    before = decode_attention.launches
    run = serve(model, params, batch=4, steps=24, cache_len=32, mode="fused", fuse=8)
    captured = sum(g.k for g in run.graphs)
    assert [g.k for g in run.graphs] == [8] and run.graphs[0].replays == 2
    assert decode_attention.launches - before == cfg.n_layers * (8 + captured)
    assert run.graphs[0].attention_launches == cfg.n_layers * 8
    assert run.attention_launches == cfg.n_layers * 16
    del model, params
    rwkv = Model(dataclasses.replace(get("rwkv6-7b").reduced(), remat="none"), device="cuda")
    before = decode_attention.launches
    run = serve(rwkv, rwkv.init(0), batch=4, steps=24, cache_len=32, mode="fused", fuse=8)
    assert decode_attention.launches == before and run.attention_launches == 0
