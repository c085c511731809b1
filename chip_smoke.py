#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its results; any failure exits non-zero:

1. Device: the card's name, the device count, and nvidia-smi's name and
   power limit. No CUDA device is a failure.
2. Build: every kernel under ``src/repro_torch/kernels/csrc/`` with nvcc for
   sm_90a, one nvcc per source, all started together, with the build
   seconds and the ``-Xptxas -v`` register and shared-memory report.
3. Kernel check of greedy_sample against its plain PyTorch version on the
   card, exactly, at the serving path's shapes, on adversarial rows and on
   ties and NaNs straddling the chunk boundaries of its cluster split, each
   call printing its cluster size; then its time at B = 1, 4 and 64, the
   plain version's, the PyTorch library call's, top_k(x, 1)'s and its
   bound, and its time at each cluster size the card places.
4. Main path: full-width qwen2-0.5b with seeded weights, served by
   ``ServingEngine(sampling="fused")`` (8 requests), with the kernels' launch
   counts read just after; then the same requests with ``sampling="host"``,
   whose token streams must be bit-identical.
5. Full-width numerics: ``forward`` logits against teacher-forced
   ``decode_step`` logits.
6. Kernel check of matmul, configured_matmul, flash_attention and top_k,
   each against its plain version at its stated tolerance, at the
   calibration ladder's shapes, at qwen2-0.5b's widths and on adversarial
   inputs, then timed as in 3. matmul and flash_attention print the route
   each call took (wgmma, pipelined or simt, by the wrappers' per-route
   counters), are checked on every route, and must take wgmma for bf16 at
   qwen2-0.5b's widths; a position-coded bf16 product must come out
   exactly. Their SIMT kernels are timed beside the new routes. Each SIMT
   flash_attention call prints its plan (keys split across a cluster) and
   staging, and each f32 one its error and the plain version's against
   float64 (the kernel's may not pass twice the plain version's); every
   calibration-ladder shape is timed in f32 beside SDPA, and the served
   shape at every split.
   configured_matmul prints its route (wgmma for aligned int8, simt
   otherwise), must take wgmma for int8 at qwen2-0.5b's width, must give a
   position-coded int8 product exactly, and must equal the float64 answer
   exactly at K = 4096 with full-range zero points; it is timed beside
   torch.matmul on centred f32 operands and torch._int_mm. top_k prints the
   number of blocks each row is split into, is checked at B = 1, 4 and 64,
   on ties and NaNs across chunk boundaries and on a row off 16-byte
   alignment, and is timed at k = 1, 8 and 64, by device time alone at
   k = 2 to 32, and at B = 1 and 64 beside torch.topk.
7. Calibration path: ``repro_torch.engine.calibrate.run_calibration`` over
   the full shape ladder on the card, each fit and sample printed beside the
   sample's device time, with the matmul, flash_attention and greedy_sample
   launch counts read just after (f32 flash_attention all staged by
   cp.async, the ladder's sampling rows all whole).
8. Ops path: ``kernels.ops.configured_matmul_op`` on int8 operands at
   qwen2-0.5b's MLP width and ``kernels.ops.top_k_op`` on the served
   model's last-position logits, the only entry points of those two
   kernels, and ``matmul_op`` and ``attention_op`` in bf16 at qwen2-0.5b's
   widths (the wgmma routes, which the calibration's f32 does not run),
   with their launch counts read just after; the int8 product must take
   configured_matmul's wgmma route.

Float32 products run in full float32 throughout: TF32 is switched off for
both matmul and cuDNN, so the plain versions are exact f32 references.

The last lines are the kernels' JSON record, nvidia-smi's name and power
limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA's data sheet
F32_FLOPS = 67e12  # f32 outside the tensor cores
BF16_FLOPS = 989e12  # dense, tensor cores
INT8_OPS = 1979e12  # dense, tensor cores
QWEN_M, QWEN_D, QWEN_FF, QWEN_V = 512, 896, 4864, 151_936  # 512 tokens through the MLP up-projection
SEED = 0
N_REQUESTS = 8
MAX_NEW = 32
PARITY_RTOL, PARITY_ATOL, PARITY_TOP1 = 0.05, 0.15, 0.9  # test_decode_parity's


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def _events_ms(run, reps: int) -> float:
    """Mean time of ``run`` over ``reps`` calls, by CUDA events around them."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, calls: int = 100, reps: int = 20) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph and replayed, so the host's cost of issuing a call is off the
    clock (the small gap between two kernels of a graph stays on it)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    _events_ms(graph.replay, 2)  # warm-up
    return _events_ms(graph.replay, reps) / calls


def _call_ms(fn, calls: int = 500) -> float:
    """Time per call of ``fn`` issued from Python one after another: the
    host's issue rate when it exceeds the device time."""
    _events_ms(fn, 50)  # warm-up
    return _events_ms(fn, calls)


def phase_device() -> tuple[str, str]:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"[device] {name}; device_count={torch.cuda.device_count()}; "
          f"nvidia-smi: {smi}")
    return name, smi


def _timed(label: str, runs: dict, bound_ms: float, bound_by: str, smi: str) -> dict:
    """Device time per call of each of ``runs`` (kernel ``ms``, ``plain_ms``,
    ``library_ms``) by CUDA graph, median of two rounds in alternating
    order; prints it beside the per-call issue time from Python."""
    times = {k: [] for k in runs}
    calls = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):  # in turns, both orders
        for k in order:
            times[k].append(_device_ms(runs[k]))
            calls[k].append(_call_ms(runs[k]))
    ms = {k: float(np.median(t)) for k, t in times.items()}
    call = {k: float(np.median(t)) for k, t in calls.items()}
    names = {"ms": "kernel_ms"}
    print(f"[kernel] {label}, device time per call (CUDA graph): "
          + " ".join(f"{names.get(k, k)}={v:.5f}" for k, v in ms.items())
          + f" bound_ms={bound_ms:.5f} ({bound_by}; {smi})")
    print(f"[kernel] {label}, per call issued from Python: "
          + " ".join(f"{names.get(k, k)}={v:.5f}" for k, v in call.items()) + f" ({smi})")
    return ms


def _bound_ms(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over HBM
    bandwidth and the operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _record(name: str, source: str, replaces: str, err: float, ms: dict, bound: tuple,
            **extra) -> dict:
    """One kernel's entry in the JSON record; ``extra`` adds keys such as the
    wrapper's route (``path``) and the operands' type."""
    return {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "max_abs_err": err, "ms": ms["ms"],
            "plain_ms": ms["plain_ms"], "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": ms["library_ms"], **extra}


def _off_alignment(x: torch.Tensor) -> torch.Tensor:
    """The same values, contiguous, one element past a 16-byte boundary:
    the wrappers send such operands to their SIMT kernels."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def _routed(wrapper, fn) -> tuple:
    """``fn()``'s result and the route its one launch took, by the wrapper's
    per-route counters."""
    before = dict(wrapper.launches_by_route)
    out = fn()
    moved = [r for r, n in wrapper.launches_by_route.items() if n != before[r]]
    if len(moved) != 1 or wrapper.launches_by_route[moved[0]] != before[moved[0]] + 1:
        raise SystemExit(f"one call launched {wrapper.launches_by_route} after {before}")
    return out, moved[0]


def phase_build() -> None:
    from repro_torch.kernels import _build

    for b in _build.build_all(_build.kernel_names()):
        print(f"[build] {b.name}: {b.seconds:.2f} s -> {b.path.name}")
        for line in b.log.splitlines():
            print(f"[build]   {line}")


def _adversarial(v: int, dtype: torch.dtype) -> torch.Tensor:
    rows = torch.full((6, v), -1.0, dtype=torch.float32)
    rows[0, [5, v // 2, v - 7]] = 3.0  # ties far apart: the lowest index wins
    rows[1, [v // 4, v // 4 + 1]] = 2.5  # adjacent tie
    rows[2, :] = 0.0  # all equal: index 0
    rows[3, v - 1] = 9.0  # winner in the last element
    rows[4, [3, v // 3]] = float("nan")  # first NaN wins over every number
    rows[4, 10] = float("inf")
    rows[5, :] = float("-inf")  # all -inf: index 0
    return rows.to(dtype).cuda()


def _across_cluster_chunks(b: int, v: int) -> torch.Tensor:
    """(b, v) rows of -1 whose ties and NaNs straddle every chunk boundary
    that ``plan_greedy_sample`` gives at that shape: row r takes pattern
    r % 4, a tie of 5 across each boundary, a NaN on each side, +inf on
    both sides, or zeros of both signs everywhere."""
    from repro_torch.kernels.sampling import plan_greedy_sample

    x = torch.full((b, v), -1.0, device="cuda")
    for start, _ in plan_greedy_sample(b, v).bounds(v)[1:]:
        x[0::4, start - 3:start + 3] = 5.0
        x[1::4, start - 1:start + 1] = float("nan")
        x[2::4, start - 2:start + 2] = float("inf")
    x[3::4] = 0.0
    x[3::4, ::7] = -0.0
    return x


def _cluster_of(fn) -> tuple:
    """``fn()``'s result and the cluster size its one greedy_sample launch
    took, by the wrapper's per-cluster counters."""
    from repro_torch.kernels.sampling import greedy_sample

    before = dict(greedy_sample.launches_by_cluster)
    out = fn()
    moved = [c for c, n in greedy_sample.launches_by_cluster.items() if n != before[c]]
    if len(moved) != 1:
        raise SystemExit(f"one call launched {greedy_sample.launches_by_cluster} after {before}")
    return out, moved[0]


def phase_kernel_check(smi: str) -> dict:
    """greedy_sample exactly against its plain version: random rows at B =
    1, 4, 8 and 64, adversarial rows, and ties and NaNs straddling the
    plan's chunk boundaries at B = 1, 4 and 64, in three types, each call
    printing its cluster size; then timed at B = 1, 4 and 64 beside
    torch.argmax and top_k(x, 1), and the cluster sizes 4, 8 and 16 probed
    at B = 1 and 4 where the card places them."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sampling import (GreedyPlan, greedy_sample, max_active_clusters,
                                              top_k)

    v = 151_936
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = []
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for b in (1, 4, 8, 64):
            cases.append((f"B={b} V={v} {dtype}", torch.randn(
                (b, v), generator=gen, device="cuda").to(dtype)))
        for vv in (v, v - 1, 1000, 151):  # v - 1 and 151: rows start unaligned
            cases.append((f"adversarial V={vv} {dtype}", _adversarial(vv, dtype)))
        for b in (1, 4, 64):
            cases.append((f"across cluster chunks B={b} V={v} {dtype}",
                          _across_cluster_chunks(b, v).to(dtype)))
    worst = 0
    for label, x in cases:
        got, cluster = _cluster_of(lambda: greedy_sample(x))
        want = ref.greedy_sample_ref(x)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        print(f"[kernel] greedy_sample {label}: cluster={cluster} max_abs_err={err}")
        if err:
            raise SystemExit(f"greedy_sample disagrees with its plain version on {label}: "
                             f"{got.tolist()[:8]} vs {want.tolist()[:8]}")

    timed, clusters = {}, {}
    for b in (4, 1, 64):
        x = torch.randn((b, v), generator=gen, device="cuda").to(torch.bfloat16)
        runs = {"ms": lambda: greedy_sample(x),
                "plain_ms": lambda: ref.greedy_sample_ref(x),
                "library_ms": lambda: torch.argmax(x, dim=-1),
                "top_k1_ms": lambda: top_k(x, 1)}
        bound = _bound_ms(x.numel() * x.element_size() + b * 4, 0.0, 1.0)
        _, cluster = _cluster_of(lambda: greedy_sample(x))
        clusters[b] = cluster
        timed[b] = (_timed(f"greedy_sample B={b} V={v} bf16, cluster of {cluster} (top_k1_ms: "
                           f"top_k(x, 1))", runs, *bound, smi), bound)
    places = {c: max_active_clusters(c) for c in (4, 8, 16)}
    print(f"[kernel] greedy_sample clusters the card holds at once, by size: {places}")
    for b in (1, 4):
        x = torch.randn((b, v), generator=gen, device="cuda").to(torch.bfloat16)
        probe = {}
        for c in (c for c, n in places.items() if n > 0):
            plan = GreedyPlan(c, -(-(-(-v // c)) // 8) * 8)
            if not torch.equal(greedy_sample(x, plan), ref.greedy_sample_ref(x)):
                raise SystemExit(f"greedy_sample with a cluster of {c} disagrees at B={b}")
            probe[c] = _device_ms(lambda: greedy_sample(x, plan))
        print(f"[kernel] greedy_sample B={b} V={v} bf16, device ms by cluster size: "
              + " ".join(f"{c}:{t:.5f}" for c, t in probe.items()) + f" ({smi})")
    ms, bound = timed[4]
    return _record("greedy_sample", "greedy_sample.cu", "src/repro/kernels/sampling.py:66",
                   worst, ms, bound, cluster=clusters[4], top_k1_ms=ms["top_k1_ms"],
                   ms_b1=timed[1][0]["ms"], library_ms_b1=timed[1][0]["library_ms"],
                   ms_b64=timed[64][0]["ms"], library_ms_b64=timed[64][0]["library_ms"])


def _max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    diff = (got.float() - want.float()).abs()
    both_nan = got.float().isnan() & want.float().isnan()
    return float(diff.masked_fill(both_nan, 0.0).max()) if diff.numel() else 0.0


def _issue_abba(label: str, wgmma, simt, smi: str) -> None:
    """Per-call issue time from Python of the two routes at a shape whose
    device time is well below it, so the difference is host time: the TMA
    maps the wgmma route encodes at each call. In turns (wgmma, simt, simt,
    wgmma), medians."""
    t = {"wgmma": [], "simt": []}
    for route, fn in (("wgmma", wgmma), ("simt", simt), ("simt", simt), ("wgmma", wgmma)):
        t[route].append(_call_ms(fn))
    print(f"[kernel] {label}, per call issued from Python: wgmma_ms="
          f"{np.median(t['wgmma']):.5f} simt_ms={np.median(t['simt']):.5f} ({smi})")


def _position_coded(m: int, k: int, n: int) -> tuple:
    """bf16 operands whose product is known exactly: A selects row
    sel(i) = (7 i + 3) mod K of B for row i of C (0/1 entries) and B holds
    the small integers 16 (k mod 16) + (n mod 16), exact in bf16. Every
    C[i, j] must equal B[sel(i), j], and a wrong value names the row and
    column of B it came from."""
    sel = (torch.arange(m, device="cuda") * 7 + 3) % k
    a = torch.zeros((m, k), device="cuda")
    a[torch.arange(m, device="cuda"), sel] = 1
    b = (torch.arange(k, device="cuda")[:, None] % 16 * 16
         + torch.arange(n, device="cuda")[None, :] % 16).float()
    return a.bfloat16(), b.bfloat16(), sel


def check_matmul(smi: str) -> list[dict]:
    """f32 at rtol 1e-4 (atol 1e-3: the rounding of <= 896-term f32 sums
    taken in another order), bf16 at test_matmul_matches_oracle's 2e-2, at
    the calibration ladder's shapes and at qwen2-0.5b's MLP width, each
    through the route the wrapper chooses, and once more off 16-byte
    alignment (the SIMT route); the position-coded bf16 product exactly.
    The qwen-width bf16 call must take the wgmma route."""
    from repro_torch.engine.calibrate import SHAPES
    from repro_torch.kernels import ref
    from repro_torch.kernels.matmul import matmul

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for m, k, n in [*SHAPES["matmul"], (QWEN_M, QWEN_D, QWEN_FF), (130, 70, 33), (130, 72, 200)]:
        a = torch.randn((m, k), generator=gen, device="cuda")
        b = torch.randn((k, n), generator=gen, device="cuda")
        for dtype, tol in ((torch.float32, dict(rtol=1e-4, atol=1e-3)),
                           (torch.bfloat16, dict(rtol=2e-2, atol=2e-2))):
            for off in (False, True):
                x, y = a.to(dtype), b.to(dtype)
                if off:
                    x = _off_alignment(x)
                got, route = _routed(matmul, lambda: matmul(x, y))
                want = ref.matmul_ref(x, y)
                torch.cuda.synchronize()
                err = _max_err(got, want)
                worst[dtype] = max(worst[dtype], err)
                print(f"[kernel] matmul ({m},{k})x({k},{n}) {dtype}{' off-aligned' if off else ''}:"
                      f" route={route} max_abs_err={err:.6g}")
                torch.testing.assert_close(got, want, **tol)
                if (m, k, n, dtype, off) == (QWEN_M, QWEN_D, QWEN_FF, torch.bfloat16, False) \
                        and route != "wgmma":
                    raise SystemExit(f"the qwen-width bf16 matmul took route {route}, not wgmma")
    for m, k, n in [(QWEN_M, QWEN_D, QWEN_FF), (128, 128, 128), (130, 72, 200), (5, 8, 8)]:
        a, b, sel = _position_coded(m, k, n)
        got, route = _routed(matmul, lambda: matmul(a, b))
        torch.cuda.synchronize()
        wrong = (got.float() != b[sel].float()).nonzero()
        for i, j in wrong[:8].tolist():
            v = int(got[i, j].float())
            print(f"[kernel]   C[{i},{j}] = {v}: from k % 16 = {v // 16}, n % 16 = {v % 16}; "
                  f"wanted k = {int(sel[i])} (k % 16 = {int(sel[i]) % 16}), n % 16 = {j % 16}")
        print(f"[kernel] matmul position-coded ({m},{k})x({k},{n}) bf16: route={route} "
              f"wrong={len(wrong)} of {m * n}")
        if len(wrong) or route != "wgmma":
            raise SystemExit("the position-coded bf16 product is not exact on the wgmma route")

    m, k, n = QWEN_M, QWEN_D, QWEN_FF
    a = torch.randn((m, k), generator=gen, device="cuda")
    b = torch.randn((k, n), generator=gen, device="cuda")
    ab, bb = a.bfloat16(), b.bfloat16()
    ab_off, a_off = _off_alignment(ab), _off_alignment(a)
    bound16 = _bound_ms(2 * (m * k + k * n + m * n), 2 * m * k * n, BF16_FLOPS)
    ms16 = _timed(f"matmul ({m},{k})x({k},{n}) bf16 (route wgmma; simt_ms: the SIMT kernel)", {
        "ms": lambda: matmul(ab, bb), "plain_ms": lambda: ref.matmul_ref(ab, bb),
        "library_ms": lambda: torch.matmul(ab, bb), "simt_ms": lambda: matmul(ab_off, bb)},
        *bound16, smi)
    bound = _bound_ms(4 * (m * k + k * n + m * n), 2 * m * k * n, F32_FLOPS)
    ms = _timed(f"matmul ({m},{k})x({k},{n}) f32 (route pipelined; simt_ms: the SIMT kernel)", {
        "ms": lambda: matmul(a, b), "plain_ms": lambda: ref.matmul_ref(a, b),
        "library_ms": lambda: torch.matmul(a, b), "simt_ms": lambda: matmul(a_off, b)},
        *bound, smi)
    for mm_, kk, nn in SHAPES["matmul"]:
        x = torch.randn((mm_, kk), generator=gen, device="cuda")
        y = torch.randn((kk, nn), generator=gen, device="cuda")
        x_off = _off_alignment(x)
        print(f"[kernel] matmul ({mm_},{kk})x({kk},{nn}) f32 device ms: "
              f"pipelined={_device_ms(lambda: matmul(x, y)):.5f} "
              f"simt={_device_ms(lambda: matmul(x_off, y)):.5f} ({smi})")
    x = torch.randn((128, 128), generator=gen, device="cuda").bfloat16()
    x_off = _off_alignment(x)
    _issue_abba("matmul (128,128)x(128,128) bf16 (wgmma encodes 2 TMA maps a call)",
                lambda: matmul(x, x), lambda: matmul(x_off, x), smi)
    return [_record("matmul", "matmul.cu", "src/repro/kernels/matmul.py:46",
                    worst[torch.float32], ms, bound, dtype="float32", path="pipelined"),
            _record("matmul_bf16", "matmul_wgmma.cu", "src/repro/kernels/matmul.py:46",
                    worst[torch.bfloat16], ms16, bound16, dtype="bfloat16", path="wgmma")]


def _position_coded_int8(m: int, n: int) -> tuple:
    """int8 operands whose product is known exactly: A (m, 128) has one 1 a
    row, at column i % 128 (the identity, stacked), and B (128, n) holds
    16 (k mod 16) + (n mod 16) - 128. Every C[i, j] must equal
    B[i % 128, j], and a wrong value names the row and column of B it came
    from."""
    sel = torch.arange(m, device="cuda") % 128
    a = torch.zeros((m, 128), dtype=torch.int8, device="cuda")
    a[torch.arange(m, device="cuda"), sel] = 1
    b = (torch.arange(128, device="cuda")[:, None] % 16 * 16
         + torch.arange(n, device="cuda")[None, :] % 16 - 128).to(torch.int8)
    return a, b, sel


def check_configured_matmul(smi: str) -> dict:
    """Integer-valued operands with zero points in [-8, 8]: every sum is an
    integer below 2**24, so each route must equal the plain version exactly;
    int8 takes wgmma where aligned, simt one byte off (f32 and bf16 always
    simt). The position-coded int8 product must come out exactly on wgmma,
    and full-range int8 at K = 4096 with zero points (-128, 127), where the
    f32 plain version is no longer exact, must equal the float64 answer."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.matmul import configured_matmul

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = 0.0
    for m, k, n in [(128, 128, 128), (QWEN_M, QWEN_D, QWEN_FF), (70, 130, 33), (130, 144, 208)]:
        a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda")
        b = torch.randint(-128, 128, (k, n), generator=gen, device="cuda")
        for dtype in (torch.int8, torch.float32, torch.bfloat16):
            for zp in ((-8, 8), (0, 0), (5, -3)):
                for off in (False, True) if dtype == torch.int8 else (False,):
                    x, y = a.to(dtype), b.to(dtype)
                    if off:
                        x = _off_alignment(x)
                    got, route = _routed(configured_matmul, lambda: configured_matmul(x, y, zp))
                    want = ref.configured_matmul_ref(x, y, *zp)
                    torch.cuda.synchronize()
                    err = _max_err(got, want)
                    worst = max(worst, err)
                    print(f"[kernel] configured_matmul ({m},{k})x({k},{n}) {dtype} zp={zp}"
                          f"{' off-aligned' if off else ''}: route={route} max_abs_err={err}")
                    torch.testing.assert_close(got, want, rtol=0, atol=0)
                    aligned_int8 = dtype == torch.int8 and not off and k % 16 == 0 \
                        and n % 16 == 0
                    if route != ("wgmma" if aligned_int8 else "simt"):
                        raise SystemExit(f"configured_matmul took route {route} for {dtype}"
                                         f"{' off-aligned' if off else ''} at ({m},{k},{n})")
    for m, n in [(128, 128), (128, QWEN_FF), (QWEN_M, QWEN_FF)]:
        a, b, sel = _position_coded_int8(m, n)
        got, route = _routed(configured_matmul, lambda: configured_matmul(a, b, (0, 0)))
        torch.cuda.synchronize()
        wrong = (got != b[sel].float()).nonzero()
        for i, j in wrong[:8].tolist():
            v = int(got[i, j]) + 128
            print(f"[kernel]   C[{i},{j}] = {int(got[i, j])}: from k % 16 = {v // 16}, "
                  f"n % 16 = {v % 16}; wanted k % 16 = {int(sel[i]) % 16}, n % 16 = {j % 16}")
        print(f"[kernel] configured_matmul position-coded ({m},128)x(128,{n}) int8: "
              f"route={route} wrong={len(wrong)} of {m * n}")
        if len(wrong) or route != "wgmma":
            raise SystemExit("the position-coded int8 product is not exact on the wgmma route")
    a = torch.randint(-128, 128, (128, 4096), generator=gen, device="cuda").to(torch.int8)
    b = torch.randint(-128, 128, (4096, 128), generator=gen, device="cuda").to(torch.int8)
    zp = (-128, 127)
    got, route = _routed(configured_matmul, lambda: configured_matmul(a, b, zp))
    exact = ((a.double() - zp[0]) @ (b.double() - zp[1])).float()
    plain = ref.configured_matmul_ref(a, b, *zp)
    torch.cuda.synchronize()
    print(f"[kernel] configured_matmul (128,4096)x(4096,128) int8 zp={zp}: route={route} "
          f"max_abs_err against float64={_max_err(got, exact)}, the f32 plain version's "
          f"against float64={_max_err(plain, exact)}")
    torch.testing.assert_close(got, exact, rtol=0, atol=0)
    if route != "wgmma":
        raise SystemExit(f"the K = 4096 int8 product took route {route}, not wgmma")

    m, k, n = QWEN_M, QWEN_D, QWEN_FF
    a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda").to(torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
    a_off = _off_alignment(a)
    zp = (-8, 8)
    a_c, b_c = a.float() - zp[0], b.float() - zp[1]  # centred before the timed call
    bound = _bound_ms(m * k + k * n + 4 * m * n, 2 * m * k * n, INT8_OPS)
    ms = _timed(f"configured_matmul ({m},{k})x({k},{n}) int8 zp={zp} (route wgmma; library: "
                f"torch.matmul on f32 operands centred beforehand; int_mm_ms: torch._int_mm, "
                f"int8 to int32 without zero points; simt_ms: the SIMT kernel, A one byte off)", {
                    "ms": lambda: configured_matmul(a, b, zp),
                    "plain_ms": lambda: ref.configured_matmul_ref(a, b, *zp),
                    "library_ms": lambda: torch.matmul(a_c, b_c),
                    "int_mm_ms": lambda: torch._int_mm(a, b),
                    "simt_ms": lambda: configured_matmul(a_off, b, zp)}, *bound, smi)
    return _record("configured_matmul", "configured_matmul_wgmma.cu",
                   "src/repro/kernels/matmul.py:95", worst, ms, bound, dtype="int8",
                   path="wgmma", int_mm_ms=ms["int_mm_ms"], simt_ms=ms["simt_ms"])


def _attention_f64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """Softmax attention in float64, the bottom-right causal mask."""
    sq, sk = q.shape[2], k.shape[2]
    s = q.double() @ k.double().transpose(-1, -2) / float(q.shape[-1]) ** 0.5
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, float("-inf"))
    return torch.softmax(s, dim=-1) @ v.double()


def _staged(fn) -> tuple:
    """``fn()``'s result and the staging its one SIMT launch took, by the
    wrapper's per-staging counters (None for another route)."""
    from repro_torch.kernels.flash_attention import flash_attention

    before = dict(flash_attention.launches_by_staging)
    out = fn()
    moved = [s for s, n in flash_attention.launches_by_staging.items() if n != before[s]]
    return out, moved[0] if moved else None


def _abba_ms(a, b) -> tuple[float, float]:
    """Device times of ``a`` and ``b`` by CUDA graph, in turns (a, b, b, a),
    medians."""
    t = {"a": [], "b": []}
    for key, fn in (("a", a), ("b", b), ("b", b), ("a", a)):
        t[key].append(_device_ms(fn))
    return float(np.median(t["a"])), float(np.median(t["b"]))


def check_flash_attention(smi: str) -> list[dict]:
    """3e-2 (test_flash_attention_matches_oracle's) at qwen2-0.5b's 14 heads
    of 64, causal and full, f32 and bf16; at the decode shape against 256
    keys; causal Sq < Sk; at the calibration ladder's shapes; at D = 40 and
    128; and on the SIMT route (D = 36, and off 16-byte alignment). The
    qwen-width bf16 call must take the wgmma route. Each SIMT call prints
    its plan (blocks of 64 query rows, keys split across a cluster) and its
    staging; each f32 call prints its error and the plain f32 version's
    against a float64 answer, and the kernel's may not pass twice the plain
    version's. Every ladder shape is timed in f32 beside SDPA, and the
    served shape at every split."""
    import torch.nn.functional as F

    from repro_torch.engine.calibrate import SHAPES
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import AttnPlan, flash_attention, plan_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases = [((1, 14, 512, 64),) * 2, ((2, 4, 1, 64), (2, 4, 256, 64)),
             ((1, 2, 128, 64), (1, 2, 256, 64)), ((1, 2, 100, 128), (1, 2, 300, 128)),
             ((1, 2, 33, 40), (1, 2, 65, 40)), ((1, 2, 200, 40),) * 2, ((1, 2, 33, 36),) * 2]
    cases += [((1, 1, s, d),) * 2 for s, d, _ in SHAPES["flash_attention"]]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for qs, ks in cases:
        q, k, v = (torch.randn(s, generator=gen, device="cuda") for s in (qs, ks, ks))
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                for off in (False, True) if dtype == torch.bfloat16 else (False,):
                    args = (_off_alignment(q.to(dtype)) if off else q.to(dtype), k.to(dtype),
                            v.to(dtype))
                    (got, staging), route = _routed(
                        flash_attention,
                        lambda: _staged(lambda: flash_attention(*args, causal=causal)))
                    want = ref.flash_attention_ref(*args, causal=causal)
                    torch.cuda.synchronize()
                    err = _max_err(got, want)
                    worst[dtype] = max(worst[dtype], err)
                    plan = ""
                    if route == "simt":
                        p = plan_attention(qs[0] * qs[1], qs[2], ks[2], qs[3], causal)
                        plan = f" splits={p.splits} staging={staging}"
                    f64 = ""
                    if dtype == torch.float32:
                        exact = _attention_f64(*args, causal)
                        e_kernel = float((got.double() - exact).abs().max())
                        e_plain = float((want.double() - exact).abs().max())
                        f64 = f" err_f64={e_kernel:.3g} plain_err_f64={e_plain:.3g}"
                        if e_kernel > 2 * e_plain:
                            raise SystemExit(f"flash_attention f32 q{qs} k{ks} causal={causal}: "
                                             f"error {e_kernel} against float64 is more than "
                                             f"twice the plain version's {e_plain}")
                    print(f"[kernel] flash_attention q{qs} k{ks} {dtype} causal={causal}"
                          f"{' off-aligned' if off else ''}: route={route}{plan} "
                          f"max_abs_err={err:.6g}{f64}")
                    torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)
                    if (qs, dtype, off) == ((1, 14, 512, 64), torch.bfloat16, False) \
                            and route != "wgmma":
                        raise SystemExit(f"the qwen-width bf16 flash_attention took route "
                                         f"{route}, not wgmma")
    b, h, s, d = 1, 14, 512, 64
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda") for _ in range(3))
    pairs = b * h * s * (s + 1) // 2  # (query, key) pairs the causal mask keeps
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    qb_off = _off_alignment(qb)
    bound16 = _bound_ms(2 * 4 * b * h * s * d, 4 * d * pairs, BF16_FLOPS)
    ms16 = _timed(f"flash_attention ({b},{h},{s},{d}) bf16 causal (route wgmma; "
                  f"simt_ms: the SIMT kernel)", {
                      "ms": lambda: flash_attention(qb, kb, vb, causal=True),
                      "plain_ms": lambda: ref.flash_attention_ref(qb, kb, vb, causal=True),
                      "library_ms": lambda: F.scaled_dot_product_attention(qb, kb, vb,
                                                                           is_causal=True),
                      "simt_ms": lambda: flash_attention(qb_off, kb, vb, causal=True)},
                  *bound16, smi)
    plan = plan_attention(b * h, s, s, d, True)
    bound = _bound_ms(4 * 4 * b * h * s * d, 4 * d * pairs, F32_FLOPS)
    ms = _timed(f"flash_attention ({b},{h},{s},{d}) f32 causal (route simt, "
                f"splits={plan.splits})", {
                    "ms": lambda: flash_attention(q, k, v, causal=True),
                    "plain_ms": lambda: ref.flash_attention_ref(q, k, v, causal=True),
                    "library_ms": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)},
                *bound, smi)
    by_split = " ".join(
        f"{n}:{_device_ms(lambda: flash_attention(q, k, v, causal=True, plan=AttnPlan(64, n))):.5f}"
        for n in (1, 2, 4, 8))
    print(f"[kernel] flash_attention ({b},{h},{s},{d}) f32 causal, device ms by splits: "
          f"{by_split} ({smi})")
    ladder = {}
    for sl, dl, _ in SHAPES["flash_attention"]:
        x, y, z = (torch.randn((1, 1, sl, dl), generator=gen, device="cuda") for _ in range(3))
        p = plan_attention(1, sl, sl, dl, False)
        t_k, t_lib = _abba_ms(lambda: flash_attention(x, y, z, causal=False),
                              lambda: F.scaled_dot_product_attention(x, y, z))
        ladder[f"{sl}x{dl}"] = t_k
        print(f"[kernel] flash_attention (1,1,{sl},{dl}) f32 full, {p.splits} splits: device ms "
              f"kernel_ms={t_k:.5f} library_ms={t_lib:.5f} bound_ms="
              f"{_bound_ms(4 * 4 * sl * dl, 4 * dl * sl * sl, F32_FLOPS)[0]:.5f} ({smi})")
    q1 = torch.randn((1, 1, 128, 64), generator=gen, device="cuda").bfloat16()
    q1_off = _off_alignment(q1)
    _issue_abba("flash_attention (1,1,128,64) bf16 causal (wgmma encodes 3 TMA maps a call)",
                lambda: flash_attention(q1, q1, q1), lambda: flash_attention(q1_off, q1, q1), smi)
    return [_record("flash_attention", "flash_attention.cu",
                    "src/repro/kernels/flash_attention.py:69", worst[torch.float32], ms, bound,
                    dtype="float32", path="simt", splits=plan.splits, ladder_ms=ladder),
            _record("flash_attention_bf16", "flash_attention_wgmma.cu",
                    "src/repro/kernels/flash_attention.py:69", worst[torch.bfloat16], ms16,
                    bound16, dtype="bfloat16", path="wgmma", simt_ms=ms16["simt_ms"])]


def _across_chunks(b: int, v: int, k: int) -> torch.Tensor:
    """(b, v) rows of -1 whose ties and NaNs straddle every chunk boundary
    that ``plan_top_k`` gives at that shape: row r takes pattern r % 4, a
    tie of 6 across each boundary, a NaN on each side, +inf on both sides,
    or zeros of both signs everywhere."""
    from repro_torch.kernels.sampling import plan_top_k

    x = torch.full((b, v), -1.0, device="cuda")
    starts = [start for start, _ in plan_top_k(b, v, k).bounds(v)[1:]]
    for r in range(b):
        for start in starts:
            if r % 4 == 0:
                x[r, start - 3:start + 3] = 5.0
            elif r % 4 == 1:
                x[r, start - 1:start + 1] = float("nan")
            elif r % 4 == 2:
                x[r, start - 2:start + 2] = float("inf")
        if r % 4 == 3:
            x[r] = 0.0
            x[r, ::7] = -0.0
    return x


def check_top_k(smi: str) -> dict:
    """Exact ids and values with k in {1, 8, K_MAX}, in bf16, f32 and fp16:
    at (4, V=151,936) on random rows and rows with ties and NaN; at B = 1
    and 64 (the two ends of plan_top_k's split); on ties and NaNs on both
    sides of each chunk boundary; and on rows one element off 16-byte
    alignment. Each case prints the blocks per row."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sampling import K_MAX, plan_top_k, top_k

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows = [torch.randn((4, QWEN_V), generator=gen, device="cuda"),
            torch.randint(-3, 3, (4, QWEN_V), generator=gen, device="cuda").float(),
            _adversarial(QWEN_V, torch.float32), _adversarial(151, torch.float32),
            torch.randn((1, QWEN_V), generator=gen, device="cuda"),
            torch.randn((64, QWEN_V), generator=gen, device="cuda"),
            _across_chunks(4, QWEN_V, 8), _across_chunks(1, QWEN_V, 8),
            _across_chunks(2, QWEN_V, K_MAX)]
    worst = 0
    for i, x in enumerate(rows):
        for dtype in (torch.bfloat16, torch.float32, torch.float16):
            for k in (1, 8, K_MAX):
                for off in (False, True) if i in (0, 6) else (False,):
                    y = _off_alignment(x.to(dtype)) if off else x.to(dtype)
                    got_v, got_i = top_k(y, k)
                    want_v, want_i = ref.top_k_ref(y, k)
                    torch.cuda.synchronize()
                    err = int((got_i.long() - want_i.long()).abs().max())
                    worst = max(worst, err)
                    print(f"[kernel] top_k rows#{i} {tuple(x.shape)} {dtype} k={k}"
                          f"{' off-aligned' if off else ''}: blocks per row="
                          f"{plan_top_k(*x.shape, k).splits} max_abs_err={err} (ids)")
                    torch.testing.assert_close(got_i, want_i, rtol=0, atol=0)
                    torch.testing.assert_close(got_v, want_v, rtol=0, atol=0, equal_nan=True)
    x = torch.randn((4, QWEN_V), generator=gen, device="cuda").to(torch.bfloat16)
    timed = {}
    for k in (1, 8, K_MAX):
        bound = _bound_ms(x.numel() * x.element_size() + x.shape[0] * k * 8, 0.0, 1.0)
        timed[k] = (_timed(f"top_k B=4 V={QWEN_V} bf16 k={k}, "
                           f"{plan_top_k(4, QWEN_V, k).splits} blocks per row", {
                               "ms": lambda: top_k(x, k), "plain_ms": lambda: ref.top_k_ref(x, k),
                               "library_ms": lambda: torch.topk(x, k)}, *bound, smi), bound)
    sweep = " ".join(f"k={k}:{_device_ms(lambda: top_k(x, k)):.5f}" for k in (2, 4, 16, 32))
    print(f"[kernel] top_k B=4 V={QWEN_V} bf16, device ms by k (k <= 8 register lists, "
          f"k > 8 radix select): {sweep} ({smi})")
    for b in (1, 64):
        y = torch.randn((b, QWEN_V), generator=gen, device="cuda").to(torch.bfloat16)
        for k in (8, K_MAX):
            print(f"[kernel] top_k B={b} V={QWEN_V} bf16 k={k}, {plan_top_k(b, QWEN_V, k).splits} "
                  f"blocks per row, device ms: kernel_ms={_device_ms(lambda: top_k(y, k)):.5f} "
                  f"library_ms={_device_ms(lambda: torch.topk(y, k)):.5f} ({smi})")
    ms, bound = timed[8]
    return _record("top_k", "top_k.cu", "src/repro/kernels/sampling.py:98", worst, ms, bound,
                   k=8, ms_k1=timed[1][0]["ms"], ms_k64=timed[K_MAX][0]["ms"])


def _requests(cfg) -> list[tuple[int, list[int]]]:
    rng = np.random.default_rng(SEED)
    return [(uid, rng.integers(0, cfg.vocab_size, int(rng.integers(16, 97))).tolist())
            for uid in range(N_REQUESTS)]


def _serve(model, params, reqs, sampling: str, max_new: int = MAX_NEW) -> dict:
    from repro_torch.serving import Request, ServingEngine

    decode_launches = []
    engine = ServingEngine(
        model, params, max_slots=4, max_len=512, prefill_chunk=8, sampling=sampling,
        on_launch=lambda d: decode_launches.append(d) if "prefill_tokens" not in d else None)
    for uid, prompt in reqs:
        engine.submit(Request(uid=uid, prompt=list(prompt), max_new_tokens=max_new))
    decode_ms = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while engine.queue or engine.live_slots:
        before = engine.executor.launches
        ts = time.perf_counter()
        engine.step()  # ends in the host's read of this step's ids or logits
        if engine.executor.launches == before + 1:  # a decode step, no admission
            decode_ms.append((time.perf_counter() - ts) * 1e3)
    engine.executor.drain()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = {r.uid: r.generated for r in engine.finished}
    n_tok = sum(len(g) for g in done.values())
    print(f"[serve] sampling={sampling}: {len(done)} requests, {n_tok} tokens in "
          f"{wall:.3f} s = {n_tok / wall:.1f} tokens/s; {len(decode_launches)} decode "
          f"launches, {engine.executor.launches - len(decode_launches)} prefill launches; "
          f"decode-only step median {np.median(decode_ms):.3f} ms over "
          f"{len(decode_ms)} steps; config_traffic={engine.config_traffic()}")
    return {"streams": done, "decode_launches": len(decode_launches)}


def phase_main_path(model, params) -> dict:
    from repro_torch.kernels.sampling import greedy_sample

    reqs = _requests(model.cfg)
    _serve(model, params, reqs[:1], "fused", max_new=4)  # warm-up, not counted
    torch.cuda.reset_peak_memory_stats()
    greedy_sample.launches = 0
    fused = _serve(model, params, reqs, "fused")
    launches = greedy_sample.launches
    print(f"[serve] greedy_sample launches={launches}, fused decode "
          f"launches={fused['decode_launches']}; max_memory_allocated="
          f"{torch.cuda.max_memory_allocated()} B")
    if launches == 0 or launches != fused["decode_launches"]:
        raise SystemExit("the main path did not launch greedy_sample once per decode launch")
    for uid, prompt in reqs:
        if len(fused["streams"][uid]) != MAX_NEW:
            raise SystemExit(f"request {uid} finished with {len(fused['streams'][uid])} "
                             f"tokens, not {MAX_NEW}")
    host = _serve(model, params, reqs, "host")
    if host["streams"] != fused["streams"]:
        raise SystemExit("fused and host sampling gave different token streams")
    print("[serve] fused and host token streams are bit-identical")
    return {"greedy_sample": launches}


def phase_numerics(model, params) -> None:
    b, s = 2, 16
    gen = torch.Generator(device=model.device).manual_seed(SEED + 1)
    tokens = torch.randint(0, model.cfg.vocab_size, (b, s), generator=gen,
                           device=model.device)
    full, _ = model.forward(params, {"tokens": tokens})
    cache = model.init_cache(b, s)
    steps = []
    for i in range(s):
        lg, cache = model.decode_step(params, cache, tokens[:, i:i + 1], i)
        steps.append(lg[:, 0])
    a = full.float().cpu().numpy()
    d = torch.stack(steps, 1).float().cpu().numpy()
    top1 = float((a.argmax(-1) == d.argmax(-1)).mean())
    print(f"[numerics] forward vs decode_step B={b} S={s}: max_abs_diff="
          f"{np.abs(a - d).max():.6f}, top1 agreement={top1:.4f}")
    np.testing.assert_allclose(a, d, rtol=PARITY_RTOL, atol=PARITY_ATOL)
    if top1 < PARITY_TOP1:
        raise SystemExit(f"top-1 agreement {top1} < {PARITY_TOP1}")


def phase_calibrate(smi: str) -> dict:
    """The calibration harness over the full ladder, as a user runs it; each
    sample's wall time beside that shape's device time by CUDA graph, so
    the wall time splits into device work and host issue."""
    from repro_torch.engine.calibrate import SHAPES, kernel_thunk, run_calibration
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul import matmul
    from repro_torch.kernels.sampling import greedy_sample

    counted = {"flash_attention": flash_attention, "matmul": matmul, "sampling": greedy_sample}
    repeats = 3
    for wrapper in counted.values():
        wrapper.launches = 0
    matmul.launches_by_route = dict.fromkeys(matmul.launches_by_route, 0)
    flash_attention.launches_by_route = dict.fromkeys(flash_attention.launches_by_route, 0)
    flash_attention.launches_by_staging = dict.fromkeys(flash_attention.launches_by_staging, 0)
    greedy_sample.launches_by_cluster = dict.fromkeys(greedy_sample.launches_by_cluster, 0)
    t0 = time.perf_counter()
    fits, samples = run_calibration(device="cuda", repeats=repeats)
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in counted.items()}
    print(f"[calibrate] full ladder in {wall:.2f} s; launches={launches}; by route: "
          f"matmul {matmul.launches_by_route}, flash_attention "
          f"{flash_attention.launches_by_route}, by staging "
          f"{flash_attention.launches_by_staging}; greedy_sample by cluster "
          f"{greedy_sample.launches_by_cluster}")
    for kernel, n in launches.items():
        want = (1 + repeats) * len(SHAPES[kernel])
        if n != want:
            raise SystemExit(f"calibration launched {kernel} {n} times, not {want}")
    if matmul.launches_by_route["pipelined"] != launches["matmul"]:
        raise SystemExit("the calibration's f32 matmul did not all take the pipelined route")
    if flash_attention.launches_by_staging["cp_async"] != launches["flash_attention"]:
        raise SystemExit("the calibration's f32 flash_attention did not all stage by cp.async")
    if greedy_sample.launches_by_cluster[1] != launches["sampling"]:
        raise SystemExit("the calibration ladder's rows did not all stay whole")
    for kernel in sorted(samples):
        fit = fits[kernel]
        print(f"[calibrate] {kernel}: overhead_factor={fit.overhead_factor!r} "
              f"seconds_per_cycle={fit.seconds_per_cycle!r} r2={fit.r2!r} "
              f"n={fit.n_samples} ({smi})")
        for sample in samples[kernel]:
            dims = tuple(sample["dims"])
            device_ms = _device_ms(kernel_thunk(kernel, dims, "cuda"))
            wall_ms = sample["seconds"] * 1e3
            print(f"[calibrate]   {kernel} dims={dims}: wall_ms={wall_ms:.5f} "
                  f"device_ms={device_ms:.5f} host_ms={wall_ms - device_ms:.5f} ({smi})")
    return {"matmul": launches["matmul"], "flash_attention": launches["flash_attention"],
            "greedy_sample": launches["sampling"]}


def phase_ops_path(model, params) -> dict:
    """``configured_matmul`` and ``top_k`` through ``kernels.ops``, their
    only entry point: an int8 product with zero points at qwen2-0.5b's MLP
    width, and the top 8 of the served model's last-position logits; and
    the two bf16 routes no other path runs, ``matmul_op`` at the MLP width
    and causal ``attention_op`` at (1, 14, 512, 64), on the wgmma route."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.matmul import configured_matmul, matmul
    from repro_torch.kernels.sampling import top_k

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    tokens = torch.randint(0, model.cfg.vocab_size, (4, 16), generator=gen, device="cuda")
    logits, _ = model.forward(params, {"tokens": tokens})
    last = logits[:, -1].contiguous()
    a = torch.randint(-128, 128, (QWEN_M, QWEN_D), generator=gen, device="cuda").to(torch.int8)
    b = torch.randint(-128, 128, (QWEN_D, QWEN_FF), generator=gen, device="cuda").to(torch.int8)
    zero_points = torch.tensor([-8, 8], dtype=torch.int32)  # on the host: launch parameters
    x = torch.randn((QWEN_M, QWEN_D), generator=gen, device="cuda").bfloat16()
    w = torch.randn((QWEN_D, QWEN_FF), generator=gen, device="cuda").bfloat16()
    q, k, v = (torch.randn((1, 14, 512, 64), generator=gen, device="cuda").bfloat16()
               for _ in range(3))
    torch.cuda.synchronize()
    configured_matmul.launches = top_k.launches = 0
    configured_matmul.launches_by_route = dict.fromkeys(configured_matmul.launches_by_route, 0)
    matmul.launches_by_route = dict.fromkeys(matmul.launches_by_route, 0)
    flash_attention.launches_by_route = dict.fromkeys(flash_attention.launches_by_route, 0)
    vals, ids = ops.top_k_op(last, 8)
    c = ops.configured_matmul_op(a, b, zero_points)
    y = ops.matmul_op(x, w)
    o = ops.attention_op(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = {"configured_matmul": configured_matmul.launches, "top_k": top_k.launches,
                "matmul_bf16": matmul.launches_by_route["wgmma"],
                "flash_attention_bf16": flash_attention.launches_by_route["wgmma"]}
    print(f"[ops] top_k_op on {tuple(last.shape)} {last.dtype} logits, k=8, "
          f"configured_matmul_op ({QWEN_M},{QWEN_D})x({QWEN_D},{QWEN_FF}) int8 zp=(-8, 8), "
          f"matmul_op bf16 at that width and attention_op bf16 (1,14,512,64) causal: "
          f"launches={launches}; by route: configured_matmul "
          f"{configured_matmul.launches_by_route}, matmul {matmul.launches_by_route}, "
          f"flash_attention {flash_attention.launches_by_route}")
    if set(launches.values()) != {1} or sum(matmul.launches_by_route.values()) != 1 \
            or sum(flash_attention.launches_by_route.values()) != 1:
        raise SystemExit("the ops path did not launch each kernel once, bf16 on the wgmma route")
    if configured_matmul.launches_by_route != {"wgmma": 1, "simt": 0}:
        raise SystemExit("the ops path's int8 configured_matmul did not take the wgmma route")
    want_v, want_i = ref.top_k_ref(last, 8)
    torch.testing.assert_close(ids, want_i, rtol=0, atol=0)
    torch.testing.assert_close(vals, want_v, rtol=0, atol=0)
    torch.testing.assert_close(ids[:, 0], ref.greedy_sample_ref(last), rtol=0, atol=0)
    torch.testing.assert_close(c, ref.configured_matmul_ref(a, b, -8, 8), rtol=0, atol=0)
    torch.testing.assert_close(y, ref.matmul_ref(x, w), rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(o, ref.flash_attention_ref(q, k, v, causal=True), rtol=3e-2,
                               atol=3e-2)
    print(f"[ops] top-8 ids of row 0: {ids[0].tolist()}; configured_matmul output "
          f"{tuple(c.shape)} finite={bool(torch.isfinite(c).all())}, exact against its "
          f"plain version; matmul {tuple(y.shape)} and attention {tuple(o.shape)} outputs "
          f"within 2e-2 and 3e-2 of theirs")
    return launches


def main() -> None:
    name, smi = phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    records = [phase_kernel_check(smi)]

    from repro_torch.configs import get
    from repro_torch.dispatch.executor import flatten_with_path
    from repro_torch.models.model import Model

    model = Model(get("qwen2-0.5b"), device="cuda")
    params = model.init(SEED)
    n_params = sum(p.numel() for _, p in flatten_with_path(params))
    print(f"[model] qwen2-0.5b full width, seeded: {n_params} parameters")
    launches = phase_main_path(model, params)
    phase_numerics(model, params)
    records += [*check_matmul(smi), check_configured_matmul(smi), *check_flash_attention(smi),
                check_top_k(smi)]
    calibration = phase_calibrate(smi)
    launches["matmul"] = calibration["matmul"]
    launches["flash_attention"] = calibration["flash_attention"]
    print(f"[calibrate] greedy_sample launches on the calibration path: "
          f"{calibration['greedy_sample']} (the record's count is the serving path's)")
    launches.update(phase_ops_path(model, params))
    for record in records:
        record["launches"] = launches[record["name"]]
    print(f"[done] {time.perf_counter() - t0:.1f} s after the device check")
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
