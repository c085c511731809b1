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
   card, exactly, at the serving path's shapes and on adversarial rows;
   then its time, the plain version's, the PyTorch library call's, and its
   bound.
4. Main path: full-width qwen2-0.5b with seeded weights, served by
   ``ServingEngine(sampling="fused")`` (8 requests), with the kernels' launch
   counts read just after; then the same requests with ``sampling="host"``,
   whose token streams must be bit-identical.
5. Full-width numerics: ``forward`` logits against teacher-forced
   ``decode_step`` logits.
6. Kernel check of matmul, configured_matmul, flash_attention and top_k,
   each against its plain version at its stated tolerance, at the
   calibration ladder's shapes, at qwen2-0.5b's widths and on adversarial
   inputs, then timed as in 3.
7. Calibration path: ``repro_torch.engine.calibrate.run_calibration`` over
   the full shape ladder on the card, each fit and sample printed beside the
   sample's device time, with the matmul, flash_attention and greedy_sample
   launch counts read just after.
8. Ops path: ``kernels.ops.configured_matmul_op`` on int8 operands at
   qwen2-0.5b's MLP width and ``kernels.ops.top_k_op`` on the served
   model's last-position logits, the only entry points of those two
   kernels, with their launch counts read just after.

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
    print(f"[kernel] {label}, device time per call (CUDA graph): "
          f"kernel_ms={ms['ms']:.5f} plain_ms={ms['plain_ms']:.5f} "
          f"library_ms={ms['library_ms']:.5f} bound_ms={bound_ms:.5f} ({bound_by}; {smi})")
    print(f"[kernel] {label}, per call issued from Python: "
          f"kernel_ms={call['ms']:.5f} plain_ms={call['plain_ms']:.5f} "
          f"library_ms={call['library_ms']:.5f} ({smi})")
    return ms


def _bound_ms(nbytes: float, ops: float, ops_per_s: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the bytes over HBM
    bandwidth and the operations over the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _record(name: str, source: str, replaces: str, err: float, ms: dict, bound: tuple) -> dict:
    return {"name": name, "route": "cuda", "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "max_abs_err": err, "ms": ms["ms"],
            "plain_ms": ms["plain_ms"], "bound_ms": bound[0], "bound_by": bound[1],
            "library_ms": ms["library_ms"]}


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


def phase_kernel_check(smi: str) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels.sampling import greedy_sample

    v = 151_936
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = []
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        for b in (1, 4, 8, 64):
            cases.append((f"B={b} V={v} {dtype}", torch.randn(
                (b, v), generator=gen, device="cuda").to(dtype)))
        for vv in (v, v - 1, 1000, 151):  # v - 1 and 151: rows start unaligned
            cases.append((f"adversarial V={vv} {dtype}", _adversarial(vv, dtype)))
    worst = 0
    for label, x in cases:
        got = greedy_sample(x)
        want = ref.greedy_sample_ref(x)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        worst = max(worst, err)
        print(f"[kernel] greedy_sample {label}: max_abs_err={err}")
        if err:
            raise SystemExit(f"greedy_sample disagrees with its plain version on {label}: "
                             f"{got.tolist()[:8]} vs {want.tolist()[:8]}")

    x = torch.randn((4, v), generator=gen, device="cuda").to(torch.bfloat16)
    runs = {"ms": lambda: greedy_sample(x),
            "plain_ms": lambda: ref.greedy_sample_ref(x),
            "library_ms": lambda: torch.argmax(x, dim=-1)}
    bound = _bound_ms(x.numel() * x.element_size() + 4 * 4, 0.0, 1.0)
    ms = _timed(f"greedy_sample B=4 V={v} bf16", runs, *bound, smi)
    return _record("greedy_sample", "greedy_sample.cu", "src/repro/kernels/sampling.py:66",
                   worst, ms, bound)


def _max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    diff = (got.float() - want.float()).abs()
    both_nan = got.float().isnan() & want.float().isnan()
    return float(diff.masked_fill(both_nan, 0.0).max()) if diff.numel() else 0.0


def check_matmul(smi: str) -> dict:
    """f32 at rtol 1e-4 (atol 1e-3: the rounding of <= 896-term f32 sums
    taken in another order), bf16 at test_matmul_matches_oracle's 2e-2, at
    the calibration ladder's shapes and at qwen2-0.5b's MLP width."""
    from repro_torch.engine.calibrate import SHAPES
    from repro_torch.kernels import ref
    from repro_torch.kernels.matmul import matmul

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    worst = 0.0
    for m, k, n in [*SHAPES["matmul"], (QWEN_M, QWEN_D, QWEN_FF), (130, 70, 33)]:
        a = torch.randn((m, k), generator=gen, device="cuda")
        b = torch.randn((k, n), generator=gen, device="cuda")
        for dtype, tol in ((torch.float32, dict(rtol=1e-4, atol=1e-3)),
                           (torch.bfloat16, dict(rtol=2e-2, atol=2e-2))):
            x, y = a.to(dtype), b.to(dtype)
            got, want = matmul(x, y), ref.matmul_ref(x, y)
            torch.cuda.synchronize()
            err = _max_err(got, want)
            worst = max(worst, err)
            print(f"[kernel] matmul ({m},{k})x({k},{n}) {dtype}: max_abs_err={err:.6g}")
            torch.testing.assert_close(got, want, **tol)
    m, k, n = QWEN_M, QWEN_D, QWEN_FF
    a = torch.randn((m, k), generator=gen, device="cuda")
    b = torch.randn((k, n), generator=gen, device="cuda")
    ab, bb = a.bfloat16(), b.bfloat16()
    _timed(f"matmul ({m},{k})x({k},{n}) bf16", {
        "ms": lambda: matmul(ab, bb), "plain_ms": lambda: ref.matmul_ref(ab, bb),
        "library_ms": lambda: torch.matmul(ab, bb)},
        *_bound_ms(2 * (m * k + k * n + m * n), 2 * m * k * n, BF16_FLOPS), smi)
    bound = _bound_ms(4 * (m * k + k * n + m * n), 2 * m * k * n, F32_FLOPS)
    ms = _timed(f"matmul ({m},{k})x({k},{n}) f32", {
        "ms": lambda: matmul(a, b), "plain_ms": lambda: ref.matmul_ref(a, b),
        "library_ms": lambda: torch.matmul(a, b)}, *bound, smi)
    return _record("matmul", "matmul.cu", "src/repro/kernels/matmul.py:46", worst, ms, bound)


def check_configured_matmul(smi: str) -> dict:
    """Integer-valued operands with zero points in [-8, 8]: every sum is an
    integer below 2**24, so the kernel must equal its plain version exactly."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.matmul import configured_matmul

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    worst = 0.0
    for m, k, n in [(128, 128, 128), (QWEN_M, QWEN_D, QWEN_FF), (70, 130, 33)]:
        a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda")
        b = torch.randint(-128, 128, (k, n), generator=gen, device="cuda")
        for dtype in (torch.int8, torch.float32, torch.bfloat16):
            for zp in ((-8, 8), (0, 0), (5, -3)):
                x, y = a.to(dtype), b.to(dtype)
                got, want = configured_matmul(x, y, zp), ref.configured_matmul_ref(x, y, *zp)
                torch.cuda.synchronize()
                err = _max_err(got, want)
                worst = max(worst, err)
                print(f"[kernel] configured_matmul ({m},{k})x({k},{n}) {dtype} zp={zp}: "
                      f"max_abs_err={err}")
                torch.testing.assert_close(got, want, rtol=0, atol=0)
    m, k, n = QWEN_M, QWEN_D, QWEN_FF
    a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda").to(torch.int8)
    b = torch.randint(-128, 128, (k, n), generator=gen, device="cuda").to(torch.int8)
    zp = (-8, 8)
    a_c, b_c = a.float() - zp[0], b.float() - zp[1]  # centred before the timed call
    bound = _bound_ms(m * k + k * n + 4 * m * n, 2 * m * k * n, INT8_OPS)
    ms = _timed(f"configured_matmul ({m},{k})x({k},{n}) int8 zp={zp} "
                f"(library: torch.matmul on f32 operands centred beforehand)", {
                    "ms": lambda: configured_matmul(a, b, zp),
                    "plain_ms": lambda: ref.configured_matmul_ref(a, b, *zp),
                    "library_ms": lambda: torch.matmul(a_c, b_c)}, *bound, smi)
    return _record("configured_matmul", "matmul.cu", "src/repro/kernels/matmul.py:95", worst,
                   ms, bound)


def check_flash_attention(smi: str) -> dict:
    """3e-2 (test_flash_attention_matches_oracle's) at qwen2-0.5b's 14 heads
    of 64, causal and full, f32 and bf16; at the decode shape against 256
    keys; at the calibration ladder's shapes; and at ragged Sq, Sk, D."""
    import torch.nn.functional as F

    from repro_torch.engine.calibrate import SHAPES
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    cases = [((1, 14, 512, 64),) * 2, ((2, 4, 1, 64), (2, 4, 256, 64)),
             ((1, 2, 100, 128), (1, 2, 300, 128)), ((1, 2, 33, 40), (1, 2, 65, 40))]
    cases += [((1, 1, s, d),) * 2 for s, d, _ in SHAPES["flash_attention"]]
    worst = 0.0
    for qs, ks in cases:
        q, k, v = (torch.randn(s, generator=gen, device="cuda") for s in (qs, ks, ks))
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                args = (q.to(dtype), k.to(dtype), v.to(dtype))
                got = flash_attention(*args, causal=causal)
                want = ref.flash_attention_ref(*args, causal=causal)
                torch.cuda.synchronize()
                err = _max_err(got, want)
                worst = max(worst, err)
                print(f"[kernel] flash_attention q{qs} k{ks} {dtype} causal={causal}: "
                      f"max_abs_err={err:.6g}")
                torch.testing.assert_close(got, want, rtol=3e-2, atol=3e-2)
    b, h, s, d = 1, 14, 512, 64
    q, k, v = (torch.randn((b, h, s, d), generator=gen, device="cuda") for _ in range(3))
    pairs = b * h * s * (s + 1) // 2  # (query, key) pairs the causal mask keeps
    qb, kb, vb = q.bfloat16(), k.bfloat16(), v.bfloat16()
    _timed(f"flash_attention ({b},{h},{s},{d}) bf16 causal", {
        "ms": lambda: flash_attention(qb, kb, vb, causal=True),
        "plain_ms": lambda: ref.flash_attention_ref(qb, kb, vb, causal=True),
        "library_ms": lambda: F.scaled_dot_product_attention(qb, kb, vb, is_causal=True)},
        *_bound_ms(2 * 4 * b * h * s * d, 4 * d * pairs, BF16_FLOPS), smi)
    bound = _bound_ms(4 * 4 * b * h * s * d, 4 * d * pairs, F32_FLOPS)
    ms = _timed(f"flash_attention ({b},{h},{s},{d}) f32 causal", {
        "ms": lambda: flash_attention(q, k, v, causal=True),
        "plain_ms": lambda: ref.flash_attention_ref(q, k, v, causal=True),
        "library_ms": lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)},
        *bound, smi)
    return _record("flash_attention", "flash_attention.cu",
                   "src/repro/kernels/flash_attention.py:69", worst, ms, bound)


def check_top_k(smi: str) -> dict:
    """Exact ids and values at (4, V=151,936) with k in {1, 8, K_MAX}, on
    rows with ties and NaN, in bf16, f32 and fp16."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.sampling import K_MAX, top_k

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    rows = [torch.randn((4, QWEN_V), generator=gen, device="cuda"),
            torch.randint(-3, 3, (4, QWEN_V), generator=gen, device="cuda").float(),
            _adversarial(QWEN_V, torch.float32), _adversarial(151, torch.float32)]
    worst = 0
    for i, x in enumerate(rows):
        for dtype in (torch.bfloat16, torch.float32, torch.float16):
            for k in (1, 8, K_MAX):
                got_v, got_i = top_k(x.to(dtype), k)
                want_v, want_i = ref.top_k_ref(x.to(dtype), k)
                torch.cuda.synchronize()
                err = int((got_i.long() - want_i.long()).abs().max())
                worst = max(worst, err)
                print(f"[kernel] top_k rows#{i} {tuple(x.shape)} {dtype} k={k}: "
                      f"max_abs_err={err} (ids)")
                torch.testing.assert_close(got_i, want_i, rtol=0, atol=0)
                torch.testing.assert_close(got_v, want_v, rtol=0, atol=0, equal_nan=True)
    x = torch.randn((4, QWEN_V), generator=gen, device="cuda").to(torch.bfloat16)
    k = 8
    bound = _bound_ms(x.numel() * x.element_size() + x.shape[0] * k * 8, 0.0, 1.0)
    ms = _timed(f"top_k B=4 V={QWEN_V} bf16 k={k}", {
        "ms": lambda: top_k(x, k), "plain_ms": lambda: ref.top_k_ref(x, k),
        "library_ms": lambda: torch.topk(x, k)}, *bound, smi)
    return _record("top_k", "top_k.cu", "src/repro/kernels/sampling.py:98", worst, ms, bound)


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
    t0 = time.perf_counter()
    fits, samples = run_calibration(device="cuda", repeats=repeats)
    wall = time.perf_counter() - t0
    launches = {k: w.launches for k, w in counted.items()}
    print(f"[calibrate] full ladder in {wall:.2f} s; launches={launches}")
    for kernel, n in launches.items():
        want = (1 + repeats) * len(SHAPES[kernel])
        if n != want:
            raise SystemExit(f"calibration launched {kernel} {n} times, not {want}")
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
    width, and the top 8 of the served model's last-position logits."""
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.matmul import configured_matmul
    from repro_torch.kernels.sampling import top_k

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    tokens = torch.randint(0, model.cfg.vocab_size, (4, 16), generator=gen, device="cuda")
    logits, _ = model.forward(params, {"tokens": tokens})
    last = logits[:, -1].contiguous()
    a = torch.randint(-128, 128, (QWEN_M, QWEN_D), generator=gen, device="cuda").to(torch.int8)
    b = torch.randint(-128, 128, (QWEN_D, QWEN_FF), generator=gen, device="cuda").to(torch.int8)
    zero_points = torch.tensor([-8, 8], dtype=torch.int32)  # on the host: launch parameters
    torch.cuda.synchronize()
    configured_matmul.launches = top_k.launches = 0
    vals, ids = ops.top_k_op(last, 8)
    c = ops.configured_matmul_op(a, b, zero_points)
    torch.cuda.synchronize()
    launches = {"configured_matmul": configured_matmul.launches, "top_k": top_k.launches}
    print(f"[ops] top_k_op on {tuple(last.shape)} {last.dtype} logits, k=8, and "
          f"configured_matmul_op ({QWEN_M},{QWEN_D})x({QWEN_D},{QWEN_FF}) int8 zp=(-8, 8): "
          f"launches={launches}")
    if launches != {"configured_matmul": 1, "top_k": 1}:
        raise SystemExit("the ops path did not launch configured_matmul and top_k once each")
    want_v, want_i = ref.top_k_ref(last, 8)
    torch.testing.assert_close(ids, want_i, rtol=0, atol=0)
    torch.testing.assert_close(vals, want_v, rtol=0, atol=0)
    torch.testing.assert_close(ids[:, 0], ref.greedy_sample_ref(last), rtol=0, atol=0)
    torch.testing.assert_close(c, ref.configured_matmul_ref(a, b, -8, 8), rtol=0, atol=0)
    print(f"[ops] top-8 ids of row 0: {ids[0].tolist()}; configured_matmul output "
          f"{tuple(c.shape)} finite={bool(torch.isfinite(c).all())}, exact against its "
          f"plain version")
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
    records += [check_matmul(smi), check_configured_matmul(smi), check_flash_attention(smi),
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
