#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing its results; any failure exits non-zero:

1. Device: the card's name, the device count, and nvidia-smi's name and
   power limit. No CUDA device is a failure.
2. Build: every kernel under ``src/repro_torch/kernels/csrc/`` with nvcc for
   sm_90a, with the build seconds and the ``-Xptxas -v`` register and
   shared-memory report.
3. Kernel check: each kernel against its plain PyTorch version on the card,
   exactly, at the main path's shapes and on adversarial rows; then its time,
   the plain version's, the PyTorch library call's, and its bound.
4. Main path: full-width qwen2-0.5b with seeded weights, served by
   ``ServingEngine(sampling="fused")`` (8 requests), with the kernels' launch
   counts read just after; then the same requests with ``sampling="host"``,
   whose token streams must be bit-identical.
5. Full-width numerics: ``forward`` logits against teacher-forced
   ``decode_step`` logits.

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


def phase_build() -> None:
    from repro_torch.kernels import _build

    for b in map(_build.build, _build.kernel_names()):
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
    times = {k: [] for k in runs}
    calls = {k: [] for k in runs}
    for order in (list(runs), list(runs)[::-1]):  # in turns, both orders
        for k in order:
            times[k].append(_device_ms(runs[k]))
            calls[k].append(_call_ms(runs[k]))
    ms = {k: float(np.median(t)) for k, t in times.items()}
    call = {k: float(np.median(t)) for k, t in calls.items()}
    bound_ms = (x.numel() * x.element_size() + 4 * 4) / HBM_BYTES_PER_S * 1e3
    print(f"[kernel] greedy_sample B=4 V={v} bf16, device time per call (CUDA graph): "
          f"kernel_ms={ms['ms']:.5f} plain_ms={ms['plain_ms']:.5f} "
          f"library_ms={ms['library_ms']:.5f} bound_ms={bound_ms:.5f} (bytes; {smi})")
    print(f"[kernel] greedy_sample B=4 V={v} bf16, per call issued from Python: "
          f"kernel_ms={call['ms']:.5f} plain_ms={call['plain_ms']:.5f} "
          f"library_ms={call['library_ms']:.5f} ({smi})")
    return {"name": "greedy_sample", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/greedy_sample.cu",
            "replaces": "src/repro/kernels/sampling.py:66",
            "max_abs_err": worst, "ms": ms["ms"], "plain_ms": ms["plain_ms"],
            "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": ms["library_ms"]}


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


def main() -> None:
    name, smi = phase_device()
    t0 = time.perf_counter()
    phase_build()
    record = phase_kernel_check(smi)

    from repro_torch.configs import get
    from repro_torch.dispatch.executor import flatten_with_path
    from repro_torch.models.model import Model

    model = Model(get("qwen2-0.5b"), device="cuda")
    params = model.init(SEED)
    n_params = sum(p.numel() for _, p in flatten_with_path(params))
    print(f"[model] qwen2-0.5b full width, seeded: {n_params} parameters")
    launches = phase_main_path(model, params)
    phase_numerics(model, params)
    record["launches"] = launches[record["name"]]
    print(f"[done] {time.perf_counter() - t0:.1f} s after the device check")
    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))



if __name__ == "__main__":
    main()
