"""Offline batch decode through the port's graph-captured serving driver,
``repro_torch.launch.serve.serve(mode="fused")``.

Set-up imports the program, loads ``greedy_sample`` (the one hand-written
kernel on this path), draws the weights from the seed on the device
(``bench.weights``) and makes one short ``serve()`` call at the cell's
batch, cache length and fuse, so every shape of the window is warm. The
window then calls ``serve()`` at the traffic file's batch, steps, cache
length and fuse again and again, each call a fresh batch with all its cost
(a new cache, the driver's eager warm-up of ``fuse`` steps, graph capture,
the replays), and stops after the first call that ends past ``seconds``:
the window is whole calls. With ``trace``, one more call after the window,
at the cell's batch, cache length and fuse but only as many steps as the
traced replays need, has its replays ``profile_replays`` profiled
(``bench.trace``); the replays are the window's kernels at the same shapes.

Correctness: every row a call produced, the eager warm-up's ``fuse`` ids
(read where ``kernels.ops.sample_op`` returns them) and the timed loop's,
is one sequence of outputs at positions 0 .. steps-1. The driver starts
every row from token 1 at position 0 and again at position ``fuse``, and
feeds each other position the last output, so the inputs follow from the
outputs. Of the distinct sequences of the window, up to ``check_rows``,
drawn from the seed, go through the family's float32 reference once the
window has closed; the widest gap by which an output's reference logit
lies below the reference's best at its position is held to the cell's
limit.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from types import ModuleType

import numpy as np
import torch

from bench import reference as ref_common
from bench import weights
from bench.harness import BENCH, Refused, program_config

START_TOKEN = 1  # the driver's first input of every row, at 0 and at ``fuse``


@dataclass
class Window:
    """What the per-layer readers read (``bench.metrics``)."""

    runs: list  # the window's ServeRun objects
    config: dict
    counts: ModuleType
    batch: int
    steps: int
    vocab: int
    peak: dict | None  # the card's row of peaks.json; None off a known card
    span: object = None  # bench.trace.Span of the traced call


@dataclass
class Result:
    correct: bool
    attempted: int
    failed: int
    end_to_end: dict
    window: Window
    compared: dict
    memory_peak_bytes: int
    device_kind: str
    notes: list = field(default_factory=list)


class _Warmups:
    """Keeps the ids of each call's eager warm-up: the first ``fuse`` ids
    that ``kernels.ops.sample_op`` returns outside a graph capture, copied
    on the stream that made them."""

    def __init__(self, ops: ModuleType):
        self.ops, self.sample = ops, ops.sample_op
        self.want, self.ids = 0, []
        ops.sample_op = self._sample

    def _sample(self, logits):
        ids = self.sample(logits)
        if self.want and not (ids.is_cuda and torch.cuda.is_current_stream_capturing()):
            self.ids.append(ids.clone())
            self.want -= 1
        return ids

    def expect(self, n: int) -> None:
        self.want, self.ids = n, []

    def take(self) -> torch.Tensor:
        return torch.stack(self.ids).cpu() if self.ids else torch.empty((0, 0), dtype=torch.int32)

    def close(self) -> None:
        self.ops.sample_op = self.sample


def _disagreements(cfg, fields: dict) -> list[str]:
    """Where the program's configuration differs from the benchmark's file
    (``fields``: the family reference's ``program_fields``)."""
    return [f"{k}: program {getattr(cfg, k)!r}, file {v!r}" for k, v in fields.items()
            if getattr(cfg, k) != v]


def _peak(kind: str) -> dict | None:
    import json

    table = json.loads((BENCH / "peaks.json").read_text())
    return next((row for name, row in table.items() if kind.startswith(name)), None)


def inputs_of(outputs: torch.Tensor, fuse: int) -> torch.Tensor:
    """The driver's inputs of rows of outputs (R, steps): each position is
    fed the last output, but positions 0 and ``fuse`` take the start token."""
    inputs = torch.roll(outputs, 1, dims=1)
    inputs[:, 0] = START_TOKEN
    inputs[:, fuse] = START_TOKEN
    return inputs


def judge(cell, params: dict, sequences: torch.Tensor, seed: int, device,
          control: bool = False) -> float:
    """The widest reference-logit gap of up to ``check_rows`` distinct
    sequences of outputs, drawn from ``seed``. With ``control``, the gap of
    the token that the reference computed with fp8 products puts first, at
    the same inputs: the control, which has to fail the limit."""
    distinct = torch.unique(sequences, dim=0)
    rng = np.random.default_rng(seed)
    pick = np.sort(rng.choice(len(distinct), min(cell.traffic["check_rows"], len(distinct)),
                              replace=False))
    chosen = distinct[torch.as_tensor(pick)].to(device).long()
    family = cell.module("reference")
    gap = 0.0
    with torch.no_grad(), ref_common.full_f32():
        for row in chosen[:, None]:  # one sequence at a time, so a long one fits
            inputs = inputs_of(row, cell.traffic["fuse"])
            logits = family.logits(params, cell.config, inputs)
            tokens = row
            if control:
                tokens = family.logits(params, cell.config, inputs, mm=ref_common.fp8_mm).argmax(-1)
            gap = max(gap, ref_common.widest_gap(logits, tokens))
            del logits, tokens
    return gap


def _sequences(calls: list, fuse: int, steps: int, batch: int, vocab: int):
    """(rows of outputs (n, steps), rows that a malformed call left out)."""
    rows, failed = [], 0
    for run, warm in calls:
        if tuple(warm.shape) != (fuse, batch) or tuple(run.ids.shape) != (steps - fuse, batch):
            failed += batch
            continue
        rows.append(torch.cat([warm, run.ids]).T)
    out = torch.cat(rows) if rows else torch.empty((0, steps), dtype=torch.int32)
    bad = int(((out < 0) | (out >= vocab)).any(dim=1).sum())
    return out[((out >= 0) & (out < vocab)).all(dim=1)], failed + bad


class Program:
    """The program as the cell drives it: the model at the cell's
    configuration (``harness.program_config``: the registered one at the
    file's depth, with its ``"program"`` settings; or ``arch``) and one
    ``serve()`` call at the traffic's shape, its warm-up ids kept."""

    def __init__(self, cell, device: str, arch=None):
        from repro_torch.configs import get
        from repro_torch.kernels import ops
        from repro_torch.launch.serve import serve
        from repro_torch.models.model import Model

        fields = cell.module("reference").program_fields
        self.cfg = arch or program_config(get(cell.config["arch"]), cell.config, fields)
        wrong = _disagreements(self.cfg, fields(cell.config))
        if wrong:
            raise Refused(f"the program's {self.cfg.name} is not {cell.config['name']}: "
                          f"{'; '.join(wrong)}")
        tr = cell.traffic
        self.batch, self.steps, self.fuse = tr["batch"], tr["steps"], tr["fuse"]
        self.shape = dict(batch=self.batch, steps=self.steps, cache_len=tr["cache_len"],
                          mode="fused", fuse=self.fuse)
        self.model, self.serve, self.ops = Model(self.cfg, device=device), serve, ops
        self.on_card = torch.device(device).type == "cuda"

    def sync(self) -> None:
        if self.on_card:
            torch.cuda.synchronize()

    def load_kernels(self) -> None:
        """``greedy_sample`` built and loaded, by one call at the cell's batch."""
        logits = torch.zeros((self.batch, self.cfg.vocab_size), dtype=torch.bfloat16,
                             device=self.model.device)
        self.ops.sample_op(logits)
        self.sync()

    def weights(self, cell, seed: int) -> dict:
        params = weights.draw(self.model.abstract_params(), cell.module("reference").init_rule,
                              seed, self.model.device)
        self.sync()
        return params

    def call(self, params: dict, warmups: _Warmups, **shape):
        """One ``serve()`` call: (its ServeRun, its warm-up's ids (fuse, B))."""
        warmups.expect(self.fuse)
        served = self.serve(self.model, params, **{**self.shape, **shape})
        return served, warmups.take()

    def sequences(self, calls: list):
        return _sequences(calls, self.fuse, self.steps, self.batch, self.cfg.vocab_size)


def run(cell, seed: int, seconds: float, trace: bool, device: str, t_start: float,
        arch=None) -> Result:
    """One run of the cell; ``arch`` replaces the program's configuration
    (the tests' reduced ones)."""
    notes = [f"setup import_s {time.perf_counter() - t_start!r}"]
    t = time.perf_counter()
    prog = Program(cell, device, arch)
    prog.load_kernels()
    notes.append(f"setup kernels_s {time.perf_counter() - t!r}")
    t = time.perf_counter()
    params = prog.weights(cell, seed)
    notes.append(f"setup weights_s {time.perf_counter() - t!r}")
    t = time.perf_counter()
    warmups = _Warmups(prog.ops)
    try:
        prog.call(params, warmups, steps=2 * prog.fuse)
        if trace and prog.on_card:
            from bench.trace import warm_profiler

            warm_profiler()
        prog.sync()
        notes.append(f"setup warm_call_s {time.perf_counter() - t!r}")
        setup_s = time.perf_counter() - t_start

        calls = []
        w0 = time.perf_counter()
        while True:
            calls.append(prog.call(params, warmups))
            if time.perf_counter() - w0 >= seconds:
                break
        window_s = time.perf_counter() - w0
        memory_peak = torch.cuda.max_memory_allocated() if prog.on_card else 0

        span = None
        if trace and prog.on_card:
            from bench.trace import ReplaySpan

            first, count = cell.traffic["profile_replays"]
            with ReplaySpan(first, count, prog.fuse) as tracer:
                prog.call(params, warmups, steps=min(prog.steps, prog.fuse * (first + count + 2)))
            span = tracer.read()
    finally:
        warmups.close()

    runs = [served for served, _ in calls]
    tokens = sum(served.ids.numel() for served in runs)
    kind = torch.cuda.get_device_name(0) if prog.on_card else "cpu"
    window = Window(runs, cell.config, cell.module("counts"), prog.batch, prog.steps,
                    prog.cfg.vocab_size, _peak(kind) if prog.on_card else None, span)
    notes.append(f"window calls {len(calls)} window_s {window_s!r} tokens {tokens} "
                 f"timed_loops_s {sum(r.wall_s for r in runs)!r} "
                 f"capture_s {sum(r.capture_s for r in runs)!r}")
    notes.append(f"window each_call capture_s {[r.capture_s for r in runs]!r} "
                 f"timed_loop_s {[r.wall_s for r in runs]!r}")

    sequences, failed = prog.sequences(calls)
    del calls
    if prog.on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    gap = judge(cell, params, sequences, seed, device) if len(sequences) else float("inf")
    prog.sync()
    notes.append(f"check distinct_rows {len(torch.unique(sequences, dim=0))} "
                 f"reference_s {time.perf_counter() - t!r}")
    limit = cell.limits["widest_logit_gap"]["limit"]
    compared = {"widest_logit_gap": {"value": gap, "limit": limit},
                "failed_rows": {"value": failed, "limit": 0}}
    correct = bool(gap <= limit) and failed == 0
    return Result(correct, len(runs) * prog.batch, failed,
                  {"setup_s": setup_s, "decode_tokens_per_s": tokens / window_s},
                  window, compared, memory_peak, kind, notes)
