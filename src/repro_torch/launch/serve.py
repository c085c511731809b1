"""Batched serving: a prefill-free decode loop with the paper's two
optimizations applied at the dispatch layer.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-0.5b \\
        --batch 4 --steps 64 [--mode sequential|concurrent|fused] [--device cuda|cpu]

The counterpart of ``repro/launch/serve.py``, with its flags and its
``[serve]`` line. Modes map to the configuration roofline (§4):

* ``sequential`` — block per token: the host waits for each launch's logits
  before it samples them, the paper's sequential-configuration baseline.
* ``concurrent`` — asynchronous dispatch: the host never waits until the
  end. Only the position crosses the boundary each launch, as the argument
  of a fill on the card (``pos.fill_(i)``), never as a copy: dedup + overlap.
* ``fused`` — k tokens per launch: k decode + sample steps captured once in
  a CUDA graph and replayed (at most two graphs, one of ``fuse`` steps and
  one for the tail). The position lives in a device tensor that the graph
  advances itself, so nothing crosses between launches: configuration
  hoisting, I_OC × k. On the CPU, which has no graphs, the same k steps run
  as a plain loop; on a card a failed capture raises.

The schedule is the reference's, so the ids compare with it: the tokens
start as ones; the untimed warm-up launch runs at position 0 and its ids
are not fed forward; the timed loop starts at ``fuse`` (fused) or 1; a fused
launch takes ``k = min(fuse, steps - pos)`` steps, each fed the last one's
ids, and the next launch starts from its last ids. Every token is the argmax
of the last position's logits by ``kernels.ops.sample_op``, the hand-written
``greedy_sample`` on the card. A run that would write a cache position past
``cache_len`` raises before its first launch; a model whose cache has no
position axis (``--arch rwkv6-7b``, a recurrent state) runs any number of
steps, as the reference's loop does. The encoder-decoder and
vision-language families (``--arch whisper-medium``, ``--arch
phi-3-vision-4.2b``) are refused before any weights are drawn, with the
reference driver's message: their front ends (an encoded window, an image)
are not made by this loop.

Every call records its spans into ``ServeRun.trace`` (an ``obs.trace``
``Tracer``), each tagged ``call=<n>`` (the process's n-th call) and
``parent=<name>``, a launch's also ``launch=<i>``. On the ``host`` lane:

    serve.call     the whole call
    serve.cache    the cache and the loop's buffers (``_Loop``)
    serve.warmup   the untimed eager warm-up
    serve.capture  the CUDA graph captures (fused; nothing to capture on the CPU)
    serve.loop     the timed loop, ending in the card's drain: ``wall_s``
    serve.launch   each launch of it, a graph replay and its ids' copy (fused)
                   or an eager step: ``issue_ms``
    serve.wait     sequential's wait for a launch's logits, inside its launch
    serve.gather   the ids' copy to the host

On a card the ``compute[cuda:<i>]`` lane holds the device side of
``serve.warmup`` and of each ``serve.launch`` (a replay and its ids'
copy): from a CUDA event recorded just before the host span to one just
after it, so an interval starts when the card reaches the launch in its
stream; where the host was behind, that includes the card's wait for the
launch's submission. The events lie outside the launch's span: on a full
launch queue their records wait too, and inside it they added ≈ 1 ms (1.3
%) to the least launch of a 128-row phi4-mini-3.8b call over 1,152
positions on an H100. They are made before the first launch and read after
the timed loop's closing synchronise.

Clock: the host spans are stamped by ``time.perf_counter_ns`` and placed on
``torch.profiler``'s clock (Unix ns, as ``time.time_ns``) by one offset a
call; the device intervals by their distance from an event recorded on the
drained card just before the timed loop. Each host span opens a same-named
profiler range, so a running profiler lists the spans among its host
events. No range is opened inside a launch's decode steps. The stamps are
ns: ``obs.export.chrome_trace(run.trace)`` writes them as Chrome's µs, so
the file opens 1,000 times stretched unless they are divided by 1,000 first.
"""

from __future__ import annotations

import argparse
import itertools
import time
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass, field

import torch

from repro_torch.configs import get
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.sampling import greedy_sample
from repro_torch.models.model import Model
from repro_torch.obs.trace import Span, Tracer

MODES = ("sequential", "concurrent", "fused")

# A host range for the profiler's host events, opened only while a profiler
# runs (it refuses to close a range opened before the profiler started).
# ``torch.profiler.record_function`` would also put each range that launches
# device work on the device's lanes (a "gpu user annotation" spanning the
# launch's kernels), where a reader of device operations would count it as
# one, and it costs ~8 us a range with no profiler running (an H100's host,
# torch 2.11) against ~1 us for this one.
_Range = torch._C._profiler._RecordFunctionFast
_profiling = torch._C._autograd._profiler_enabled
_CALLS = itertools.count(1)  # the process's serve() calls: the id of each call's spans


@dataclass
class Graph:
    """What one captured fused launch did. The graph itself stays inside
    :func:`serve`: it writes to buffers that live only as long as the run."""

    k: int  # decode steps captured
    launches: int  # greedy_sample launches the capture recorded
    replays: int = 0
    attention_launches: int = 0  # decode_attention launches the capture recorded


@dataclass
class ServeRun:
    ids: torch.Tensor  # (produced, B) int32 on the CPU: the timed loop's tokens
    device_ms: float | None  # CUDA events around the timed loop; None on the CPU
    sample_launches: int  # greedy_sample kernel launches in the timed loop
    trace: Tracer  # the call's spans (module docstring)
    graphs: list[Graph] = field(default_factory=list)  # fused on a card
    attention_launches: int = 0  # decode_attention kernel launches in the timed loop

    def host(self, name: str) -> list[Span]:
        """The call's host spans named ``name``, in the order they ended."""
        return [s for s in self.trace.spans if s.lane == "host" and s.name == name]

    @property
    def wall_s(self) -> float:
        """The timed loop by the host's clock, ending in a synchronise."""
        return self.host("serve.loop")[0].cycles / 1e9

    @property
    def issue_ms(self) -> list[float]:
        """Host ms issuing each launch of the timed loop (a decode step, or a
        fused graph replay and its ids' copy), sequential's wait for the
        logits left out."""
        waits = {s.tags["launch"]: s.cycles for s in self.host("serve.wait")}
        return [(s.cycles - waits.get(s.tags["launch"], 0)) / 1e6
                for s in self.host("serve.launch")]

    @property
    def capture_s(self) -> float:
        return sum(s.cycles for s in self.host("serve.capture")) / 1e9

    @property
    def produced(self) -> int:
        return self.ids.shape[0]

    @property
    def tokens_per_s(self) -> float:
        return self.ids.numel() / self.wall_s

    @property
    def ms_per_step(self) -> float:
        return self.wall_s * 1e3 / max(self.produced, 1)

    @property
    def launches(self) -> int:
        return len(self.host("serve.launch"))

    def seconds_by_span(self) -> dict[str, float]:
        """Host seconds of each span directly under ``serve.call``, summed by
        name, and ``self``: the call's time outside them."""
        (call,) = self.host("serve.call")
        out: dict[str, float] = {}
        for s in self.trace.spans:
            if s.lane == "host" and s.tags["parent"] == "serve.call":
                out[s.name] = out.get(s.name, 0.0) + s.cycles / 1e9
        out["self"] = call.cycles / 1e9 - sum(out.values())
        return out


class _Spans:
    """Records one call's host spans into ``trace``: each stamped by the
    monotonic clock and placed on the profiler's by the call's offset."""

    def __init__(self):
        self.trace = Tracer()
        self.call = next(_CALLS)
        self.offset = time.time_ns() - time.perf_counter_ns()

    @contextmanager
    def __call__(self, name: str, parent: str | None, cat: str = "config", **tags):
        with _Range(name) if _profiling() else nullcontext():
            start = time.perf_counter_ns()
            yield
            end = time.perf_counter_ns()
        self.trace.span(name, cat, start + self.offset, end + self.offset, lane="host",
                        call=self.call, parent=parent, **tags)


class _Marks:
    """A call's CUDA timing events, made before its first launch: ``begin``
    and ``end`` around the timed loop, and a pair around each device interval
    (the warm-up's first, then each launch's). Off a card there are none,
    and :meth:`record` does nothing."""

    def __init__(self, intervals: int, on_card: bool):
        def new():
            return torch.cuda.Event(enable_timing=True)

        self.pairs = [(new(), new()) for _ in range(intervals)] if on_card else []
        self.begin, self.end = (new(), new()) if on_card else (None, None)
        self.begin_ns = 0  # when ``begin`` ran, on the profiler's clock

    def record(self, interval: int, edge: int) -> None:
        if self.pairs:
            self.pairs[interval][edge].record()

    def start(self, spans: _Spans) -> None:
        """Records ``begin`` on the drained card, which runs it at once (on
        an H100 a lone event is not held back for a later launch: two events
        2 ms apart on the host lie 2 ms +- 6 us apart on the card)."""
        self.begin.record()
        self.begin_ns = time.perf_counter_ns() + spans.offset

    def place(self, spans: _Spans, device: torch.device) -> None:
        """Adds each recorded interval to the ``compute`` lane, by its events'
        distance from ``begin``; the warm-up's precede it."""
        index = device.index if device.index is not None else torch.cuda.current_device()
        lane = f"compute[cuda:{index}]"
        for i, (e0, e1) in enumerate(self.pairs):
            if i == 0:
                edges = (-e0.elapsed_time(self.begin), -e1.elapsed_time(self.begin))
                name, tags = "serve.warmup", {}
            else:
                edges = (self.begin.elapsed_time(e0), self.begin.elapsed_time(e1))
                name, tags = "serve.launch", {"launch": i - 1}
            start, end = (self.begin_ns + round(ms * 1e6) for ms in edges)
            spans.trace.span(name, "compute", start, end, lane=lane, call=spans.call,
                             parent=name, **tags)


class _Loop:
    """What a fused launch reads and writes, each in place at a fixed
    address, as a graph replay needs: the cache (KV rows, or a recurrent
    state; ``decode_step`` updates every leaf in place), the (B, 1) int32
    tokens, the position (a 0-d int64 device tensor, the type
    ``decode_step`` makes of an int) and the (fuse, B) int32 ids."""

    def __init__(self, model: Model, params: dict, batch: int, cache_len: int, fuse: int):
        self.model, self.params = model, params
        self.cache = model.init_cache(batch, cache_len)
        self.tokens = torch.ones((batch, 1), dtype=torch.int32, device=model.device)
        self.pos = torch.zeros((), dtype=torch.int64, device=model.device)
        self.out = torch.empty((fuse, batch), dtype=torch.int32, device=model.device)

    def steps(self, k: int) -> None:
        """``k`` decode + sample steps from ``pos``, each fed the last ids."""
        for j in range(k):
            logits, _ = self.model.decode_step(self.params, self.cache, self.tokens, self.pos)
            ids = kernel_ops.sample_op(logits[:, -1])
            self.out[j].copy_(ids)
            self.tokens.copy_(ids[:, None])
            self.pos.add_(1)


def _capture(loop: _Loop, k: int) -> tuple[torch.cuda.CUDAGraph, Graph]:
    graph = torch.cuda.CUDAGraph()
    before, attention = greedy_sample.launches, decode_attention.launches
    with torch.cuda.graph(graph):
        loop.steps(k)
    return graph, Graph(k, greedy_sample.launches - before,
                        attention_launches=decode_attention.launches - attention)


def _warm_up_fused(loop: _Loop, k: int, marks: _Marks) -> None:
    """The untimed fused launch at position 0, eagerly: it builds the kernels
    and fills the wrappers' caches, which capture may not do. On a card it
    runs on a side stream, so the capture stream meets no first use."""
    if loop.pos.device.type != "cuda":
        loop.steps(k)
        return
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        marks.record(0, 0)
        loop.steps(k)
        marks.record(0, 1)
    torch.cuda.current_stream().wait_stream(side)


def _block(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def serve(model: Model, params: dict, *, batch: int = 4, steps: int = 64,
          cache_len: int = 256, mode: str = "concurrent", fuse: int = 8) -> ServeRun:
    """Run the reference's decode loop in ``mode`` on ``model.device``; returns
    the timed loop's ids, times and spans. Raises ``ValueError`` before any
    launch where the run would write a cache position past ``cache_len``
    (only a cache with a position axis has one: ``Model.cache_has_positions``)."""
    if mode not in MODES:
        raise ValueError(f"mode is one of {MODES}, not {mode!r}")
    if batch < 1 or fuse < 1:
        raise ValueError(f"batch and fuse are at least 1, not {batch} and {fuse}")
    fused = mode == "fused"
    written = max(steps, fuse if fused else 1)  # the warm-up and the loop write 0 .. written-1
    if model.cache_has_positions and written > cache_len:
        raise ValueError(f"{mode} serving of {steps} steps (fuse {fuse}) writes cache position "
                         f"{written - 1}, past a cache of {cache_len}: raise --cache-len")
    on_card = model.device.type == "cuda"
    start = fuse if fused else 1
    schedule = [min(fuse, steps - pos) for pos in range(start, steps, fuse)] if fused \
        else [1] * max(steps - start, 0)
    spans, marks = _Spans(), _Marks(1 + len(schedule), on_card)
    graphs: dict[int, tuple[torch.cuda.CUDAGraph, Graph]] = {}
    ids = []
    with spans("serve.call", None, cat="launch"):
        with spans("serve.cache", "serve.call"):
            loop = _Loop(model, params, batch, cache_len, fuse if fused else 0)
        with spans("serve.warmup", "serve.call"):
            if fused:
                _warm_up_fused(loop, fuse, marks)
                loop.tokens.fill_(1)  # the warm-up's ids are not fed forward
            else:
                marks.record(0, 0)
                logits, _ = model.decode_step(params, loop.cache, loop.tokens, loop.pos)
                kernel_ops.sample_op(logits[:, -1])  # builds the kernel; the ids are not fed forward
                marks.record(0, 1)
                _block(logits)
        if fused:
            with spans("serve.capture", "serve.call"):
                if on_card:
                    graphs = {k: _capture(loop, k) for k in sorted(set(schedule), reverse=True)}
        loop.pos.fill_(start)  # the host's only write of the position in fused mode

        if on_card:
            torch.cuda.synchronize(model.device)
            marks.start(spans)
        launches0, attention0 = greedy_sample.launches, decode_attention.launches
        with spans("serve.loop", "serve.call", cat="step"):
            if fused:
                for i, k in enumerate(schedule):
                    marks.record(1 + i, 0)
                    with spans("serve.launch", "serve.loop", launch=i):
                        if on_card:
                            graph, record = graphs[k]
                            graph.replay()
                            record.replays += 1
                        else:
                            loop.steps(k)
                        ids.append(loop.out[:k].clone())
                    marks.record(1 + i, 1)
            else:
                tokens = loop.tokens
                for i in range(len(schedule)):
                    marks.record(1 + i, 0)
                    with spans("serve.launch", "serve.loop", launch=i):
                        loop.pos.fill_(start + i)
                        logits, _ = model.decode_step(params, loop.cache, tokens, loop.pos)
                        if mode == "sequential":
                            with spans("serve.wait", "serve.launch", cat="stall", launch=i):
                                _block(logits)  # the host waits for every launch
                        tokens = kernel_ops.sample_op(logits[:, -1])[:, None]
                        ids.append(tokens.T)
                    marks.record(1 + i, 1)
            if on_card:
                marks.end.record()
                marks.end.synchronize()
        stats = [g for _, g in graphs.values()]
        launches = greedy_sample.launches - launches0 + sum(g.launches * g.replays for g in stats)
        attention = (decode_attention.launches - attention0
                     + sum(g.attention_launches * g.replays for g in stats))
        with spans("serve.gather", "serve.call", cat="wire"):
            out = torch.cat(ids).cpu() if ids else torch.empty((0, batch), dtype=torch.int32)
        device_ms = None
        if on_card:
            device_ms = marks.begin.elapsed_time(marks.end)
            marks.place(spans, model.device)
    return ServeRun(out, device_ms, launches, spans.trace, stats, attention)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="qwen2-0.5b")
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--steps", type=int, default=64)
    p.add_argument("--cache-len", type=int, default=256)
    p.add_argument("--mode", default="concurrent", choices=MODES)
    p.add_argument("--fuse", type=int, default=8, help="tokens per launch (fused)")
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("serving on cuda needs a CUDA device; pass --device cpu to run "
                         "on the CPU")

    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family in ("vlm", "encdec"):  # the reference's refusal, before any weights
        raise SystemExit("serve driver targets decoder-only archs; "
                         "use examples/serve_decode.py for stubs")
    model = Model(cfg, device=args.device)
    run = serve(model, model.init(0), batch=args.batch, steps=args.steps,
                cache_len=args.cache_len, mode=args.mode, fuse=args.fuse)
    dt = run.wall_s
    print(f"[serve] arch={cfg.name} mode={args.mode} batch={args.batch} "
          f"steps={run.produced}: {dt*1e3:.1f} ms total, {run.tokens_per_s:.0f} tok/s "
          f"({run.ms_per_step:.2f} ms/step)")
    (call,) = run.host("serve.call")
    parts = " + ".join(f"{name.removeprefix('serve.')} {s * 1e3:.1f}"
                       for name, s in run.seconds_by_span().items())
    print(f"[serve] call {call.tags['call']} by span: {call.cycles / 1e6:.1f} ms = {parts}; "
          f"host issue {sum(run.issue_ms) / max(run.launches, 1):.3f} ms a launch over "
          f"{run.launches} launches")
    if run.device_ms is not None:
        graphs = ", ".join(f"k={g.k}: {g.launches} greedy_sample and {g.attention_launches} "
                           f"decode_attention launches captured, {g.replays} replays"
                           for g in run.graphs)
        busy = sum(s.cycles for s in run.trace.spans if s.cat == "compute") / 1e6
        print(f"[serve] device {run.device_ms / max(run.produced, 1):.3f} ms/step (CUDA events "
              f"around the timed loop); {busy:.1f} ms in the warm-up's and the launches' "
              f"device intervals; greedy_sample launches {run.sample_launches}, "
              f"decode_attention launches {run.attention_launches}; "
              f"{len(run.graphs)} graphs captured in {run.capture_s:.3f} s"
              + (f" ({graphs})" if graphs else ""))


if __name__ == "__main__":
    main()
