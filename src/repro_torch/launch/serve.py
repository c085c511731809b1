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
"""

from __future__ import annotations

import argparse
import time
from dataclasses import dataclass, field

import torch

from repro_torch.configs import get
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.sampling import greedy_sample
from repro_torch.models.model import Model

MODES = ("sequential", "concurrent", "fused")


@dataclass
class Graph:
    """What one captured fused launch did. The graph itself stays inside
    :func:`serve`: it writes to buffers that live only as long as the run."""

    k: int  # decode steps captured
    launches: int  # greedy_sample launches the capture recorded
    replays: int = 0


@dataclass
class ServeRun:
    ids: torch.Tensor  # (produced, B) int32 on the CPU: the timed loop's tokens
    wall_s: float  # the timed loop by the host's clock, ending in a synchronise
    device_ms: float | None  # CUDA events around the timed loop; None on the CPU
    # host ms issuing each launch of the timed loop (a decode step, or a fused
    # graph replay), sequential's wait for the logits left out
    issue_ms: list[float]
    sample_launches: int  # greedy_sample kernel launches in the timed loop
    graphs: list[Graph] = field(default_factory=list)  # fused on a card
    capture_s: float = 0.0

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
        return len(self.issue_ms)


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
    before = greedy_sample.launches
    with torch.cuda.graph(graph):
        loop.steps(k)
    return graph, Graph(k, greedy_sample.launches - before)


def _warm_up_fused(loop: _Loop, k: int) -> None:
    """The untimed fused launch at position 0, eagerly: it builds the kernels
    and fills the wrappers' caches, which capture may not do. On a card it
    runs on a side stream, so the capture stream meets no first use."""
    if loop.pos.device.type != "cuda":
        loop.steps(k)
        return
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        loop.steps(k)
    torch.cuda.current_stream().wait_stream(side)


def _block(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.current_stream(t.device).synchronize()


def serve(model: Model, params: dict, *, batch: int = 4, steps: int = 64,
          cache_len: int = 256, mode: str = "concurrent", fuse: int = 8) -> ServeRun:
    """Run the reference's decode loop in ``mode`` on ``model.device``; returns
    the timed loop's ids and times. Raises ``ValueError`` before any launch
    where the run would write a cache position past ``cache_len`` (only a
    cache with a position axis has one: ``Model.cache_has_positions``)."""
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
    loop = _Loop(model, params, batch, cache_len, fuse if fused else 0)
    graphs: dict[int, tuple[torch.cuda.CUDAGraph, Graph]] = {}
    capture_s = 0.0
    if fused:
        _warm_up_fused(loop, fuse)
        loop.tokens.fill_(1)  # the warm-up's ids are not fed forward
        start = fuse
        schedule = [min(fuse, steps - pos) for pos in range(start, steps, fuse)]
        if on_card:
            t = time.perf_counter()
            graphs = {k: _capture(loop, k) for k in sorted(set(schedule), reverse=True)}
            capture_s = time.perf_counter() - t
    else:
        logits, _ = model.decode_step(params, loop.cache, loop.tokens, loop.pos)
        kernel_ops.sample_op(logits[:, -1])  # builds the kernel; the ids are not fed forward
        _block(logits)
        start = 1
    loop.pos.fill_(start)  # the host's only write of the position in fused mode

    if on_card:
        torch.cuda.synchronize(model.device)
        begin, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        begin.record()
    launches0 = greedy_sample.launches
    t0 = time.perf_counter()
    ids, issue_ms = [], []
    if fused:
        for k in schedule:
            ti = time.perf_counter()
            if on_card:
                graph, record = graphs[k]
                graph.replay()
                record.replays += 1
            else:
                loop.steps(k)
            ids.append(loop.out[:k].clone())
            issue_ms.append((time.perf_counter() - ti) * 1e3)
    else:
        tokens = loop.tokens
        for i in range(start, steps):
            ti, waited = time.perf_counter(), 0.0
            loop.pos.fill_(i)
            logits, _ = model.decode_step(params, loop.cache, tokens, loop.pos)
            if mode == "sequential":
                tb = time.perf_counter()
                _block(logits)  # the host waits for every launch
                waited = time.perf_counter() - tb
            tokens = kernel_ops.sample_op(logits[:, -1])[:, None]
            ids.append(tokens.T)
            issue_ms.append((time.perf_counter() - ti - waited) * 1e3)
    device_ms = None
    if on_card:
        end.record()
        end.synchronize()
        device_ms = begin.elapsed_time(end)
    wall = time.perf_counter() - t0
    stats = [g for _, g in graphs.values()]
    launches = greedy_sample.launches - launches0 + sum(g.launches * g.replays for g in stats)
    out = torch.cat(ids).cpu() if ids else torch.empty((0, batch), dtype=torch.int32)
    return ServeRun(out, wall, device_ms, issue_ms, launches, stats, capture_s)


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
    if run.device_ms is not None:
        graphs = ", ".join(f"k={g.k}: {g.launches} greedy_sample launches captured, "
                           f"{g.replays} replays" for g in run.graphs)
        print(f"[serve] device {run.device_ms / max(run.produced, 1):.3f} ms/step (CUDA events "
              f"around the timed loop); host issue {sum(run.issue_ms) / run.launches:.3f} ms "
              f"a launch over {run.launches} launches; greedy_sample launches "
              f"{run.sample_launches}; "
              f"{len(run.graphs)} graphs captured in {run.capture_s:.3f} s"
              + (f" ({graphs})" if graphs else ""))


if __name__ == "__main__":
    main()
