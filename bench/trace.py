"""The device trace of a steady span of CUDA graph replays.

:class:`ReplaySpan` profiles, with ``torch.profiler``, replays ``first`` to
``first + count - 1`` of the graphs that the calls inside it replay: the
card is drained (``torch.cuda.synchronize``) before the first and after the
last, so the span holds exactly those replays' device work, timed on the
host's clock from the first drain to the second. :func:`read` turns the
profiler's events into a :class:`Span`: every device operation (kernels,
copies, fills) with its interval, and the host's events, by which an idle
gap is named.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch


@dataclass
class Span:
    window_s: float  # host clock, drain to drain
    steps: int  # decode steps replayed in the span
    ops: list[tuple[str, int, int]] = field(default_factory=list)  # (name, start ns, end ns)
    host: list[tuple[str, int, int]] = field(default_factory=list)

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of their
        intervals."""
        busy, reach = 0, None
        for _, start, end in sorted(self.ops, key=lambda op: op[1]):
            if reach is None or start > reach:
                busy += end - start
                reach = end
            elif end > reach:
                busy += end - reach
                reach = end
        return busy / 1e9

    def gaps(self) -> list[tuple[int, int]]:
        """Intervals between device operations in which none ran."""
        out, reach = [], None
        for _, start, end in sorted(self.ops, key=lambda op: op[1]):
            if reach is not None and start > reach:
                out.append((reach, start))
            reach = end if reach is None else max(reach, end)
        return out

    def by_name(self) -> dict[str, tuple[float, int]]:
        """Device seconds and launches of each operation name."""
        out: dict[str, tuple[float, int]] = {}
        for name, start, end in self.ops:
            seconds, count = out.get(name, (0.0, 0))
            out[name] = (seconds + (end - start) / 1e9, count + 1)
        return out

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps, each named by the host event that had begun last before it."""
        ops = sorted(((name, s) for name, (s, _) in self.by_name().items()),
                     key=lambda item: item[1], reverse=True)[:top]
        host = sorted(self.host, key=lambda ev: ev[1])
        gaps = []
        for start, end in sorted(self.gaps(), key=lambda g: g[1] - g[0], reverse=True)[:top]:
            during = [name for name, h0, h1 in host if h0 <= start < h1]
            gaps.append([during[-1] if during else "host: no traced event", (end - start) / 1e9])
        return {"device_ops": [[_short(name), s] for name, s in ops], "idle_gaps": gaps}


def _short(name: str, most: int = 96) -> str:
    """A kernel's name cut to ``most`` characters: templated names run to
    thousands."""
    return name if len(name) <= most else name[:most - 3] + "..."


class ReplaySpan:
    """Profiles replays ``first`` .. ``first + count - 1`` (counted from 0
    across every graph) of the calls made inside the ``with`` block."""

    def __init__(self, first: int, count: int, steps_a_replay: int):
        self.first, self.count, self.steps_a_replay = first, count, steps_a_replay
        self.seen = 0
        self.window_s = None
        self._t0 = None
        self.prof = None

    def _hook(self, graph) -> None:
        if self.seen == self.first:
            torch.cuda.synchronize()
            self.prof.start()
            self._t0 = time.perf_counter()
        elif self.seen == self.first + self.count:
            self._stop()
        self.seen += 1
        self._replay(graph)

    def _stop(self) -> None:
        if self._t0 is not None and self.window_s is None:
            torch.cuda.synchronize()
            self.window_s = time.perf_counter() - self._t0
            self.prof.stop()

    def __enter__(self) -> "ReplaySpan":
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._replay = torch.cuda.CUDAGraph.replay
        span = self
        torch.cuda.CUDAGraph.replay = lambda graph: span._hook(graph)
        return self

    def __exit__(self, *exc) -> None:
        torch.cuda.CUDAGraph.replay = self._replay
        self._stop()

    def read(self) -> Span | None:
        """The span's device and host events; None if no replay was traced."""
        if self.window_s is None:
            return None
        replays = min(self.count, self.seen - self.first)
        span = Span(self.window_s, replays * self.steps_a_replay)
        cuda = torch.autograd.DeviceType.CUDA
        for ev in self.prof.profiler.kineto_results.events():
            item = (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
            (span.ops if ev.device_type() == cuda else span.host).append(item)
        return span


def warm_profiler() -> None:
    """Start and stop the profiler once, so the first traced span does not
    pay the tracer's own start-up."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
