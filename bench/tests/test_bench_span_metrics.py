"""The readers of the program's spans (``window_idle_share``, ``warmup_s``,
``kernel_build_s``) on synthetic windows: each gives the value worked out
by hand, and None where there is nothing to read, as at a program that
records no spans."""

from __future__ import annotations

import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from bench import harness
from bench.entries import serve_fused
from bench.metrics import kernel_build_s, warmup_s, window_idle_share
from conftest import one_cell_a_family, reduced_cell
from repro_torch.kernels import _build
from repro_torch.obs.trace import Tracer

MS = 1_000_000  # ns
DEVICE = "compute[cuda:0]"


def _run(call: tuple[int, int], warmup: tuple[int, int] | None = None, device=()):
    """A ServeRun-like object whose trace holds a ``serve.call`` span, a
    ``serve.warmup`` span and device intervals (the warm-up's first)."""
    trace = Tracer()
    trace.span("serve.call", "launch", *call, lane="host", call=1, parent=None)
    if warmup:
        trace.span("serve.warmup", "config", *warmup, lane="host", call=1, parent="serve.call")
    for i, (start, end) in enumerate(device):
        name = "serve.warmup" if i == 0 else "serve.launch"
        trace.span(name, "compute", start, end, lane=DEVICE, call=1, parent=name)
    return SimpleNamespace(trace=trace)


def _window(runs=()):
    return SimpleNamespace(runs=list(runs))


def test_window_idle_share_is_one_less_the_union_of_device_intervals_over_the_calls():
    # calls 0-100 and 120-200 ms: 200 ms of window; the card busy 10-30 and
    # 40-60 in the first, 50-65 (5 ms beyond the first call's) and 150-210
    # (cut at the last call's end: 50 ms) in the second
    runs = [_run((0, 100 * MS), device=[(10 * MS, 30 * MS), (40 * MS, 60 * MS)]),
            _run((120 * MS, 200 * MS), device=[(50 * MS, 65 * MS), (150 * MS, 210 * MS)])]
    busy = 20 + 20 + 5 + 50
    assert window_idle_share.read(_window(runs)) == pytest.approx(100 * (1 - busy / 200))


def test_warmup_s_is_the_mean_from_the_host_span_to_the_device_intervals_end():
    runs = [_run((0, 9_000 * MS), (1 * MS, 3 * MS), [(2 * MS, 2_001 * MS)]),
            _run((0, 9_000 * MS), (0, 5 * MS), [(1 * MS, 4_000 * MS)])]
    assert warmup_s.read(_window(runs)) == pytest.approx((2.0 + 4.0) / 2)


def test_kernel_build_s_sums_this_processs_nvcc_spans(monkeypatch):
    made = [_build.Build("greedy_sample", Path("a.so"), (0, 1_500 * MS), ""),
            _build.Build("top_k", Path("b.so"), (5 * MS, 2_505 * MS), "", (1, 2))]
    monkeypatch.setattr(_build, "builds", lambda: made)
    assert kernel_build_s.read(_window()) == pytest.approx(4.0)


def test_each_reader_reads_nothing_where_nothing_was_recorded(monkeypatch):
    # a program without spans: its runs carry no trace
    bare = SimpleNamespace(ids=None)
    for window in (_window(), _window([bare]), _window([_run((0, MS))])):
        assert window_idle_share.read(window) is None
        assert warmup_s.read(window) is None
    monkeypatch.setattr(_build, "builds", lambda: [])
    assert kernel_build_s.read(_window()) is None
    monkeypatch.delattr(_build, "builds")
    assert kernel_build_s.read(_window()) is None


@pytest.mark.parametrize("cell", one_cell_a_family())
def test_a_cpu_run_leaves_the_card_only_readers_out_of_its_line(cell):
    """On the CPU the calls record host spans only and no span is traced:
    the two readers of the card's intervals find nothing and
    raise nothing; the build reader reads what this process built."""
    c, cfg = reduced_cell(cell)
    with torch.no_grad():
        result = serve_fused.run(c, 2**33 + 7, 0.2, True, "cpu", time.perf_counter(), arch=cfg)
    assert all(run.host("serve.call") for run in result.window.runs)
    line = harness.per_layer(harness.manifest(), cell, result.window)
    assert not {"window_idle_share", "warmup_s"} & set(line), line
    assert ("kernel_build_s" in line) == bool(_build.builds())
