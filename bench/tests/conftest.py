"""Shared pieces of the benchmark's own tests (``python -m pytest bench/tests``
from the repository's root; the repository's suite does not collect them).

:func:`reduced_cell` gives a cell of ``BENCHMARK.json`` at its family's
reduced configuration (the program's ``ModelConfig.reduced()``) and a short
traffic mix, so a whole run fits the CPU in seconds."""

from __future__ import annotations

import dataclasses
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
for path in (ROOT, os.path.join(ROOT, "src")):
    if path not in sys.path:
        sys.path.insert(0, path)

from bench import harness  # noqa: E402

SHORT = {"batch": 3, "steps": 24, "cache_len": 24, "fuse": 4, "check_rows": 4}


def one_cell_a_family() -> list[str]:
    """The first cell of ``BENCHMARK.json`` of each configuration family."""
    out: dict[str, str] = {}
    for w in harness.manifest()["workloads"]:
        out.setdefault(harness.load_cell(w["name"]).config["family"], w["name"])
    return list(out.values())


def reduced_cell(name: str, **traffic):
    """(cell, program config): the cell's configuration file rewritten at the
    reduced widths, its traffic at :data:`SHORT` (and ``traffic``)."""
    from repro_torch.configs import get

    cell = harness.load_cell(name)
    cfg = dataclasses.replace(get(cell.config["arch"]).reduced(), remat="none")
    c = dict(cell.config, hidden_size=cfg.d_model, num_hidden_layers=cfg.n_layers,
             intermediate_size=cfg.d_ff, vocab_size=cfg.vocab_size)
    if c["family"] == "dense":
        c.update(num_attention_heads=cfg.n_heads, num_key_value_heads=cfg.n_kv_heads,
                 head_dim=cfg.head_dim_)
    else:
        c.update(head_size=cfg.rwkv_head_dim, attention_hidden_size=cfg.d_model)
    tr = {**cell.traffic, **SHORT, **traffic}
    return dataclasses.replace(cell, config=c, traffic=tr), cfg


@pytest.fixture
def cuda():
    """Skips a test that needs the card, deciding inside the test."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
