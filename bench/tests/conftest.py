"""Shared pieces of the benchmark's own tests (``python -m pytest bench/tests``
from the repository's root; the repository's suite does not collect them).

:func:`reduced_cell` gives a cell of ``BENCHMARK.json`` at its family's
reduced configuration (the program's ``ModelConfig.reduced()``) and a short
traffic mix, so a whole run fits the CPU in seconds."""

from __future__ import annotations

import dataclasses
import os
import shutil
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


def families(root=harness.ROOT) -> list[str]:
    """The families that the manifest's configuration files name."""
    return sorted({harness._json(root / c["file"])["family"]
                   for c in harness.manifest(root)["configs"]})


def copy_manifest(root) -> None:
    """``BENCHMARK.json`` and the configuration files it names, copied under
    ``root`` (a ``pathlib.Path``) for a test that changes them; the cells
    read them there by ``harness.load_cell(name, root)``."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), root)
    for c in harness.manifest()["configs"]:
        (root / c["file"]).parent.mkdir(parents=True, exist_ok=True)
        shutil.copy(os.path.join(ROOT, c["file"]), root / c["file"])


def reduced_cell(name: str, root=harness.ROOT, **traffic):
    """(cell, program config): the cell's program configuration (the file's
    cut over the registered one) reduced, its file rewritten at the reduced
    numbers by the family's ``reduced_file``, its traffic at :data:`SHORT`
    (and ``traffic``)."""
    from repro_torch.configs import get

    cell = harness.load_cell(name, root)
    family = cell.module("reference")
    program = harness.program_config(get(cell.config["arch"]), cell.config, family.program_fields)
    cfg = dataclasses.replace(program.reduced(), remat="none")
    tr = {**cell.traffic, **SHORT, **traffic}
    return dataclasses.replace(cell, config=family.reduced_file(cell.config, cfg), traffic=tr), cfg


@pytest.fixture
def cuda():
    """Skips a test that needs the card, deciding inside the test."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
