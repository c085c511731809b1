"""What a run may load and where it may run: no JAX, no JAX package, no
result without a card or without the program."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

from bench import harness
from conftest import ROOT, copy_manifest, families


def imports(root=harness.ROOT) -> list[str]:
    """Every module of the benchmark that a run on the card imports, found
    from the manifest: the entry of each cell's traffic, the counts and
    reference of each family that a configuration names, and the reader of
    each per-layer metric."""
    spec = harness.manifest(root)
    entries = {harness.load_cell(w["name"], root).traffic["entry"] for w in spec["workloads"]}
    return (["bench.harness", "bench.trace", "bench.readings"]
            + [f"bench.entries.{entry}" for entry in sorted(entries)]
            + [f"bench.{kind}.{family}" for family in families(root)
               for kind in ("counts", "reference")]
            + [f"bench.metrics.{m['name']}" for m in spec["per_layer"]])


IMPORTS = imports()


def test_the_imports_follow_the_manifests_families(tmp_path):
    copy_manifest(tmp_path)
    spec = harness.manifest(tmp_path)
    spec["configs"].append({"name": "moe-model", "file": "moe.json"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (tmp_path / "moe.json").write_text(json.dumps({"family": "moe"}))
    found = imports(tmp_path)
    assert set(IMPORTS) < set(found)
    assert set(found) - set(IMPORTS) == {"bench.counts.moe", "bench.reference.moe"}


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_lookalike", sys)
    assert "repro" not in harness.forbidden_modules() or "repro" in sys.modules
    monkeypatch.setitem(sys.modules, "repro.fake", sys)
    assert "repro" in harness.forbidden_modules()


def test_a_run_imports_neither_jax_nor_the_jax_package():
    code = ("import sys; sys.path[:0] = [{root!r}, {src!r}]\n"
            "import importlib\n"
            "for name in {mods!r}: importlib.import_module(name)\n"
            "import repro_torch.launch.serve, repro_torch.models.model, repro_torch.configs\n"
            "from bench import harness\n"
            "print(','.join(harness.forbidden_modules()))\n").format(
        root=ROOT, src=os.path.join(ROOT, "src"), mods=IMPORTS)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=240, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == ""


def _run(cwd, *args):
    return subprocess.run([sys.executable, "bench/run.py", "--workload",
                           "phi4mini-decode-b256-c256", "--seed", "3000000000", "--seconds", "1",
                           *args], capture_output=True, text=True, timeout=240, cwd=cwd,
                          env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})


def test_no_result_without_a_card_or_without_the_program(tmp_path):
    import torch

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "bench"), tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for cwd in (tmp_path, ROOT):
        out = _run(cwd)
        if cwd == ROOT and torch.cuda.is_available():
            continue  # the real run, on a card
        assert out.returncode != 0 and out.stdout.strip() == "", out.stderr[-2000:]
        assert "bench:" in out.stderr
