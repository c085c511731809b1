"""``BENCHMARK.json`` against the benchmark contract's limits, and every file
it names found by name."""

from __future__ import annotations

import importlib
import json
import re

import pytest

from bench import harness
from conftest import families

SPEC = harness.manifest()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its time: 2 + 14 x 24 runs, compiles, spare
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= len(SPEC["paths"]) <= 16
    for path in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path) and ".." not in path
        assert not path.startswith("/") and not path.endswith("_torch")
    assert 1 <= len(SPEC["command"]) <= 32 and all(_line(w) for w in SPEC["command"])
    for word in SPEC["command"]:
        assert not word.startswith("/") and ".." not in word


@pytest.mark.parametrize("kind", sorted(KEYS))
def test_entries_have_their_keys_and_allowed_names(kind):
    entries = SPEC[kind]
    assert entries and len({e["name"] for e in entries}) == len(entries)
    for e in entries:
        extra = {"workloads"} if kind in ("end_to_end", "per_layer") else set()
        assert KEYS[kind] <= set(e) <= KEYS[kind] | extra, e["name"]
        assert NAME.fullmatch(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.fullmatch(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert _line(e[key]), (e["name"], key)


def test_configs_are_used_and_reduced_keys_named():
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16 and all(NAME.fullmatch(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size")) for k in c["reduced"])
        assert c["file"].startswith(tuple(p + "/" for p in SPEC["paths"]))
        assert harness._json(harness.ROOT / c["file"])["reduced"] == c["reduced"]


@pytest.mark.parametrize("config", [c["name"] for c in SPEC["configs"]])
def test_each_configurations_cut_keeps_the_rules(config):
    """The file's ``program`` over the registered configuration: fields of
    it, no width, a published size cut only through ``reduced``."""
    from repro_torch.configs import get

    c = harness._json(harness.ROOT / {e["name"]: e["file"] for e in SPEC["configs"]}[config])
    fields = importlib.import_module(f"bench.reference.{c['family']}").program_fields
    assert harness.cut_refusals(get(c["arch"]), c, fields) == []


@pytest.mark.parametrize("family", families())
def test_each_family_has_its_counts_and_reference(family):
    counts = importlib.import_module(f"bench.counts.{family}")
    reference = importlib.import_module(f"bench.reference.{family}")
    for module, names in ((counts, ("step", "weight_bytes")),
                          (reference, ("program_fields", "init_rule", "logits", "reduced_file"))):
        for name in names:
            assert callable(getattr(module, name, None)), f"{module.__name__}.{name}"


def test_cells_one_chip_each_and_distinct_pairs():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and NAME.fullmatch(w["traffic"])
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(pairs) // 4)


def test_end_to_end_metrics():
    names = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in names and names["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")


def test_per_layer_metrics_move_an_end_to_end_metric_of_their_cells():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for cell in cells:  # every cell reports set-up, one more end-to-end and a per-layer metric
        assert len(harness.metrics_of(SPEC, cell, "end_to_end")) >= 2
        assert harness.metrics_of(SPEC, cell, "per_layer")


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_each_cell_finds_its_files_by_name(cell):
    c = harness.load_cell(cell)
    entry = importlib.import_module(f"bench.entries.{c.traffic['entry']}")
    assert callable(entry.run)
    assert c.module("counts").step and c.module("reference").logits
    assert c.limits["widest_logit_gap"]["limit"] > 0
    for m in harness.metrics_of(SPEC, cell, "per_layer"):
        assert callable(importlib.import_module(f"bench.metrics.{m['name']}").read)


def test_a_missing_cell_is_refused():
    with pytest.raises(harness.Refused):
        harness.load_cell("no-such-cell")
