"""The program's configuration as a cell's file states it: the registered
one, at the file's depth where the file cuts it, with the file's
``"program"`` settings over it, held to the rules of a cut."""

from __future__ import annotations

import dataclasses
import json
import re

import pytest

from bench import harness
from bench.entries import serve_fused
from conftest import copy_manifest, reduced_cell

CELL = "phi4mini-decode-b256-c256"
FILE = "bench/configs/phi4-mini-3.8b.json"
BASE = harness._json(harness.ROOT / FILE)
# phi4-mini cut to 2 of its 32 layers, as a file states such a cut
TWO_LAYERS = {"num_hidden_layers": 2,
              "reduced": BASE["reduced"] + ["num_hidden_layers"],
              "published": {**BASE["published"], "num_hidden_layers": 32}}


def _registered(cell):
    from repro_torch.configs import get

    return get(cell.config["arch"])


def _cut(root, **changes):
    """``CELL`` read from a copy of the manifest under ``root`` whose phi4-mini
    file has ``changes`` over it."""
    copy_manifest(root)
    (root / FILE).write_text(json.dumps({**BASE, **changes}))
    return harness.load_cell(CELL, root)


@pytest.mark.parametrize("cell", ["phi4mini-decode-b128-c1152", "rwkv6-decode-b256-s256",
                                  "phi4mini-decode-b256-c256"])
def test_each_whole_models_cell_runs_the_registered_configuration(cell):
    c = harness.load_cell(cell)
    assert serve_fused.Program(c, "cpu").cfg == _registered(c)


def test_a_cut_reaches_the_program_and_nowhere_else(tmp_path):
    cell = _cut(tmp_path, **TWO_LAYERS)
    prog = serve_fused.Program(cell, "cpu")
    registered = _registered(cell)
    assert prog.cfg == dataclasses.replace(registered, n_layers=2)
    assert registered.n_layers == 32  # the registry keeps the published depth
    assert prog.model.abstract_params()["layers"]["attn"]["wq"].shape[0] == 2
    # the counts read the file's depth; the other configuration runs as registered
    counts = cell.module("counts")
    whole = harness.load_cell(CELL).config
    assert counts.weight_bytes(cell.config) < counts.weight_bytes(whole) / 4
    rwkv = harness.load_cell("rwkv6-decode-b256-s256", tmp_path)
    assert serve_fused.Program(rwkv, "cpu").cfg == _registered(rwkv)


@pytest.mark.parametrize("changes,why", [
    ({"reduced": BASE["reduced"]}, "no key of reduced"),
    ({"published": BASE["published"]}, "no key of reduced"),
    ({"published": {**BASE["published"], "num_hidden_layers": 24}}, "no key of reduced"),
    ({"intermediate_size": 4096, "reduced": TWO_LAYERS["reduced"] + ["intermediate_size"],
      "published": {**TWO_LAYERS["published"], "intermediate_size": 8192}},
     "d_ff 4096 (registered 8192): a cut changes depth alone"),
    ({"vocab_size": 32064, "reduced": TWO_LAYERS["reduced"] + ["vocab_size"],
      "published": {**TWO_LAYERS["published"], "vocab_size": 200064}},
     "vocab_size 32064 (registered 200064): a cut changes depth alone"),
    ({"program": {"n_layers": 2}}, "n_layers is no setting"),
    ({"program": {"cache_quant": "int8"},
      "assumed": {**BASE["assumed"], "cache_quant": "fits the card"}}, "cache_quant is no setting"),
    ({"program": {"capacity_factor": 8.0}}, "no reason under assumed"),
], ids=["unlisted", "unpublished", "misstated", "width", "vocab", "depth_as_setting",
        "precision", "unexplained"])
def test_a_cut_that_breaks_the_rules_is_refused(tmp_path, changes, why):
    cell = _cut(tmp_path, **{**TWO_LAYERS, **changes})
    fields = cell.module("reference").program_fields
    assert any(why in r for r in harness.cut_refusals(_registered(cell), cell.config, fields))
    with pytest.raises(harness.Refused, match=re.escape(why)):
        serve_fused.Program(cell, "cpu")


def test_a_setting_explained_under_assumed_is_run_and_survives_the_reduction(tmp_path):
    assumed = {**BASE["assumed"], "capacity_factor": "no row dropped: E/k"}
    cell = _cut(tmp_path, **{**TWO_LAYERS, "assumed": assumed, "program": {"capacity_factor": 8.0}})
    assert serve_fused.Program(cell, "cpu").cfg.capacity_factor == 8.0
    _, cfg = reduced_cell(CELL, tmp_path)
    assert (cfg.capacity_factor, cfg.n_layers, cfg.d_model) == (8.0, 2, 64)


def test_a_file_that_contradicts_the_program_is_refused_by_the_comparison():
    """Past the cut's rules (the tests' reduced configurations come as
    ``arch``), ``_disagreements`` holds every field to the file's number."""
    cell = harness.load_cell(CELL)
    cut = dataclasses.replace(_registered(cell), n_layers=2)
    with pytest.raises(harness.Refused, match="n_layers: program 2, file 32"):
        serve_fused.Program(cell, "cpu", arch=cut)


# the numbers that the tests' reduction wrote into each family's file before
# it moved into the family's reference (ModelConfig.reduced()'s)
@pytest.mark.parametrize("cell,numbers", [
    ("phi4mini-decode-b256-c256",
     {"hidden_size": 64, "num_hidden_layers": 2, "intermediate_size": 128, "vocab_size": 256,
      "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16}),
    ("rwkv6-decode-b256-s256",
     {"hidden_size": 64, "num_hidden_layers": 2, "intermediate_size": 128, "vocab_size": 256,
      "head_size": 16, "attention_hidden_size": 64}),
])
def test_each_familys_reduced_file_is_the_rewrite_of_before(cell, numbers):
    c, cfg = reduced_cell(cell)
    assert c.config == {**harness.load_cell(cell).config, **numbers}
    assert cfg.remat == "none"
