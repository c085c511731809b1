"""A run with its timed path broken underneath has to come out not
correct: once for each fault a one-chip decode cell can have (there is no
exchange between chips to leave out)."""

from __future__ import annotations

import time

import pytest
import torch

from bench import harness
from bench.entries import serve_fused
from bench.faults import TIME_MIX
from bench.readings import readings
from conftest import one_cell_a_family, reduced_cell

CELLS = one_cell_a_family()


def _state_unchanged(monkeypatch):
    """A decode step that leaves its cache or state as it found it."""
    from repro_torch.models import layers
    from repro_torch.models.model import Model

    monkeypatch.setattr(layers, "masked_cache_write", lambda *a, **k: None)
    monkeypatch.setattr(Model, "_masked_cache", staticmethod(lambda *a, **k: None))


def _half_batch(monkeypatch):
    """The second half of the batch left out: its logits never computed."""
    from repro_torch.models.model import Model

    step = Model.decode_step

    def half(self, params, cache, tokens, pos, update_mask=None):
        logits, cache = step(self, params, cache, tokens, pos, update_mask)
        logits[logits.shape[0] // 2:] = 0
        return logits, cache

    monkeypatch.setattr(Model, "decode_step", half)


def _token_altered(monkeypatch):
    """One token of every call altered where it is produced."""
    from repro_torch.kernels import ops

    sample, seen = ops.sample_op, [0]

    def altered(logits):
        ids = sample(logits)
        seen[0] += 1
        if seen[0] % 9 == 5:
            ids = ids.clone()
            ids[0] = (ids[0] + 1) % logits.shape[-1]
        return ids

    monkeypatch.setattr(ops, "sample_op", altered)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered}


def _run(cell: str, seed: int = 2**33 + 1):
    c, cfg = reduced_cell(cell)
    with torch.no_grad():
        return serve_fused.run(c, seed, 0.2, False, "cpu", time.perf_counter(), arch=cfg)


@pytest.mark.parametrize("cell", CELLS)
def test_the_unbroken_run_is_correct(cell):
    assert _run(cell).correct


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_makes_the_run_not_correct(cell, fault, monkeypatch):
    FAULTS[fault](monkeypatch)
    result = _run(cell)
    assert not result.correct, result.compared


RWKV = [c for c in CELLS if harness.load_cell(c).config["family"] == "ssm"]


# At the reduced configuration and 24 steps only the frozen state reads
# above the card's limit (4.1-5.1); the bonus dropped reads 0.26-0.64 and
# the decay squared 0.02-0.04 there. At the cell's widths and 256 steps all
# three read 3.5-7.4: the card's test below.
@pytest.mark.parametrize("fault", ["state_frozen_layer0"])
@pytest.mark.parametrize("cell", RWKV)
def test_a_time_mix_fault_makes_the_run_not_correct(cell, fault):
    c, cfg = reduced_cell(cell)
    with TIME_MIX[fault](cfg.n_layers), torch.no_grad():
        result = serve_fused.run(c, 2**33 + 1, 0.2, False, "cpu", time.perf_counter(), arch=cfg)
    assert not result.correct, result.compared


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(TIME_MIX))
@pytest.mark.parametrize("cell", [w["name"] for w in harness.manifest()["workloads"]
                                  if harness.load_cell(w["name"]).config["family"] == "ssm"])
def test_a_time_mix_fault_fails_the_limit_on_the_card(cuda, cell, fault):
    """At the cell's own batch, steps and widths, three seeds."""
    c = harness.load_cell(cell)
    limit = c.limits["widest_logit_gap"]["limit"]
    for r in readings(c, [31, 32, 33], 0, "cuda", fault=fault):
        assert r["program"] > limit, r
