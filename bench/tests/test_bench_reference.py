"""The plain references against a CPU run of the program's fused driver at
each family's reduced configuration, through the whole run."""

from __future__ import annotations

import time

import pytest
import torch

from bench.entries import serve_fused
from conftest import one_cell_a_family, reduced_cell

CELLS = one_cell_a_family()


def test_inputs_follow_the_drivers_schedule():
    outputs = torch.arange(10, 20)[None]
    assert serve_fused.inputs_of(outputs, 4).tolist() == [[1, 10, 11, 12, 1, 14, 15, 16, 17, 18]]


@pytest.mark.parametrize("seed", [0, 2**31 + 7, 2**40 + 3])
@pytest.mark.parametrize("cell", CELLS)
def test_a_reduced_run_is_correct(cell, seed):
    c, cfg = reduced_cell(cell)
    result = serve_fused.run(c, seed, 0.2, False, "cpu", time.perf_counter(), arch=cfg)
    assert result.correct, result.compared
    assert result.failed == 0 and result.attempted >= c.traffic["batch"]
    assert result.end_to_end["decode_tokens_per_s"] > 0
    # the reference agrees more closely than the cell's limit asks of the card
    assert result.compared["widest_logit_gap"]["value"] <= \
        c.limits["widest_logit_gap"]["limit"] / 2


def test_the_same_seed_gives_the_same_weights_and_ids():
    c, cfg = reduced_cell(CELLS[0])
    prog = serve_fused.Program(c, "cpu", cfg)
    a, b = prog.weights(c, 5), prog.weights(c, 5)
    assert torch.equal(a["layers"]["attn"]["wq"], b["layers"]["attn"]["wq"])
    assert not torch.equal(a["embed"], prog.weights(c, 6)["embed"])
