"""The control (the reference computed with fp8 products, the precision
below the bf16 the configurations serve in) has to read far above the
program: on the CPU at the reduced configurations, and on the card at the
cells' widths against their limits."""

from __future__ import annotations

import pytest

from bench import harness
from bench.readings import readings
from conftest import one_cell_a_family, reduced_cell

CELLS = one_cell_a_family()


@pytest.mark.parametrize("cell", CELLS)
def test_control_reads_far_above_the_program_on_the_cpu(cell):
    c, cfg = reduced_cell(cell)
    got = list(readings(c, [11, 12, 13], 3, "cpu", cfg))
    program = max(r["program"] for r in got)
    control = min(r["control"] for r in got)
    assert control > 0 and control >= 3 * program, got


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in harness.manifest()["workloads"]])
def test_control_fails_the_limit_on_the_card(cuda, cell):
    """At the cell's widths and batch, 64 steps (a few seconds a seed)."""
    c = harness.load_cell(cell)
    limit = c.limits["widest_logit_gap"]["limit"]
    for r in readings(c, [21, 22, 23], 3, "cuda", shape={"steps": 72}):
        assert r["program"] <= limit < r["control"], r
