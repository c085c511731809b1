"""The hybrid family's cases of ``tests/test_torch_parity_checks.py``
(``chip_smoke.py``'s forward-vs-decode check on the CPU at jamba's reduced
config), under the same test names, in a file of their own: they take most
of that file's time, and under ``--dist loadfile`` a file runs on one
worker."""

from __future__ import annotations

import pytest
from test_torch_parity_checks import ALL_CASES, _model, check_case, chip_smoke, f32_forward, fault_gone

CASES = [case for case in ALL_CASES if case[0] == "hybrid"]


@pytest.mark.parametrize("family, fault, rows", CASES)
def test_the_check_passes_a_correct_decode_and_fails_each_fault(family, fault, rows, capsys):
    check_case(family, fault, rows, capsys)


@pytest.mark.parametrize("family", ["hybrid"])
def test_a_fault_is_gone_when_its_context_ends(family):
    """The faults patch the port's functions only inside their context:
    after one, the same model passes again."""
    fault_gone(family)


def test_the_hybrid_check_holds_the_mamba_scan_to_the_step_in_f32(capsys):
    """The hybrid's exact part: its first Mamba layer in f32, the scan
    against the steps, printed with its relative difference under
    ``MAMBA_F32_TOL``."""
    model, params = _model("hybrid")
    chip_smoke._mamba_f32(model, params, "[hybrid]", 2, 8)
    line = next(x for x in capsys.readouterr().out.splitlines() if "mamba_apply" in x)
    assert f"(<= {chip_smoke.MAMBA_F32_TOL})" in line


@pytest.mark.parametrize("family", ["hybrid"])
def test_the_f32_forward_is_the_forward_of_f32_weights(family):
    """``_f32_forward`` (weights cast a layer at a time, a hybrid's a group
    at a time) gives the logits of ``forward`` over the whole tree cast to
    f32 at once, bit for bit."""
    f32_forward(family)


def test_the_stepped_mamba_forward_is_the_steps_of_mamba_step():
    """Under ``chip_smoke._stepped_mamba`` a Mamba layer over a sequence
    gives ``mamba_step``'s outputs over it bit for bit (its formulation,
    its order of sums), and the associative scan's within
    ``test_mamba_chunked.py``'s step-against-scan tolerance."""
    import numpy as np
    import torch

    from repro_torch.models import layers as L

    model, params = _model("hybrid")
    cfg = model.cfg
    lp = {k: v[0, 0] for k, v in params["groups"]["mamba"].items()}
    x = torch.randn((2, 12, cfg.d_model), generator=torch.Generator().manual_seed(4))
    x = x.to(torch.bfloat16)
    d_in = cfg.ssm_expand * cfg.d_model
    state = {"h": torch.zeros((2, d_in, cfg.ssm_state_dim)),
             "conv": torch.zeros((2, cfg.ssm_conv_dim, d_in), dtype=torch.bfloat16)}
    steps = []
    for i in range(x.shape[1]):
        y, state = L.mamba_step(lp, cfg, x[:, i:i + 1], state)
        steps.append(y)
    with chip_smoke._stepped_mamba():
        stepped = L.mamba_apply(lp, cfg, x)
    assert L.mamba_apply.__name__ == "mamba_apply"
    assert torch.equal(stepped, torch.cat(steps, 1))
    np.testing.assert_allclose(stepped.float().numpy(),
                               L.mamba_apply(lp, cfg, x).float().numpy(), rtol=5e-2, atol=5e-2)
