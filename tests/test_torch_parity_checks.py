"""``chip_smoke.py``'s forward-vs-decode check (``_decode_parity``) on the
CPU, at the reduced configs of the families it guards on the card: it
passes a correct model and fails each decode fault ``parity_sweep.py
--mutate`` plants (``chip_smoke.fault``): a KV cache read one row late, a
recurrent state never written, in every decode step (the exact part
catches it) and in the B-row steps alone (the padded decode right, so the
distance or the routes must). The MoE families run at drop-free capacity,
which the check sets itself."""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import pytest

from repro_torch.configs import get
from repro_torch.models.model import Model

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402

ARCHS = {"moe": "phi3.5-moe-42b-a6.6b", "ssm": "rwkv6-7b", "hybrid": "jamba-1.5-large-398b",
         "kimi-k2": "kimi-k2-1t-a32b"}
CASES = [(family, None, None) for family in ARCHS] + [
    (family, fault, rows) for family, arch in ARCHS.items()
    for fault in chip_smoke.faults_of(get(arch)) for rows in (None, chip_smoke.PARITY_ROWS)]


def _model(family: str, seed: int = 0):
    model = Model(dataclasses.replace(get(ARCHS[family]).reduced(), remat="none"), device="cpu")
    return model, model.init(seed)


def test_each_family_has_its_faults():
    assert [f for _, f, rows in CASES if f and not rows] == ["kv_row", "state", "kv_row",
                                                              "state", "kv_row"]
    with pytest.raises(ValueError, match="no fault"):
        with chip_smoke.fault("none of these"):
            pass


@pytest.mark.parametrize("family, fault, rows", CASES)
def test_the_check_passes_a_correct_decode_and_fails_each_fault(family, fault, rows, capsys):
    model, params = _model(family)
    with chip_smoke.fault(fault, rows):
        if fault is None:
            chip_smoke._decode_parity(model, params, f"[{family}]")
        else:
            with pytest.raises(SystemExit):
                chip_smoke._decode_parity(model, params, f"[{family}]")
    out = capsys.readouterr().out
    assert f"[{family}] forward vs decode_step B={chip_smoke.PARITY_ROWS} S=8" in out \
        or fault is not None


@pytest.mark.parametrize("family", list(ARCHS))
def test_a_fault_is_gone_when_its_context_ends(family):
    """The faults patch the port's functions only inside their context:
    after one, the same model passes again."""
    model, params = _model(family, seed=1)
    for fault in chip_smoke.faults_of(model.cfg):
        with chip_smoke.fault(fault), pytest.raises(SystemExit):
            chip_smoke._decode_parity(model, params, f"[{family}]")
    chip_smoke._decode_parity(model, params, f"[{family}]")


def test_the_hybrid_check_holds_the_mamba_scan_to_the_step_in_f32(capsys):
    """The hybrid's exact part: its first Mamba layer in f32, the scan
    against the steps, printed with its relative difference under
    ``MAMBA_F32_TOL``."""
    model, params = _model("hybrid")
    chip_smoke._mamba_f32(model, params, "[hybrid]", 2, 8)
    line = next(x for x in capsys.readouterr().out.splitlines() if "mamba_apply" in x)
    assert f"(<= {chip_smoke.MAMBA_F32_TOL})" in line


@pytest.mark.parametrize("family", list(ARCHS))
def test_the_f32_forward_is_the_forward_of_f32_weights(family):
    """``_f32_forward`` (weights cast a layer at a time, a hybrid's a group
    at a time, MoE experts a few at a time) gives the logits of ``forward``
    over the whole tree cast to f32 at once, bit for bit."""
    import torch

    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}

    model, params = _model(family)
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    want, _ = model.forward(f32(params), {"tokens": tokens})
    assert want.dtype == torch.float32
    assert torch.equal(chip_smoke._f32_forward(model, params, tokens), want)


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
