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
ALL_CASES = [(family, None, None) for family in ARCHS] + [
    (family, fault, rows) for family, arch in ARCHS.items()
    for fault in chip_smoke.faults_of(get(arch)) for rows in (None, chip_smoke.PARITY_ROWS)]
# the hybrid's cases run from tests/test_torch_parity_checks_hybrid.py, so that
# the two halves of the suite's longest file spread over two workers
FAMILIES = [family for family in ARCHS if family != "hybrid"]
CASES = [case for case in ALL_CASES if case[0] != "hybrid"]


def _model(family: str, seed: int = 0):
    model = Model(dataclasses.replace(get(ARCHS[family]).reduced(), remat="none"), device="cpu")
    return model, model.init(seed)


def test_each_family_has_its_faults():
    assert [f for _, f, rows in ALL_CASES if f and not rows] == ["kv_row", "state", "kv_row",
                                                                  "state", "kv_row"]
    with pytest.raises(ValueError, match="no fault"):
        with chip_smoke.fault("none of these"):
            pass


@pytest.mark.parametrize("family, fault, rows", CASES)
def test_the_check_passes_a_correct_decode_and_fails_each_fault(family, fault, rows, capsys):
    check_case(family, fault, rows, capsys)


def check_case(family, fault, rows, capsys):
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


@pytest.mark.parametrize("family", FAMILIES)
def test_a_fault_is_gone_when_its_context_ends(family):
    """The faults patch the port's functions only inside their context:
    after one, the same model passes again."""
    fault_gone(family)


def fault_gone(family):
    model, params = _model(family, seed=1)
    for fault in chip_smoke.faults_of(model.cfg):
        with chip_smoke.fault(fault), pytest.raises(SystemExit):
            chip_smoke._decode_parity(model, params, f"[{family}]")
    chip_smoke._decode_parity(model, params, f"[{family}]")


@pytest.mark.parametrize("family", FAMILIES)
def test_the_f32_forward_is_the_forward_of_f32_weights(family):
    """``_f32_forward`` (weights cast a layer at a time, a hybrid's a group
    at a time, MoE experts a few at a time) gives the logits of ``forward``
    over the whole tree cast to f32 at once, bit for bit."""
    f32_forward(family)


def f32_forward(family):
    import torch

    def f32(tree):
        return {k: f32(v) if isinstance(v, dict) else v.float() for k, v in tree.items()}

    model, params = _model(family)
    tokens = torch.randint(0, model.cfg.vocab_size, (2, 8),
                           generator=torch.Generator().manual_seed(0))
    want, _ = model.forward(f32(params), {"tokens": tokens})
    assert want.dtype == torch.float32
    assert torch.equal(chip_smoke._f32_forward(model, params, tokens), want)
