"""The port's calibration harness and its copy of the compute model.

The copy must compute what the JAX package computes: the same shape terms,
the same accelerator models and the same fit on the same samples (the JAX
package's committed interpret-mode samples, read and never written). The
harness must write a file of the port's own, and the committed one must be
a full-ladder run on an NVIDIA card that re-fits exactly from its own
samples."""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import pytest
import torch

from repro_torch.core.accelerators import REGISTRY
from repro_torch.engine import calibrate
from repro_torch.engine.costmodel import (CALIBRATION_PATH, KERNELS, ComputeModel,
                                          fit_overhead, load_fits)

ROOT = Path(__file__).resolve().parents[1]
JAX_CALIBRATION = ROOT / "src" / "repro" / "engine" / "calibration.json"
DIMS = [(1, 1, 1), (128, 128, 128), (130, 70, 33), (4, 0, 151_936), (512, 64, 512)]


def _issues_works(kernels, model, kernel, samples):
    """The fit's two predictors, on the calibration's accel model."""
    spec = kernels[kernel]
    issues = [model.launch_latency + spec.steps(s["dims"], model.tile) for s in samples]
    works = [spec.ops(s["dims"]) / model.p_peak for s in samples]
    return issues, works


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_fit_overhead_equals_jax_on_its_committed_samples(kernel):
    from repro.core.accelerators import REGISTRY as JAX_REGISTRY
    from repro.engine import costmodel as jax_costmodel

    samples = json.loads(JAX_CALIBRATION.read_text())["samples"][kernel]
    seconds = [s["seconds"] for s in samples]
    port = _issues_works(KERNELS, REGISTRY["opengemm"], kernel, samples)
    ref = _issues_works(jax_costmodel.KERNELS, JAX_REGISTRY["opengemm"], kernel, samples)
    assert port == ref
    got, want = fit_overhead(*port, seconds), jax_costmodel.fit_overhead(*ref, seconds)
    assert got.as_dict() == want.as_dict()  # bit for bit
    committed = jax_costmodel.load_fits(str(JAX_CALIBRATION))[kernel]
    for key, value in committed.as_dict().items():  # as test_fit_determinism_... holds it
        assert math.isclose(got.as_dict()[key], value, rel_tol=1e-9), key


@pytest.mark.parametrize("kernel", sorted(KERNELS))
@pytest.mark.parametrize("dims", DIMS)
def test_kernel_terms_equal_jax(kernel, dims):
    from repro.engine import costmodel as jax_costmodel

    assert set(KERNELS) == set(jax_costmodel.KERNELS)
    for tile in [(8, 8, 8), (16, 16, 16), (128, 128, 128)]:
        assert KERNELS[kernel].ops(dims) == jax_costmodel.KERNELS[kernel].ops(dims)
        assert KERNELS[kernel].steps(dims, tile) == jax_costmodel.KERNELS[kernel].steps(dims, tile)


def test_accelerator_models_equal_jax():
    from repro.core.accelerators import REGISTRY as JAX_REGISTRY

    assert set(REGISTRY) == set(JAX_REGISTRY)
    for name, model in REGISTRY.items():
        assert dataclasses.asdict(model) == dataclasses.asdict(JAX_REGISTRY[name])
        assert model.bw_config == JAX_REGISTRY[name].bw_config


@pytest.mark.parametrize("mode", ["flat", "calibrated"])
def test_compute_model_predicts_as_jax(mode):
    """The same fits (the JAX package's, loaded by each side) give the same
    predictions, aliases and fallbacks included."""
    from repro.core.accelerators import REGISTRY as JAX_REGISTRY
    from repro.engine import costmodel as jax_costmodel

    port = ComputeModel(mode, path=str(JAX_CALIBRATION) if mode == "calibrated" else None)
    ref = jax_costmodel.ComputeModel(mode, path=str(JAX_CALIBRATION) if mode == "calibrated"
                                     else None)
    for name in REGISTRY:
        for kernel in [*KERNELS, "decode", "prefill", "attention"]:
            for dims in DIMS:
                assert port.predict(kernel, dims, REGISTRY[name], depth=2) == \
                    ref.predict(kernel, dims, JAX_REGISTRY[name], depth=2)


def test_cpu_smoke_calibration_writes_fits_the_port_loads(tmp_path):
    from repro_torch.kernels import flash_attention, greedy_sample, matmul

    out = tmp_path / "fits.json"
    before = [w.launches for w in (matmul, flash_attention, greedy_sample)]
    calibrate.main(["--device", "cpu", "--smoke", "--repeats", "1", "--out", str(out)])
    fits = load_fits(str(out))
    assert set(fits) == set(KERNELS) and len(fits) == 3
    data = json.loads(out.read_text())
    assert data["backend"].startswith("cpu")
    for kernel, samples in data["samples"].items():
        assert [tuple(s["dims"]) for s in samples] == calibrate.SMOKE_SHAPES[kernel]
        assert all(s["seconds"] > 0 for s in samples)
        assert fits[kernel].n_samples == len(samples)
    # the CPU runs the plain versions: no kernel was launched
    assert [w.launches for w in (matmul, flash_attention, greedy_sample)] == before


def test_default_out_is_the_ports_own_file(monkeypatch):
    written = {}
    monkeypatch.setattr(calibrate, "run_calibration", lambda **kw: ({}, {}))
    monkeypatch.setattr(calibrate, "backend_name", lambda device: "test")
    monkeypatch.setattr(calibrate, "save_fits",
                        lambda fits, path, **kw: written.setdefault("path", path))
    calibrate.main([])
    out = Path(written["path"]).resolve()
    assert out == Path(CALIBRATION_PATH).resolve()
    assert out == ROOT / "src" / "repro_torch" / "engine" / "calibration.json"
    assert (ROOT / "src" / "repro") not in out.parents


def test_calibration_on_cuda_without_a_card_raises():
    """No CPU path when there is no card."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="CUDA device"):
        calibrate.run_calibration(device="cuda", smoke=True, repeats=1, verbose=False)


def test_inputs_are_seeded_as_the_jax_harness_seeds_its_key():
    a = calibrate.kernel_thunk("matmul", (128, 64, 32), "cpu")()
    b = calibrate.kernel_thunk("matmul", (128, 64, 32), "cpu")()
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    gen = torch.Generator().manual_seed(128 * 7 + 64 * 13 + 32 * 29)
    x, y = torch.randn((128, 64), generator=gen), torch.randn((64, 32), generator=gen)
    torch.testing.assert_close(a, x @ y, rtol=0, atol=0)
    with pytest.raises(ValueError, match="unknown kernel"):
        calibrate.kernel_thunk("conv", (1, 1, 1), "cpu")


# ------------------------------------------- the committed fits of the port


def _committed() -> dict:
    return json.loads(Path(CALIBRATION_PATH).read_text())


def test_committed_port_calibration_is_a_full_ladder_on_an_nvidia_card():
    data = _committed()
    assert "NVIDIA" in data["backend"] and " W" in data["backend"], data["backend"]
    assert set(data["fits"]) == set(KERNELS)
    for kernel, samples in data["samples"].items():
        assert [tuple(s["dims"]) for s in samples] == calibrate.SHAPES[kernel]
        assert data["fits"][kernel]["n_samples"] == len(samples)


@pytest.mark.parametrize("kernel", sorted(KERNELS))
def test_committed_port_calibration_refits_exactly_from_its_samples(kernel):
    """The port of test_fit_determinism_from_committed_samples."""
    samples = _committed()["samples"][kernel]
    refit = fit_overhead(*_issues_works(KERNELS, REGISTRY["opengemm"], kernel, samples),
                         [s["seconds"] for s in samples])
    committed = load_fits()[kernel]
    assert math.isclose(refit.overhead_factor, committed.overhead_factor, rel_tol=1e-9)
    assert math.isclose(refit.seconds_per_cycle, committed.seconds_per_cycle, rel_tol=1e-9)
    assert math.isclose(refit.r2, committed.r2, rel_tol=1e-9)
    assert refit.n_samples == committed.n_samples == len(samples)
