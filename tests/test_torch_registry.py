"""The port's registry against the reference's, and kimi-k2-1t-a32b, the
MoE configuration the registry took with the hybrid jamba-1.5-large-398b.

Every name of the reference's ``ARCHS`` and ``EXTRAS`` is the port's, with an
``asdict``-equal config and equal parameter counts (``test_arch_smoke.py``'s
published totals: ≈ 398e9 for jamba, ≈ 1e12 for kimi-k2, ≈ 94e9 and ≈ 32e9
active). kimi-k2 runs the ``moe`` family as it stands (384 experts, top-8,
head_dim 112, a 163,840-token head at full width); its reduced config (2
layers, 4 experts top-2, d_model 64, vocab 256) runs in both packages on the
CPU on the JAX ``Model.init``'s weights: ``forward`` and teacher-forced
decode within ``test_decode_parity``'s tolerances. The serving driver runs
the reduced jamba and kimi-k2 on the CPU, as the reference's serves any
family but ``vlm`` and ``encdec``."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, EXTRAS
from repro_torch.configs import get as torch_get

RTOL, ATOL, TOP1 = 0.05, 0.15, 0.9  # tests/test_decode_parity.py
KIMI = "kimi-k2-1t-a32b"
PUBLISHED = {"jamba-1.5-large-398b": (398e9, 0.05, 94e9), KIMI: (1000e9, 0.08, 32e9)}


def _reference_names() -> list[str]:
    from repro import configs

    return list(configs.ARCHS) + list(configs.EXTRAS)


def test_the_registry_holds_every_reference_name_in_its_order():
    from repro import configs

    assert list(ARCHS) == list(configs.ARCHS)
    assert list(EXTRAS) == list(configs.EXTRAS)
    assert set(ARCHS).isdisjoint(EXTRAS)


@pytest.mark.parametrize("name", ["jamba-1.5-large-398b", "phi3.5-moe-42b-a6.6b", KIMI,
                                  "phi4-mini-3.8b", "qwen2.5-32b", "minitron-4b", "qwen2-0.5b",
                                  "phi-3-vision-4.2b", "whisper-medium", "rwkv6-7b",
                                  "paper-lm-100m"])
def test_each_config_and_its_counts_equal_the_references(name):
    """``asdict``-equal, reduced too, with the reference's ``param_count``
    and ``active_param_count``; jamba and kimi-k2 at their published
    totals within ``test_arch_smoke.py``'s tolerances."""
    from repro.configs import get

    assert name in _reference_names()
    mine, ref = torch_get(name), get(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(ref.reduced())
    assert mine.param_count() == ref.param_count()
    assert mine.active_param_count() == ref.active_param_count()
    if name in PUBLISHED:
        total, tol, active = PUBLISHED[name]
        assert abs(mine.param_count() - total) / total < tol
        assert abs(mine.active_param_count() - active) / active < 0.05


def test_kimi_k2_at_its_published_widths_and_the_one_layer_cut():
    """384 experts top-8 at capacity factor 1.25, head_dim 112, a 163,840
    vocabulary; the one of 61 layers that ``chip_smoke.py`` serves counts
    19,378,616,320 parameters (38.76 GB in bf16) in both packages."""
    from repro.configs import get

    cfg = torch_get(KIMI)
    assert (cfg.family, cfg.n_experts, cfg.experts_per_token, cfg.capacity_factor,
            cfg.head_dim_, cfg.vocab_size, cfg.n_layers) == ("moe", 384, 8, 1.25, 112, 163_840, 61)
    one = dataclasses.replace(cfg, n_layers=1)
    assert one.param_count() == dataclasses.replace(get(KIMI), n_layers=1).param_count() \
        == 19_378_616_320


def test_reduced_kimi_k2_forward_and_decode_match_jax():
    """The reduced kimi-k2 at drop-free capacity (``test_decode_parity``'s):
    ``forward`` over (2, 8) tokens against the reference's within its
    tolerances and top-1, and teacher-forced ``decode_step`` against the
    reference's steps and the port's own forward, the same."""
    import jax
    import jax.numpy as jnp

    from _torch_port import reduced_pair, to_numpy32
    from repro.models.model import Model
    from repro_torch.models.model import Model as TorchModel

    cfg, _, jparams, _, tparams = reduced_pair(0, KIMI)
    cfg = dataclasses.replace(cfg, capacity_factor=float(cfg.n_experts))
    jmodel, tmodel = Model(cfg), TorchModel(cfg, device="cpu")
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want, want_aux = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks)})
    got, aux = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-3)

    def close(a, b):
        a, b = to_numpy32(a), to_numpy32(b)
        np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
        assert (a.argmax(-1) == b.argmax(-1)).mean() >= TOP1

    close(want, got)
    step = jax.jit(jmodel.decode_step)
    jcache, tcache = jmodel.init_cache(2, 8), tmodel.init_cache(2, 8)
    jsteps, tsteps = [], []
    for i in range(8):
        lj, jcache = step(jparams, jcache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        lt, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(toks[:, i:i + 1]), i)
        jsteps.append(lj[:, 0])
        tsteps.append(lt[:, 0])
    close(jnp.stack(jsteps, 1), torch.stack(tsteps, 1))
    close(got, torch.stack(tsteps, 1))


@pytest.mark.parametrize("arch, fuse", [("jamba-1.5-large-398b", 4), (KIMI, 2)])
def test_the_serve_driver_runs_the_reduced_hybrid_and_kimi_k2(capsys, arch, fuse):
    """``python -m repro_torch.launch.serve --arch ARCH --reduced --device
    cpu`` serves both, fused, and its ids come from the vocabulary."""
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--mode", "fused",
                "--steps", "10", "--fuse", str(fuse), "--cache-len", "16"])
    out = capsys.readouterr().out
    assert f"[serve] arch={arch} mode=fused batch=4 steps={10 - fuse}: " in out
