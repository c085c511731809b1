"""The port's registry and the reference's other dense configurations
(phi4-mini-3.8b, minitron-4b, qwen2.5-32b, paper-lm-100m) against the JAX
package's, on the same parameters.

Each reduced config (2 layers, d_model 64, 4 heads of 16, d_ff 128, vocab
256) runs in both packages on the CPU, its weights drawn by the JAX
``Model.init`` and carried across through ``models.convert``: logits at
``tests/test_decode_parity.py``'s tolerances (bf16 rounds at other places in
the two frameworks), sampled ids equal or at a bf16 tie within them. At
their published vocabularies (152,064, 200,064 and 256,000) ``greedy_sample``
splits a row across a cluster of 16 blocks; the plan and the plain version
are held here, the kernel by the ``gpu`` test on the card.

JAX is imported inside the CPU tests, so the ``gpu`` test also collects on a
machine without it."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCHS, EXTRAS
from repro_torch.configs import get as torch_get
from repro_torch.kernels.sampling import GreedyPlan, plan_greedy_sample
from repro_torch.models import layers as TL

RTOL, ATOL, TOP1 = 0.05, 0.15, 0.9  # tests/test_decode_parity.py
DENSE = ["phi4-mini-3.8b", "minitron-4b", "qwen2.5-32b", "paper-lm-100m"]
REFERENCE_NAMES = ["jamba-1.5-large-398b", "phi3.5-moe-42b-a6.6b", "kimi-k2-1t-a32b",
                   "phi4-mini-3.8b", "qwen2.5-32b", "minitron-4b", "qwen2-0.5b",
                   "phi-3-vision-4.2b", "whisper-medium", "rwkv6-7b", "paper-lm-100m"]
ONCE_UNPORTED = ["jamba-1.5-large-398b", "kimi-k2-1t-a32b"]  # ported since, cut in depth on a card
# the published heads that take a cluster of 16 at B = 4, by vocabulary: the chunk a block takes
HEADS = {152_064: 9_504, 200_064: 12_504, 256_000: 16_000}


# ------------------------------------------------------------ the registry


@pytest.mark.parametrize("name", REFERENCE_NAMES)
def test_registry_entry_equals_the_references(name):
    from repro.configs import get

    assert dataclasses.asdict(torch_get(name)) == dataclasses.asdict(get(name))


def test_registry_holds_the_references_names_but_two():
    """Every name of the reference's registry, in its order: the two it
    once lacked (``ONCE_UNPORTED``) too."""
    from repro import configs

    assert list(ARCHS) == list(configs.ARCHS)
    assert set(ONCE_UNPORTED) <= set(ARCHS)
    assert list(EXTRAS) == list(configs.EXTRAS) == ["paper-lm-100m"]
    assert "paper-lm-100m" not in ARCHS


@pytest.mark.parametrize("name", ONCE_UNPORTED)
def test_an_unported_name_points_at_the_roadmap(name):
    """A name once refused builds now: its reduced config equals the
    reference's and makes a model on the CPU whose cache has the
    reference's leaves, shapes and dtypes; a name neither registry holds
    raises."""
    from repro.configs import get
    from repro.models.model import Model
    from repro_torch.models.model import Model as TorchModel

    cfg = torch_get(name).reduced()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(get(name).reduced())
    want = Model(get(name).reduced()).init_cache(2, 8, concrete=False)
    got = TorchModel(cfg, device="cpu").init_cache(2, 8)
    assert sorted(got) == sorted(want)
    for key, leaf in want.items():
        assert tuple(got[key].shape) == leaf.shape
        assert str(got[key].dtype).removeprefix("torch.") == str(leaf.dtype)
    with pytest.raises(KeyError, match="unknown arch"):
        torch_get(name + "-x")


# ------------------------------------------------------- each configuration


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_sampled_ids_match_jax(arch):
    """``forward`` over (2, 8) tokens at the tolerances with top-1 held, and
    six fused ``decode_and_sample`` steps whose ids equal the JAX model's
    or meet a bf16 tie within the tolerance."""
    import jax
    import jax.numpy as jnp

    from _torch_port import assert_sampled_ids_within_ties, reduced_pair, to_numpy32

    pair = reduced_pair(0, arch)
    cfg, jmodel, jparams, tmodel, tparams = pair
    assert cfg.family == "dense"
    toks = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want, _ = jax.jit(jmodel.forward)(jparams, {"tokens": jnp.asarray(toks)})
    got, aux = tmodel.forward(tparams, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.bfloat16 and float(aux) == 0.0
    a, b = to_numpy32(want), to_numpy32(got)
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= TOP1
    assert_sampled_ids_within_ties(pair, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("arch, features", [
    ("phi4-mini-3.8b", {"tie_embeddings": True}),
    ("minitron-4b", {"mlp_kind": "gelu"}),
    ("qwen2.5-32b", {"qkv_bias": True})])
def test_init_draws_the_reference_tree(arch, features):
    """The tied head, the GELU MLP's two matrices and the QKV biases: the
    reference's tree, shapes and dtypes."""
    import jax

    from repro.configs import get
    from repro.models.model import Model
    from repro_torch.dispatch.executor import flatten_with_path
    from repro_torch.models.model import Model as TorchModel

    cfg = torch_get(arch).reduced()
    assert all(getattr(cfg, k) == v for k, v in features.items())
    want = jax.tree_util.tree_flatten_with_path(Model(get(arch).reduced()).abstract_params())[0]
    got = flatten_with_path(TorchModel(cfg, device="cpu").init(0))
    assert [jax.tree_util.keystr(k) for k, _ in want] == [k for k, _ in got]
    for (_, w), (_, g) in zip(want, got):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).removeprefix("torch.") == str(w.dtype)


def test_the_serve_driver_runs_phi4_mini_and_refuses_a_vlm(capsys, monkeypatch):
    """``python -m repro_torch.launch.serve --arch phi4-mini-3.8b --reduced
    --device cpu`` serves, as ``qwen2-0.5b`` does; phi-3-vision-4.2b is
    refused with the reference driver's message before any weights are
    drawn."""
    from repro_torch.launch import serve

    serve.main(["--arch", "phi4-mini-3.8b", "--reduced", "--device", "cpu", "--mode", "fused",
                "--steps", "6", "--fuse", "2", "--cache-len", "8"])
    assert "[serve] arch=phi4-mini-3.8b mode=fused batch=4 steps=4: " in capsys.readouterr().out
    monkeypatch.setattr(serve.Model, "init", lambda *a, **k: pytest.fail("drew weights"))
    with pytest.raises(SystemExit, match="decoder-only"):
        serve.main(["--arch", "phi-3-vision-4.2b", "--reduced", "--device", "cpu"])


# ------------------------------------------------------------- seeded draws


@pytest.mark.parametrize("shape, scale_axis", [((40, 24), 0), ((64, 128), 0), ((4, 16, 8), 1),
                                               ((7, 5), 0), ((3, 3), 1)])
def test_a_stacked_draw_is_one_f32_draw_made_in_parts(shape, scale_axis):
    """``_dense_init(stack=3)`` fills a bf16 stack a part of at most one layer
    at a time with the numbers of one stacked f32 draw, at N(0, 1/fan_in),
    and leaves the generator where that draw leaves it; where a layer has a
    multiple of 16 elements these are also three one-layer draws."""
    n = 3
    gen = torch.Generator().manual_seed(7)
    got, after = TL._dense_init(gen, shape, scale_axis, stack=n), torch.rand(4, generator=gen)
    scale = 1.0 / math.sqrt(shape[scale_axis])
    gen = torch.Generator().manual_seed(7)
    stacked = (torch.randn((n, *shape), generator=gen) * scale).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and got.shape == (n, *shape)
    assert torch.equal(got, stacked) and torch.equal(after, torch.rand(4, generator=gen))
    gen = torch.Generator().manual_seed(7)
    layers = torch.stack([TL._dense_init(gen, shape, scale_axis) for _ in range(n)])
    assert torch.equal(got, layers) == (math.prod(shape) % 16 == 0)
    if math.prod(shape) >= 1000:
        assert abs(got.float().std().item() / scale - 1.0) < 0.1


def test_a_stacked_draw_holds_no_more_than_a_layer_of_f32(monkeypatch):
    """The parts of a stacked draw: each at most one layer (in whole units
    of 16 on the CPU), the last one taking the CPU's redrawn tail."""
    sizes = []
    randn = torch.randn

    def recording(*shape, **kw):
        out = randn(*shape, **kw)
        sizes.append(out.numel())
        return out

    monkeypatch.setattr(torch, "randn", recording)
    TL._dense_init(torch.Generator().manual_seed(0), (40, 24), stack=5)
    TL._dense_init(torch.Generator().manual_seed(0), (7, 5), stack=3)
    assert sizes == [960] * 5 + [32, 32, 41]


@pytest.mark.gpu
@pytest.mark.parametrize("shape, stack", [((4096, 4096), 3), ((1000, 999), 2), ((4096, 16), 16),
                                          ((7, 5), 3), ((4099, 65537), 2)])
def test_cuda_stacked_draw_is_one_f32_draw_made_in_parts(shape, stack):
    """On the card, where a draw is split across the grid's threads (and,
    past 2**31 bytes of f32, into launches of halves), the parts hold the
    numbers of one stacked f32 draw bit for bit, and the generator ends at
    the offset that draw leaves."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's Philox layout has no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(11)
    got, offset = TL._dense_init(gen, shape, stack=stack), gen.get_offset()
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.randn((stack, *shape), generator=gen, device="cuda")
    assert torch.equal(got, (x * (1.0 / math.sqrt(shape[0]))).to(torch.bfloat16))
    assert offset == gen.get_offset()


# ---------------------------------------------------------- greedy_sample


@pytest.mark.parametrize("v", sorted(HEADS))
def test_greedy_sample_plans_a_cluster_of_16_at_the_head(v):
    """At B = 4, a cluster of 16 blocks, each chunk a multiple of 8
    elements; the last block takes the rest."""
    plan = plan_greedy_sample(4, v)
    assert plan == GreedyPlan(16, HEADS[v])
    assert plan.bounds(v)[-1] == (15 * HEADS[v], v)


@pytest.mark.parametrize("v", sorted(HEADS))
def test_greedy_sample_plain_version_equals_jnp_argmax_at_the_head(v):
    """The plain version, which a CPU tensor takes, equals ``jnp.argmax``
    on rows whose ties, NaNs and infinities straddle every chunk boundary
    of the plan."""
    import jax.numpy as jnp

    from _torch_port import to_torch
    from repro_torch.kernels import ops as kernel_ops

    x = _across_chunks(v)
    want = np.asarray(jnp.argmax(jnp.asarray(x, jnp.bfloat16), axis=-1))
    got = kernel_ops.sample_op(to_torch(jnp.asarray(x, jnp.bfloat16)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [HEADS[v] - 3, HEADS[v] - 1, HEADS[v] - 2, 0]


def _across_chunks(v: int) -> np.ndarray:
    """(4, v) f32: equal maxima, NaNs and infinities straddling each chunk
    boundary of B = 4's plan, and a row of zeros."""
    x = np.full((4, v), -1.0, np.float32)
    for start, _ in plan_greedy_sample(4, v).bounds(v)[1:]:
        x[0, start - 3:start + 3] = 5.0
        x[1, start - 1:start + 1] = np.nan
        x[2, start - 2:start + 2] = np.inf
    x[3] = 0.0
    return x


@pytest.mark.gpu
@pytest.mark.parametrize("v", sorted(HEADS))
def test_cuda_greedy_sample_is_exact_at_the_head(v):
    """The kernel on the card, a cluster of 16, against its plain version:
    exact on random bf16 rows and on the chunk-straddling rows above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: greedy_sample has no CPU mode")
    from repro_torch.kernels import ref
    from repro_torch.kernels.sampling import greedy_sample

    gen = torch.Generator(device="cuda").manual_seed(v)
    for x in (torch.randn((4, v), generator=gen, device="cuda").to(torch.bfloat16),
              torch.from_numpy(_across_chunks(v)).to("cuda", torch.bfloat16)):
        before = greedy_sample.launches_by_cluster[16]
        got = greedy_sample(x)
        torch.cuda.synchronize()
        assert greedy_sample.launches_by_cluster[16] == before + 1
        assert torch.equal(got, ref.greedy_sample_ref(x))
