"""The port's placement rules (``repro_torch.distributed``) against the
reference's ``PartitionSpec``\\ s, entry for entry, and its registry and
abstract trees against the reference's.

The reference's specs are computed on a ``jax.sharding.AbstractMesh`` at
the production shapes, (16, 16) and (2, 16, 16), so no 256 JAX devices
are needed (``tests/test_sharding.py``'s ``mesh`` fixture skips without
them); the port's by its pure form, and for a few configurations from a
256- or 512-rank ``fake``-backend ``DeviceMesh`` as DTensor placements.
Every leaf of the params, the optimizer state, the inputs and the caches
at ``decode_32k`` and ``long_500k`` of every registered config, under each
knob, and each leaf's bytes a device against ``NamedSharding.shard_shape``.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import pytest
from jax.sharding import AbstractMesh

from repro import configs as jconfigs
from repro.distributed import sharding as jsharding
from repro.launch.dryrun import optimized_policy
from repro.models.model import Model as JModel
from repro.optim import AdamW as JAdamW
from repro_torch import configs as tconfigs
from repro_torch.distributed import sharding as tsharding
from repro_torch.models.model import Model as TModel
from repro_torch.optim import AdamW as TAdamW

NAMES = list(jconfigs.ARCHS) + list(jconfigs.EXTRAS)
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
KNOBS = {
    "default": {},
    "pure_dp": {"pure_dp": True},
    "tp_attention_0": {"tp_attention": False},
    "fsdp": {"fsdp": True},
    "fsdp_shard_map": {"fsdp": True, "moe_impl": "shard_map"},
    "cache_shard_seq": {"cache_shard_seq": True},
    "optimized_train": "train",
    "optimized_prefill": "prefill",
    "optimized_decode": "decode",
}
BATCH, SEQ = 256, 4096  # train_4k's inputs


def _cfgs(name: str, knob: str, chips: int):
    over = KNOBS[knob]
    jcfg, tcfg = jconfigs.get(name), tconfigs.get(name)
    if isinstance(over, str):
        shape = jconfigs.SHAPES[{"train": "train_4k", "prefill": "prefill_32k",
                                 "decode": "decode_32k"}[over]]
        over = optimized_policy(jcfg, over, shape.global_batch, chips)
    return dataclasses.replace(jcfg, **over), dataclasses.replace(tcfg, **over)


def _jax_leaves(tree) -> list:
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(tuple(p.key for p in path), leaf) for path, leaf in flat]


def _norm(spec) -> tuple:
    """A spec's entries as tuples of axis names (``None`` → ``()``)."""
    return tuple(() if e is None else (e,) if isinstance(e, str) else tuple(e) for e in spec)


@functools.cache
def _trees(name: str):
    """Abstract (params, opt state, inputs, caches) of both packages."""
    jm, tm = JModel(jconfigs.get(name)), TModel(tconfigs.get(name), device="cpu")
    jp, tp = jm.abstract_params(), tm.abstract_params()
    jo, to = jax.eval_shape(JAdamW().init, jp), TAdamW().init(tp)
    ji, ti = jm.input_specs(BATCH, SEQ), tm.input_specs(BATCH, SEQ)
    caches = {}
    for shape in ("decode_32k", "long_500k"):
        s = jconfigs.SHAPES[shape]
        caches[shape] = (jm.init_cache(s.global_batch, s.seq_len, concrete=False),
                         tm.init_cache(s.global_batch, s.seq_len, concrete=False))
    return (jp, tp), (jo, to), (ji, ti), caches


def _compare(jtree, ttree, jspecs, tspecs, tmesh) -> int:
    """Entry-for-entry spec equality and equal bytes a device; returns the
    leaves compared."""
    jl, tl = _jax_leaves(jtree), list(tsharding.named_leaves(ttree))
    js, ts = _jax_leaves(jspecs), dict(tsharding.named_leaves(_as_leaves(tspecs)))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, jleaf), (_, tleaf), (_, jsh) in zip(jl, tl, js):
        tspec = ts[path].spec
        assert _norm(tspec) == _norm(jsh.spec), (path, tspec, jsh.spec)
        want = jsh.shard_shape(jleaf.shape)
        got = tsharding.shard_shape(tmesh, tuple(tleaf.shape), tspec)
        assert tuple(got) == tuple(want), (path, got, want)
        nbytes = math.prod(want) * jnp.dtype(jleaf.dtype).itemsize
        assert math.prod(got) * tleaf.element_size() == nbytes, path
    return len(jl)


class _Spec:
    """A spec as a leaf (specs are tuples, which a tree walk would enter)."""

    def __init__(self, spec):
        self.spec = spec


def _as_leaves(tree):
    if isinstance(tree, dict):
        return {k: _as_leaves(v) for k, v in tree.items()}
    return _Spec(tree)


def _placements_case(name: str, knob: str, mesh_name: str) -> None:
    shape, axes = MESHES[mesh_name]
    jmesh = AbstractMesh(shape, axes)
    tmesh = dict(zip(axes, shape))
    jcfg, tcfg = _cfgs(name, knob, math.prod(shape))
    (jp, tp), (jo, to), (ji, ti), caches = _trees(name)
    n = _compare(jp, tp, jsharding.param_shardings(jmesh, jp, jcfg),
                 tsharding.param_specs(tmesh, tp, tcfg), tmesh)
    n += _compare(jo, to, jsharding.opt_state_shardings(jmesh, jo, jcfg),
                  tsharding.opt_state_specs(tmesh, to, tcfg), tmesh)
    n += _compare(ji, ti, jsharding.input_shardings(jmesh, ji, jcfg),
                  tsharding.input_specs(tmesh, ti, tcfg), tmesh)
    for jc, tc in caches.values():
        n += _compare(jc, tc, jsharding.cache_shardings(jmesh, jcfg, jc),
                      tsharding.cache_specs(tmesh, tcfg, tc), tmesh)
    assert n > 0


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("knob", list(KNOBS))
@pytest.mark.parametrize("name", NAMES)
def test_placements_match_the_reference(name, knob, mesh_name):
    _placements_case(name, knob, mesh_name)


# ------------------------------------------------------- registry and trees


def test_shapes_applicable_and_cells_match_the_reference():
    assert {k: dataclasses.asdict(v) for k, v in tconfigs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert list(tconfigs.SHAPES) == list(jconfigs.SHAPES)
    for inapplicable in (False, True):
        got = [(a.name, s.name, ok, why) for a, s, ok, why in tconfigs.cells(inapplicable)]
        want = [(a.name, s.name, ok, why) for a, s, ok, why in jconfigs.cells(inapplicable)]
        assert got == want
    assert len(tconfigs.cells()) < len(tconfigs.cells(True))


def _same_tree(jtree, ttree) -> None:
    jl, tl = _jax_leaves(jtree), list(tsharding.named_leaves(ttree))
    assert [(p, tuple(leaf.shape), str(leaf.dtype)) for p, leaf in jl] == \
        [(p, tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")) for p, leaf in tl]
    assert all(leaf.device.type == "meta" for _, leaf in tl)


@pytest.mark.parametrize("name", NAMES)
def test_abstract_trees_match_the_reference(name):
    (jp, tp), (jo, to), (ji, ti), caches = _trees(name)
    _same_tree(jp, tp)
    _same_tree(jo, to)
    _same_tree(ji, ti)
    for jc, tc in caches.values():
        _same_tree(jc, tc)
    for quant in ("none", "int8"):  # the int8 cache's k_scale/v_scale companions
        jm = JModel(dataclasses.replace(jconfigs.get(name), cache_quant=quant))
        tm = TModel(dataclasses.replace(tconfigs.get(name), cache_quant=quant), device="cpu")
        _same_tree(jm.init_cache(4, 64, concrete=False), tm.init_cache(4, 64, concrete=False))


def test_abstract_params_draw_nothing():
    """Whole jamba-1.5-large-398b is ~4e11 parameters: its abstract tree comes
    from the shapes alone, on the meta device."""
    tp = TModel(tconfigs.get("jamba-1.5-large-398b"), device="cpu").abstract_params()
    leaves = [leaf for _, leaf in tsharding.named_leaves(tp)]
    assert sum(leaf.numel() for leaf in leaves) > 3.9e11
    assert all(leaf.device.type == "meta" for leaf in leaves)


# ------------------------------------------- the reference's properties, ported


MESH = {"data": 16, "model": 16}


@pytest.mark.parametrize("name", ["qwen2-0.5b", "qwen2.5-32b", "kimi-k2-1t-a32b", "rwkv6-7b"])
def test_spec_shapes_divide(name):
    """Every sharded dim divides the mesh axis (tests/test_sharding.py)."""
    tp = TModel(tconfigs.get(name), device="cpu").abstract_params()
    for path, leaf in tsharding.named_leaves(tp):
        spec = tsharding._spec_for_param(MESH, path, tuple(leaf.shape))
        assert len(spec) == leaf.dim(), (path, spec, leaf.shape)
        for dim, ax in zip(leaf.shape, spec):
            if ax is not None:
                assert dim % 16 == 0, (path, leaf.shape, spec)


def test_zero_shards_optimizer_states():
    params = TModel(tconfigs.get("qwen2-0.5b").reduced(), device="cpu").abstract_params()
    opt = TAdamW().init(params)
    n_params = len(list(tsharding.named_leaves(params)))
    assert len(list(tsharding.named_leaves(opt))) == 3 * n_params + 1  # master, m, v, step
    specs = dict(tsharding.named_leaves(_as_leaves(
        tsharding.opt_state_specs(MESH, TAdamW().init(
            TModel(tconfigs.get("qwen2-0.5b"), device="cpu").abstract_params())))))
    assert specs[("step",)].spec == ()
    assert specs[("m", "layers", "mlp", "wi")].spec == (None, "data", "model")


def test_moe_expert_dim_sharded():
    spec = tsharding._spec_for_param(MESH, ("layers", "moe", "wi"), (61, 384, 7168, 2048))
    assert spec == (None, "model", None, None)


def test_embed_vocab_sharded_when_divisible():
    assert tsharding._spec_for_param(MESH, ("embed",), (65536, 8192)) == ("model", None)
    assert tsharding._spec_for_param(MESH, ("embed",), (151936, 896)) == ("model", None)
    assert tsharding._spec_for_param(MESH, ("embed",), (51865, 1024)) == (None, "model")


def test_norms_replicated():
    assert tsharding._spec_for_param(MESH, ("layers", "attn_norm", "w"), (24, 896)) == \
        (None, None)


def test_pure_dp_replicates_everything():
    cfg = dataclasses.replace(tconfigs.get("qwen2-0.5b"), pure_dp=True)
    spec = tsharding._spec_for_param(MESH, ("layers", "attn", "wq"), (24, 896, 896), cfg)
    assert spec == (None, None, None)
    assert tsharding.batch_axes(MESH, cfg) == ("data", "model")


def test_tp_attention_off_replicates_attention_only():
    cfg = dataclasses.replace(tconfigs.get("qwen2-0.5b"), tp_attention=False)
    assert tsharding._spec_for_param(MESH, ("layers", "attn", "wk"), (24, 896, 128), cfg) == \
        (None, None, None)
    assert tsharding._spec_for_param(MESH, ("layers", "mlp", "wi"), (24, 896, 4864), cfg) == \
        (None, None, "model")


def test_fsdp_adds_data_dim():
    cfg = dataclasses.replace(tconfigs.get("qwen2.5-32b"), fsdp=True)
    spec = tsharding._spec_for_param(MESH, ("layers", "mlp", "wi"), (64, 5120, 27648), cfg)
    assert "data" in spec and "model" in spec


def test_fsdp_skips_experts_under_shard_map():
    cfg = dataclasses.replace(tconfigs.get("kimi-k2-1t-a32b"), fsdp=True, moe_impl="shard_map")
    spec = tsharding._spec_for_param(MESH, ("layers", "moe", "wi"), (61, 384, 7168, 2048), cfg)
    assert spec == (None, "model", None, None)


def test_placements_of_a_spec():
    from torch.distributed.tensor import Replicate, Shard

    mesh = {"pod": 2, "data": 16, "model": 16}
    assert tsharding.placements(mesh, (("pod", "data"), None, "model")) == \
        (Shard(0), Shard(0), Shard(2))
    assert tsharding.placements(mesh, (None, None)) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        tsharding.placements(mesh, (("data", "pod"),))


# ------------------------------------ placements over a fake-backend DeviceMesh


@pytest.fixture(scope="module")
def fake_world():
    """Starts a ``fake`` process group per world size asked for (this process
    as rank 0) and ends it after the module."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    def start(size: int):
        if dist.is_initialized():
            dist.destroy_process_group()
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("name,knob,mesh_name", [
    ("qwen2-0.5b", "default", "pod16x16"),
    ("kimi-k2-1t-a32b", "fsdp_shard_map", "pod16x16"),
    ("jamba-1.5-large-398b", "default", "pod2x16x16"),
    ("rwkv6-7b", "optimized_train", "pod2x16x16"),
])
def test_device_mesh_placements_match_the_specs(fake_world, name, knob, mesh_name):
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import with_shardings

    shape, axes = MESHES[mesh_name]
    fake_world(math.prod(shape))
    mesh = make_production_mesh(multi_pod=len(shape) == 3, device_type="cpu")
    assert mesh.mesh_dim_names == axes and tuple(mesh.shape) == shape
    _, tcfg = _cfgs(name, knob, math.prod(shape))
    (_, tp), (_, to), (_, ti), caches = _trees(name)
    trees = [(tp, tsharding.param_shardings(mesh, tp, tcfg), tsharding.param_specs(mesh, tp, tcfg)),
             (to, tsharding.opt_state_shardings(mesh, to, tcfg),
              tsharding.opt_state_specs(mesh, to, tcfg)),
             (ti, tsharding.input_shardings(mesh, ti, tcfg), tsharding.input_specs(mesh, ti, tcfg))]
    tc = caches["decode_32k"][1]
    trees.append((tc, tsharding.cache_shardings(mesh, tcfg, tc),
                  tsharding.cache_specs(mesh, tcfg, tc)))
    for tree, placements, specs in trees:
        placed = with_shardings(tree, placements, mesh)
        spec_of = dict(tsharding.named_leaves(_as_leaves(specs)))
        for (path, leaf), (_, dt) in zip(tsharding.named_leaves(tree),
                                         tsharding.named_leaves(placed)):
            assert dt.placements == tsharding.placements(mesh, spec_of[path].spec)
            assert tuple(dt.shape) == tuple(leaf.shape) and dt.dtype == leaf.dtype
            assert tuple(dt.to_local().shape) == tsharding.shard_shape(
                mesh, tuple(leaf.shape), spec_of[path].spec)
            assert dt.to_local().device.type == "meta"


def test_a_step_runs_the_batch_axes_on_one_mesh_dim(fake_world):
    """``step_mesh``: at 2×16×16 the batch axes as one ``pod_data`` dim of
    32, pod-major, over the same ranks (``pure_dp``: every axis as one);
    at 16×16 the mesh itself. ``spmd.onto`` carries an input leaf over
    with its local shard, and refuses ZeRO's split over ``data`` alone,
    which has no placement there; ``spmd.move`` brings a tensor of the
    step mesh back to the reference's mesh and placements."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.distributed import spmd
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import with_shardings

    fake_world(256)
    mesh = make_production_mesh(device_type="cpu")
    cfg = tconfigs.get("qwen2-0.5b")
    assert tsharding.step_mesh(mesh, cfg) is mesh
    fake_world(512)
    mesh = make_production_mesh(multi_pod=True, device_type="cpu")
    step = tsharding.step_mesh(mesh, cfg)
    assert step.mesh_dim_names == ("pod_data", "model") and tuple(step.shape) == (32, 16)
    assert step.mesh.flatten().tolist() == mesh.mesh.flatten().tolist()
    assert tsharding.step_mesh(mesh, cfg) is step and tsharding.step_mesh(step, cfg) is step
    pure = tsharding.step_mesh(mesh, dataclasses.replace(cfg, pure_dp=True))
    assert pure.mesh_dim_names == ("pod_data_model",) and tuple(pure.shape) == (512,)

    (_, tp), (_, to), (_, ti), _ = _trees("qwen2-0.5b")
    inputs = with_shardings(ti, tsharding.input_shardings(mesh, ti, cfg), mesh)
    tokens = inputs["tokens"]
    assert tokens.placements == (Shard(0), Shard(0), Replicate())
    moved = spmd.onto(tokens, step)
    assert moved.placements == (Shard(0), Replicate()) and moved.shape == tokens.shape
    assert moved.to_local().shape == tokens.to_local().shape == (BATCH // 32, SEQ)
    opt = with_shardings(to, tsharding.opt_state_shardings(mesh, to, cfg), mesh)
    wq = opt["m"]["layers"]["attn"]["wq"]
    assert wq.placements[:2] == (Replicate(), Shard(1))  # ZeRO: over data alone
    with pytest.raises(ValueError, match="no one placement"):
        spmd.onto(wq, step)
    back = spmd.move(spmd.onto(with_shardings(tp, tsharding.param_shardings(mesh, tp, cfg),
                                              mesh)["layers"]["attn"]["wq"], step), wq)
    assert back.device_mesh is mesh and back.placements == wq.placements
