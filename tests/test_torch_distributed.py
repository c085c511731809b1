"""The port's sharded steps on four ``gloo`` processes (a 2×2 ``("data",
"model")`` mesh, rendezvous through a ``FileStore`` in a temporary
directory), held to the one-process port and to JAX; and on a
``(pod=2, data=2, model=1)`` mesh, the multi-pod layout, whose batch a step
runs on one mesh dim of both batch axes (``distributed.sharding.step_mesh``).

One spawn of four ranks runs every check (``_worker``) and leaves its
numbers in files; each test reads its own:

* the sharded train step at paper-lm-100m's reduced config against the
  one-process step, without gradient compression and under
  ``grad_compression="bf16"``;
* the MoE all-to-all (``moe_impl="shard_map"`` under the ambient mesh) at
  phi3.5-moe's reduced config, ``capacity_factor=4.0``, (4, 16) tokens,
  against the port's one-device forward and JAX's single-device forward of
  the same weights, the port's seeded draw handed to JAX as numpy arrays
  (``tests/test_perf_features.py``'s ``test_moe_shard_map_matches_gspmd``,
  which skips here for want of four devices), and its fallback where
  ``E % ep != 0``;
* ``ShardedOps``' pad rule on split and partial DTensors;
* a checkpoint saved unsharded restored onto placements, and a state
  resharded onto the mesh by the supervisor (the ports of
  ``tests/test_checkpoint.py:23`` and ``tests/test_substrate.py:111``);
* on the multi-pod mesh (a second spawn, ``_pod_worker``): the train step
  as above, and qwen2-0.5b's reduced decode (``launch.steps``' decode step
  over a placed cache) against the one-process decode.

The ``gpu`` tests run the train step on a one-rank NCCL group on a card and
the product rule's float32-output product there. JAX is imported only in
the test that compares with it, so the rest also runs where JAX is
absent, under another torch's DTensor rules (the H100 machine's torch
2.11, whose CPU runs the four ``gloo`` ranks too).
"""

from __future__ import annotations

import dataclasses
import os
import traceback
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.configs import get
from repro_torch.launch.steps import build_train_step
from repro_torch.models import layers
from repro_torch.models.model import Model
from repro_torch.optim import AdamW
from repro_torch.tree import leaves, tree_map

WORLD = 4
MOE_TOKENS = (4, 16)


def _lm_cfg(compress: str = "none"):
    return dataclasses.replace(get("paper-lm-100m").reduced(), remat="none",
                               grad_compression=compress)


def _moe_cfg(**over):
    return dataclasses.replace(get("phi3.5-moe-42b-a6.6b").reduced(), remat="none",
                               capacity_factor=4.0, moe_impl="shard_map", **over)


def _lm_batch():
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, 256, (4, 8), dtype=torch.int32, generator=gen)
    labels = torch.randint(0, 256, (4, 8), dtype=torch.int32, generator=gen)
    return {"tokens": tokens, "labels": labels}


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double(), b.double()
    return float((a - b).norm() / max(float(a.norm()), 1e-30))


# ----------------------------------------------------------------- the ranks


def _train_check(mesh, rank: int, partials: bool = True) -> dict:
    from repro_torch.distributed import input_shardings, opt_state_shardings, param_shardings
    from repro_torch.launch.steps import with_shardings

    out = {}
    for compress in ("none", "bf16"):
        model = Model(_lm_cfg(compress), device="cpu")
        params, opt, batch = model.init(0), AdamW(), _lm_batch()
        state = opt.init(params)
        step = build_train_step(model, opt)
        p1, s1, m1 = step(params, state, batch)
        cfg = model.cfg
        p2, s2, m2 = step(with_shardings(params, param_shardings(mesh, params, cfg), mesh),
                          with_shardings(state, opt_state_shardings(mesh, state, cfg), mesh),
                          with_shardings(batch, input_shardings(mesh, batch, cfg), mesh))
        if compress == "none" and partials:  # the loss with DTensor's own product rule
            from repro_torch.distributed import sharded, spmd

            rule, spmd._PRODUCTS = spmd._PRODUCTS, ()
            try:
                with sharded(mesh):
                    bf16_partials = float(model.loss(
                        with_shardings(params, param_shardings(mesh, params, cfg), mesh),
                        with_shardings(batch, input_shardings(mesh, batch, cfg), mesh))[0]
                        .full_tensor())
            finally:
                spmd._PRODUCTS = rule
        full_p = [x.full_tensor() for x in leaves(p2)]
        full_s = {k: [x.full_tensor() for x in leaves(s2[k])] for k in ("master", "m", "v")}
        out[compress] = {
            "loss": (float(m1["loss"]), float(m2["loss"])),
            "grad_norm": (float(m1["grad_norm"]), float(m2["grad_norm"])),
            "params": max(_rel(a, b) for a, b in zip(leaves(p1), full_p)),
            **{k: max(_rel(a, b) for a, b in zip(leaves(s1[k]), full_s[k]))
               for k in ("master", "m", "v")},
            "step": (int(s1["step"]), int(s2["step"].full_tensor())),
            "placed": all(a.placements == b.placements for a, b in zip(leaves(p2), leaves(
                with_shardings(params, param_shardings(mesh, params, cfg), mesh)))),
        }
    if partials:
        out["none"]["loss_bf16_partials"] = bf16_partials
    return out


POD_DECODE = (4, 16, 4)  # slots, cache rows, teacher-forced steps


def _decode_check(mesh, rank: int) -> dict:
    """qwen2-0.5b's reduced decode: ``launch.steps``' decode step on the
    placed parameters, cache and tokens against the plain decode, step by
    step on the same tokens; the cache comes back the caller's, written in
    place."""
    from repro_torch.distributed import cache_shardings, input_shardings, param_shardings
    from repro_torch.launch.steps import build_decode_step, with_shardings

    b, rows, steps = POD_DECODE
    model = Model(dataclasses.replace(get("qwen2-0.5b").reduced(), remat="none"), device="cpu")
    cfg, params = model.cfg, model.init(0)
    tokens = torch.randint(0, cfg.vocab_size, (steps, b, 1), dtype=torch.int32,
                           generator=torch.Generator().manual_seed(7))
    plain, cache = [], model.init_cache(b, rows)
    for i in range(steps):
        plain.append(model.decode_step(params, cache, tokens[i], i)[0].float())
    step = build_decode_step(model)
    placed = with_shardings(params, param_shardings(mesh, params, cfg), mesh)
    blank = model.init_cache(b, rows)
    sharded_cache = with_shardings(blank, cache_shardings(mesh, cfg, blank), mesh)
    got = []
    for i in range(steps):
        ids = with_shardings({"tokens": tokens[i]}, input_shardings(mesh, {"tokens": tokens[i]},
                                                                    cfg), mesh)
        logits, back = step(placed, sharded_cache, ids["tokens"], i)
        got.append(logits.full_tensor().float())
    return {"plain": torch.stack(plain), "sharded": torch.stack(got),
            "same_cache": back is sharded_cache,
            "cache": max(_rel(cache[k], sharded_cache[k].full_tensor()) for k in cache),
            "logits_batch_split": logits.placements[0].is_shard(0),
            "step_mesh": tuple(logits.device_mesh.mesh_dim_names)}


def _moe_check(mesh, rank: int, directory: str) -> dict:
    from repro_torch.distributed import input_shardings, param_shardings, sharded, use_mesh
    from repro_torch.launch.steps import with_shardings

    params = torch.load(os.path.join(directory, "moe_params.pt"))
    tokens = torch.load(os.path.join(directory, "moe_tokens.pt"))
    model = Model(_moe_cfg(), device="cpu")
    cfg = model.cfg
    one, aux_one = model.forward(params, {"tokens": tokens})
    batch = {"tokens": tokens}
    with sharded(mesh):
        logits, aux = model.forward(with_shardings(params, param_shardings(mesh, params, cfg), mesh),
                                    with_shardings(batch, input_shardings(mesh, batch, cfg), mesh))
    # the reference's shard_map averages each data shard's aux over the batch axes
    shard_aux = [model.forward(params, {"tokens": t})[1] for t in tokens.chunk(2)]
    # E % ep != 0: no all-to-all, the one-device formulation (3 experts over a 2-way axis)
    odd = Model(_moe_cfg(n_experts=3), device="cpu")
    odd_params = odd.init(5)
    x = torch.randn((2, 4, cfg.d_model), generator=torch.Generator().manual_seed(3)).to(
        torch.bfloat16)
    with use_mesh(mesh):
        none = layers._moe_shard_map(odd_params["layers"]["moe"], odd.cfg, x)
    return {
        "logits": logits.full_tensor().float(), "aux": float(aux.full_tensor()),
        "one": one.float(), "aux_one": float(aux_one),
        "shard_aux": float(sum(shard_aux) / len(shard_aux)),
        "batch_on_data": logits.placements[0].is_shard(0),
        "odd_falls_back": none is None,
    }


def _restore_check(mesh, rank: int, directory: str) -> dict:
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.checkpoint import CheckpointStore
    from repro_torch.runtime.supervisor import TrainSupervisor

    saved = torch.load(os.path.join(directory, "ckpt_tree.pt"))
    store = CheckpointStore(os.path.join(directory, "ckpt"))
    targets = {"w": (Shard(0), Shard(1)), "opt": {"m": (Replicate(), Shard(0))}}
    out = store.restore(3, saved, placements=targets, mesh=mesh)
    coords = mesh.get_coordinate()
    want_w = saved["w"].chunk(2, 0)[coords[0]].chunk(2, 1)[coords[1]]
    want_m = saved["opt"]["m"].chunk(2, 0)[coords[1]]
    # leaves named with no placements come back on the like leaf's device
    partial = store.restore(3, saved, devices={"w": "cpu", "opt": {"m": None}})
    state = TrainSupervisor.reshard({"w": torch.ones(8, 8)}, {"w": (Shard(1), Replicate())},
                                    mesh=mesh)
    return {
        "w_bits": torch.equal(out["w"].to_local().view(torch.int32), want_w.view(torch.int32)),
        "m_bits": torch.equal(out["opt"]["m"].to_local().view(torch.int16),
                              want_m.view(torch.int16)),
        "placements": (out["w"].placements == targets["w"]
                       and out["opt"]["m"].placements == targets["opt"]["m"]),
        "dtype": str(out["opt"]["m"].dtype),
        "whole": bool(torch.equal(out["w"].full_tensor(), saved["w"])),
        "unplaced": torch.equal(partial["opt"]["m"].view(torch.int16),
                                saved["opt"]["m"].view(torch.int16)),
        "reshard": (state["w"].placements == (Shard(1), Replicate())
                    and tuple(state["w"].to_local().shape) == (8, 4)),
    }


def _pad_check(mesh) -> dict:
    """``ShardedOps``' pad rule: F.pad of DTensors split in other dims than
    the padded one (kept split), in the padded one (gathered first), and
    partial (reduced first), against the plain pad of the whole tensor."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    from repro_torch.distributed import sharded
    from repro_torch.distributed.spmd import place

    x = torch.randn((4, 6, 8), generator=torch.Generator().manual_seed(4)).to(torch.bfloat16)
    want = F.pad(x, (0, 0, 2, 0), value=1.0)
    out = {}
    for name, placements in (("other dims", (Shard(0), Shard(2))),
                             ("padded dim", (Shard(1), Replicate()))):
        with sharded(mesh):
            got = F.pad(place(x, mesh, placements), (0, 0, 2, 0), value=1.0)
        out[name] = (torch.equal(got.full_tensor(), want), got.placements == placements
                     if name == "other dims" else got.placements[0] == Replicate())
    part = DTensor.from_local(x / 4, mesh, (Partial(), Partial()), run_check=False)
    with sharded(mesh):
        got = F.pad(part, (0, 0, 2, 0), value=1.0)
    out["partial"] = (torch.equal(got.full_tensor(), want),
                      all(p.is_replicate() for p in got.placements))
    return out


def _worker(rank: int, directory: str) -> None:
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)  # four ranks beside the suite's other workers
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(directory, "store"), WORLD),
                            rank=rank, world_size=WORLD)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    checks = {"train": lambda: _train_check(mesh, rank),
              "moe": lambda: _moe_check(mesh, rank, directory),
              "restore": lambda: _restore_check(mesh, rank, directory),
              "pad": lambda: _pad_check(mesh)}
    for name, check in checks.items():
        try:
            result = check()
        except Exception:
            result = {"error": traceback.format_exc()}
        torch.save(result, os.path.join(directory, f"{name}_{rank}.pt"))
    dist.destroy_process_group()


def _pod_worker(rank: int, directory: str) -> None:
    warnings.filterwarnings("ignore")
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", store=dist.FileStore(os.path.join(directory, "store"), WORLD),
                            rank=rank, world_size=WORLD)
    mesh = init_device_mesh("cpu", (2, 2, 1), mesh_dim_names=("pod", "data", "model"))
    checks = {"pod_train": lambda: _train_check(mesh, rank, partials=False),
              "pod_decode": lambda: _decode_check(mesh, rank)}
    for name, check in checks.items():
        try:
            result = check()
        except Exception:
            result = {"error": traceback.format_exc()}
        torch.save(result, os.path.join(directory, f"{name}_{rank}.pt"))
    dist.destroy_process_group()


def _reader(directory: str):
    def result(name: str, rank: int = 0) -> dict:
        out = torch.load(os.path.join(directory, f"{name}_{rank}.pt"), weights_only=False)
        assert "error" not in out, out.get("error")
        return out

    return result


@pytest.fixture(scope="module")
def pod_ranks(tmp_path_factory):
    """Runs the four ranks of the multi-pod mesh once; ``pod_ranks(name,
    rank)`` is a check's result."""
    directory = str(tmp_path_factory.mktemp("gloo_pods"))
    mp.spawn(_pod_worker, args=(directory,), nprocs=WORLD, join=True)
    return _reader(directory)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Runs the four ranks once; ``ranks(name, rank)`` is a check's result.
    The MoE weights are the port's seeded draw, whose values the JAX test
    hands to the reference as numpy arrays; nothing here needs JAX."""
    from repro_torch.checkpoint import CheckpointStore

    directory = str(tmp_path_factory.mktemp("gloo"))
    cfg = dataclasses.replace(_moe_cfg(), moe_impl="gspmd")
    params = Model(cfg, device="cpu").init(0)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, MOE_TOKENS, dtype=np.int32)
    torch.save(params, os.path.join(directory, "moe_params.pt"))
    torch.save(torch.from_numpy(tokens), os.path.join(directory, "moe_tokens.pt"))
    tree = {"w": torch.arange(32, dtype=torch.float32).reshape(4, 8) * 1.5,
            "opt": {"m": torch.randn(6, generator=torch.Generator().manual_seed(2)).to(
                torch.bfloat16)}}
    CheckpointStore(os.path.join(directory, "ckpt")).save(3, tree, blocking=True)
    torch.save(tree, os.path.join(directory, "ckpt_tree.pt"))
    mp.spawn(_worker, args=(directory,), nprocs=WORLD, join=True)
    result = _reader(directory)
    result.moe = (params, tokens)
    return result


# ------------------------------------------------------------------ the tests


def test_sharded_train_step_matches_the_one_process_step(ranks):
    """No compression: the loss within 1e-4 relative and every updated leaf
    (parameters, master, ``m``, ``v``) within 1e-3 relative L2. The split
    products sum their partials in float32 (``distributed.spmd``), forward
    and backward. On AdamW's first step each weight moves by about lr
    whatever its gradient, so ``m`` and ``v``, the gradient and its square,
    are the leaves that hold the gradient (measured, 2×2 gloo: m 8.9e-6, v
    1.0e-6; a step that saw half the batch reads ≈ 0.97 and ≈ 1.1)."""
    for rank in range(WORLD):
        r = ranks("train", rank)["none"]
        one, sharded = r["loss"]
        assert abs(one - sharded) <= 1e-4 * abs(one)
        assert max(r["params"], r["master"], r["m"], r["v"]) <= 1e-3
        assert abs(r["grad_norm"][0] - r["grad_norm"][1]) <= 1e-3 * r["grad_norm"][0]
        assert r["step"] == (1, 1) and r["placed"]


@pytest.mark.parametrize("compress", ["none", "bf16"])
def test_multi_pod_train_step_matches_the_one_process_step(pod_ranks, compress):
    """The train step on the ``(pod=2, data=2, model=1)`` mesh, the layout
    torch 2.11 refused while the batch was split over two mesh dims: the
    forward and backward run with the batch on ``pod_data``, the update on
    ZeRO's split over ``data`` alone. Held at the 2×2 step's limits: loss
    within 1e-4, every updated leaf within 1e-3, and under bf16 compression
    ``m`` within 1e-2 and ``v`` within 2e-2."""
    for rank in range(WORLD):
        r = pod_ranks("pod_train", rank)[compress]
        one, sharded = r["loss"]
        assert abs(one - sharded) <= 1e-4 * abs(one)
        assert r["params"] <= 1e-3 and r["master"] <= 1e-3
        limits = (1e-3, 1e-3) if compress == "none" else (1e-2, 2e-2)
        assert r["m"] <= limits[0] and r["v"] <= limits[1]
        assert abs(r["grad_norm"][0] - r["grad_norm"][1]) <= limits[0] * r["grad_norm"][0]
        assert r["step"] == (1, 1) and r["placed"]


def test_multi_pod_decode_matches_the_one_process_decode(pod_ranks):
    """qwen2-0.5b's reduced decode on the multi-pod mesh, four teacher-forced
    steps of 4 slots: the logits at the MoE check's limits (rtol 0.05, atol
    0.1), each step's ids equal, the cache written in place and returned,
    within 1e-3 relative of the plain one; the logits come back on the
    step mesh with the batch split over ``pod_data``."""
    for rank in range(WORLD):
        r = pod_ranks("pod_decode", rank)
        np.testing.assert_allclose(r["sharded"].numpy(), r["plain"].numpy(), rtol=0.05, atol=0.1)
        assert torch.equal(r["sharded"].argmax(-1), r["plain"].argmax(-1))
        assert r["same_cache"] and r["cache"] <= 1e-3
        assert r["logits_batch_split"] and r["step_mesh"] == ("pod_data", "model")


def test_the_float32_partial_sums_are_what_hold_the_loss(ranks):
    """Without ``ShardedOps``' product rule, DTensor rounds each device's
    partial sum of a split contraction to bf16 and reduces in bf16: the
    same forward's loss then leaves the 1e-4 the sharded step meets."""
    r = ranks("train", 0)["none"]
    one, _ = r["loss"]
    assert abs(r["loss_bf16_partials"] - one) > 1e-4 * abs(one)


def test_sharded_train_step_under_bf16_gradient_compression(ranks):
    """``grad_compression="bf16"``: the weight gradients' partial sums cross
    the data axis in bf16, each data shard's rounded (2^-9 ≈ 2e-3
    relative) before the reduction and the sum rounded again, where one
    process rounds the whole sum once. So the gradient, ``m``, is held
    within 1e-2 relative L2 and its square, ``v``, within 2e-2 (measured,
    2×2 gloo: 2.9e-3 and 6.0e-3; half the batch reads ≈ 0.97 and ≈ 1.1).
    The forward is untouched (loss within 1e-4) and the updated weights
    stay within 1e-3."""
    for rank in range(WORLD):
        r = ranks("train", rank)["bf16"]
        one, sharded = r["loss"]
        assert abs(one - sharded) <= 1e-4 * abs(one)
        assert r["params"] <= 1e-3 and r["master"] <= 1e-3
        assert r["m"] <= 1e-2 and r["v"] <= 2e-2
        assert abs(r["grad_norm"][0] - r["grad_norm"][1]) <= 1e-2 * r["grad_norm"][0]


def test_the_moment_limits_catch_a_step_that_saw_half_the_batch():
    """The limits above against a planted fault, in one process: a step on
    half the batch leaves ``m`` and ``v`` far outside even the compressed
    step's limits, while the updated weights barely notice it (why the
    moments are the gradient's check)."""
    model, opt = Model(_lm_cfg(), device="cpu"), AdamW()
    params, batch = model.init(0), _lm_batch()
    step = build_train_step(model, opt)
    p1, s1, _ = step(params, opt.init(params), batch)
    p2, s2, _ = step(params, opt.init(params), {k: v[:2] for k, v in batch.items()})
    worst = {k: max(_rel(a, b) for a, b in zip(leaves(s1[k]), leaves(s2[k])))
             for k in ("m", "v")}
    assert worst["m"] > 10 * 1e-2 and worst["v"] > 10 * 2e-2, worst
    assert max(_rel(a, b) for a, b in zip(leaves(p1), leaves(p2))) < 1e-3


def test_moe_all_to_all_matches_one_device_and_jax(ranks):
    """The expert-parallel forward against the port's one-device forward and
    JAX's single-device forward of the same weights, at the reference's
    rtol 0.05 and atol 0.1; its aux loss is the mean of the data shards'."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get as jget
    from repro.models.model import Model as JModel

    params, tokens = ranks.moe
    cfg = dataclasses.replace(jget("phi3.5-moe-42b-a6.6b").reduced(), remat="none",
                              capacity_factor=4.0)
    jparams = jax.tree.map(lambda a, like: jnp.asarray(a, like.dtype),
                           tree_map(lambda t: t.float().numpy(), params),
                           jax.eval_shape(JModel(cfg).init, jax.random.key(0)))
    want, _ = jax.jit(JModel(cfg).forward)(jparams, {"tokens": jnp.asarray(tokens)})
    want = np.asarray(want, np.float32)
    for rank in range(WORLD):
        r = ranks("moe", rank)
        got = r["logits"].numpy()
        np.testing.assert_allclose(got, r["one"].numpy(), rtol=0.05, atol=0.1)
        np.testing.assert_allclose(got, want, rtol=0.05, atol=0.1)
        assert np.isfinite(got).all()
        assert r["aux"] == pytest.approx(r["shard_aux"], rel=1e-5)
        assert r["batch_on_data"]


def test_moe_all_to_all_matches_the_one_device_forward(ranks):
    """The expert-parallel forward against the port's one-device forward
    alone (no JAX: it runs where torch's DTensor version differs from this
    one's), at the reference's rtol 0.05 and atol 0.1, its aux the mean of
    the data shards'."""
    for rank in range(WORLD):
        r = ranks("moe", rank)
        np.testing.assert_allclose(r["logits"].numpy(), r["one"].numpy(), rtol=0.05, atol=0.1)
        assert r["aux"] == pytest.approx(r["shard_aux"], rel=1e-5)
        assert r["batch_on_data"]


def test_moe_shard_map_falls_back_where_the_experts_do_not_divide(ranks):
    """``E % ep != 0``: ``_moe_shard_map`` declines and ``moe_apply`` runs the
    one-device formulation, as the reference's does."""
    for rank in range(WORLD):
        assert ranks("moe", rank)["odd_falls_back"]


def test_moe_shard_map_falls_back_without_a_mesh():
    """No ambient mesh: ``moe_impl="shard_map"`` is the one-device path, bit
    for bit (``tests/test_perf_features.py:54``)."""
    cfg = dataclasses.replace(get("phi3.5-moe-42b-a6.6b").reduced(), remat="none")
    params = Model(cfg, device="cpu").init(0)
    batch = {"tokens": torch.ones((2, 8), dtype=torch.int32)}
    assert layers._moe_shard_map(params["layers"]["moe"], cfg,
                                 torch.zeros((2, 8, cfg.d_model), dtype=torch.bfloat16)) is None
    gspmd, _ = Model(cfg, device="cpu").forward(params, batch)
    shard_map, _ = Model(dataclasses.replace(cfg, moe_impl="shard_map"), device="cpu").forward(
        params, batch)
    assert torch.isfinite(shard_map.float()).all()
    assert torch.equal(gspmd, shard_map)


def test_restore_places_each_rank_its_slice(ranks):
    """A checkpoint saved unsharded comes back as DTensors with the target
    placements: each rank's local shard is its slice of the saved array,
    bit for bit, bf16 kept (``tests/test_checkpoint.py:23``)."""
    for rank in range(WORLD):
        r = ranks("restore", rank)
        assert r["w_bits"] and r["m_bits"] and r["placements"] and r["whole"]
        assert r["dtype"] == "torch.bfloat16" and r["unplaced"]


def test_supervisor_reshards_onto_the_mesh(ranks):
    """``TrainSupervisor.reshard`` onto a mesh's placements
    (``tests/test_substrate.py:111``)."""
    for rank in range(WORLD):
        assert ranks("restore", rank)["reshard"]


def test_a_pad_of_a_split_tensor_equals_the_whole_pad(ranks):
    """``F.pad`` on DTensors (the Mamba convolution's causal pad, the RWKV
    token shift) pads each rank's shard: split in other dims the result
    stays split, split in the padded dim it is gathered first, partial it
    is reduced first; each equals the plain pad bit for bit."""
    for rank in range(WORLD):
        r = ranks("pad", rank)
        assert r == {"other dims": (True, True), "padded dim": (True, True),
                     "partial": (True, True)}


@pytest.mark.gpu
def test_the_split_product_keeps_bf16_operands_on_the_card():
    """``ShardedOps``' product rule on a card: bf16 operands into a float32
    accumulator and output (``mm``'s and ``bmm``'s ``out_dtype`` overloads),
    against the product of the operands converted to float32, which holds
    the same exact products and differs only in the order of the adds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.distributed.spmd import _F32_OUT

    gen = torch.Generator().manual_seed(6)
    a = torch.randn((3, 64, 896), generator=gen).to("cuda", torch.bfloat16)
    b = torch.randn((3, 896, 128), generator=gen).to("cuda", torch.bfloat16)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        for func, x, y in ((torch.ops.aten.mm.default, a[0], b[0]),
                           (torch.ops.aten.bmm.default, a, b)):
            got = _F32_OUT[func](x, y, torch.float32)
            want = func(x.float(), y.float())
            assert got.dtype == torch.float32
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.gpu
def test_one_rank_nccl_train_step_matches_the_unsharded_step(tmp_path):
    """On a card: a one-rank NCCL group on a 1×1 mesh; the sharded step's
    loss and every updated leaf equal the unsharded step's bit for bit."""
    if not torch.cuda.is_available() or not dist.is_nccl_available():
        pytest.skip("needs a CUDA device and NCCL")
    from repro_torch.distributed import input_shardings, opt_state_shardings, param_shardings
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.steps import with_shardings

    dist.init_process_group("nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
                            rank=0, world_size=1, device_id=torch.device("cuda", 0))
    try:
        mesh = make_host_mesh()
        model = Model(_lm_cfg(), device="cuda")
        params, opt = model.init(0), AdamW()
        state = opt.init(params)
        batch = {k: v.cuda() for k, v in _lm_batch().items()}
        step = build_train_step(model, opt)
        p1, s1, m1 = step(params, state, batch)
        cfg = model.cfg
        p2, s2, m2 = step(with_shardings(params, param_shardings(mesh, params, cfg), mesh),
                          with_shardings(state, opt_state_shardings(mesh, state, cfg), mesh),
                          with_shardings(batch, input_shardings(mesh, batch, cfg), mesh))
        assert torch.equal(m1["loss"], m2["loss"])
        for a, b in zip(leaves(p1) + leaves(s1), leaves(p2) + leaves(s2)):
            assert torch.equal(a, b.full_tensor())
    finally:
        dist.destroy_process_group()
