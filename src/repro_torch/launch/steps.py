"""Step-function builders shared by training, serving, and the dry run.

The counterpart of ``repro/launch/steps.py``. The steps close over a model
(and an optimizer) only. Shardings are attached to the arguments: on one
device the arguments are plain tensors; over a mesh they are DTensors whose
placements come from ``distributed`` (:func:`with_shardings`, and
:func:`abstract_cell_args` for the dry run's meta-local ones), and the same
step runs the model code on them under ``distributed.sharded``, as the
reference's ``jax.jit`` lowers one step on the 1-device mesh and on the
512-chip one. The arguments keep the reference's mesh and placements; a
step carries them onto ``distributed.sharding.step_mesh`` (the batch axes
as one mesh dim), with no communication, and runs there.
"""

from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

from ..configs import ShapeSpec
from ..distributed import (
    cache_shardings,
    input_shardings,
    opt_state_shardings,
    param_shardings,
    sharded,
)
from ..distributed.sharding import step_mesh
from ..distributed.spmd import move, onto, place
from ..models.config import ModelConfig
from ..models.model import Model
from ..optim import AdamW
from ..tree import leaves, tree_map, unflatten


def _spmd(x, grad_dtype: torch.dtype = torch.float32):
    """``distributed.sharded`` over ``x``'s mesh for a DTensor ``x``; nothing
    for a plain tensor."""
    if isinstance(x, DTensor):
        return sharded(x.device_mesh, grad_dtype)
    return contextlib.nullcontext()


def _on_step_mesh(cfg: ModelConfig, *trees):
    """``trees`` with every DTensor leaf carried onto the step mesh of the
    first one's mesh (``distributed.sharding.step_mesh``; ``spmd.onto``);
    plain trees as they are."""
    first = next((x for x in leaves(list(trees)) if isinstance(x, DTensor)), None)
    if first is None:
        return trees
    mesh = step_mesh(first.device_mesh, cfg)
    return tuple(tree_map(lambda x: onto(x, mesh), t) for t in trees)


def _replicated(x):
    """A DTensor as the whole tensor on every rank; a plain tensor as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def build_train_step(model: Model, optimizer: AdamW):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss and its gradients by autograd, then one optimizer
    update. Functional, as the reference's jitted step: the tensors passed
    in are left as they were. ``metrics`` holds ``loss``, its parts and the
    update's ``grad_norm`` and ``lr``, each a 0-d tensor on the device (no
    read-back). With ``grad_compression == "bf16"`` the gradients are cast
    to bf16 before the update, as the reference casts them for its
    cross-data reduction. ``cfg.remat`` (``"none"``, ``"dots"`` or
    ``"full"``) checkpoints each layer of the forward (``models.model``'s
    ``_remat``): the same loss and gradients, at another peak memory.

    Over a mesh (DTensor arguments, :func:`with_shardings`) the same step
    runs sharded. A weight gradient's products reduce across the batch
    axes as they sum over the tokens (``distributed.spmd.ShardedOps``), in
    float32 or, under ``grad_compression="bf16"``, in bf16 (half the wire
    bytes); a gradient that leaves autograd still partial (a norm's sum)
    is reduced straight to its optimizer state's placement (a
    reduce-scatter along ``data`` where ZeRO shards the state), in bf16
    under compression, else in its own dtype. The update runs on the
    state's shards and the new parameters are gathered back to the
    parameters' placements. The forward and backward run on the step
    mesh; the gradients are carried back to the optimizer state's mesh
    (``spmd.move``), where ZeRO's split over ``data`` alone lives. The
    metrics come back whole on every rank."""
    compress = model.cfg.grad_compression

    def train_step(params, opt_state, batch):
        on_step, batch = _on_step_mesh(model.cfg, params, batch)
        flat = [p.detach().requires_grad_() for p in leaves(on_step)]
        with _spmd(flat[0], torch.bfloat16 if compress == "bf16" else torch.float32):
            loss, metrics = model.loss(unflatten(params, flat), batch)
            grads = torch.autograd.grad(loss, flat, materialize_grads=True)
            if compress == "bf16":
                grads = [g.to(torch.bfloat16) for g in grads]
            grads = [move(g, m) for g, m in zip(grads, leaves(opt_state["m"]))]
            new_params, new_opt, opt_metrics = optimizer.update(
                params, unflatten(params, grads), opt_state)
            new_params = tree_map(move, new_params, params)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return new_params, new_opt, {k: _replicated(v.detach()) for k, v in metrics.items()}

    return train_step


def build_prefill_step(model: Model):
    def prefill_step(params, batch):
        params, batch = _on_step_mesh(model.cfg, params, batch)
        with _spmd(batch["tokens"]):
            logits, _ = model.forward(params, batch)
        return logits

    return prefill_step


def build_decode_step(model: Model):
    """``decode_step(params, cache, tokens, pos) -> (logits, cache)``:
    ``Model.decode_step``, which updates ``cache`` in place; over a mesh on
    the step mesh, whose DTensors share the local shards of the caller's
    cache, which is returned."""
    def decode_step(params, cache, tokens, pos):
        on_step = _on_step_mesh(model.cfg, params, cache, tokens, pos)
        with _spmd(on_step[2]):
            logits, _ = model.decode_step(*on_step)
        return logits, cache

    return decode_step


# --------------------------------------------------------------------------
# Argument trees with shardings attached
# --------------------------------------------------------------------------


def _zip_dicts(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_dicts(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def with_shardings(tree, sharding_tree, mesh):
    """Each leaf of ``tree`` as a DTensor over ``mesh`` with its placements in
    ``sharding_tree`` (a tree of the ``distributed.*_shardings``). A leaf on
    ``torch.device("meta")`` becomes a DTensor of meta local shards, nothing
    allocated (the dry run); any other leaf, which every rank holds whole,
    is sliced to this rank's shard where it lies, with no communication."""

    def leaf(x, placements):
        if x.device.type == "meta":
            shape, _ = compute_local_shape_and_global_offset(x.shape, mesh, placements)
            local = torch.empty(shape, dtype=x.dtype, device="meta")
            return DTensor.from_local(local, mesh, placements, run_check=False,
                                      shape=x.shape, stride=x.stride())
        return place(x, mesh, placements)

    return _zip_dicts(leaf, tree, sharding_tree)


def serve_input_specs(cfg: ModelConfig, shape: ShapeSpec) -> dict:
    """Decode-step inputs: one new token against a seq_len-deep cache."""
    meta = torch.device("meta")
    return {"tokens": torch.empty((shape.global_batch, 1), dtype=torch.int32, device=meta),
            "pos": torch.empty((), dtype=torch.int32, device=meta)}


def abstract_cell_args(model: Model, shape: ShapeSpec, mesh, optimizer: AdamW | None):
    """Abstract, sharded argument trees for one (arch × shape) dry-run cell:
    DTensors of meta local shards over ``mesh``.

    Returns (step_kind, args tuple, donate_argnums)."""
    cfg = model.cfg
    params = model.abstract_params()
    sharded_params = with_shardings(params, param_shardings(mesh, params, cfg), mesh)
    if shape.kind in ("train", "prefill"):
        batch = model.input_specs(shape.global_batch, shape.seq_len)
        if shape.kind == "prefill":
            batch.pop("labels")
        sharded_batch = with_shardings(batch, input_shardings(mesh, batch, cfg), mesh)
        if shape.kind == "prefill":
            return "prefill", (sharded_params, sharded_batch), ()
        assert optimizer is not None
        opt = optimizer.init(params)
        return "train", (sharded_params,
                         with_shardings(opt, opt_state_shardings(mesh, opt, cfg), mesh),
                         sharded_batch), (0, 1)
    cache = model.init_cache(shape.global_batch, shape.seq_len, concrete=False)
    inputs = serve_input_specs(cfg, shape)
    tok_sh = input_shardings(mesh, {"tokens": inputs["tokens"]}, cfg)
    tok_sh["pos"] = (Replicate(),) * mesh.ndim
    inputs = with_shardings(inputs, tok_sh, mesh)
    return "decode", (sharded_params,
                      with_shardings(cache, cache_shardings(mesh, cfg, cache), mesh),
                      inputs["tokens"], inputs["pos"]), (1,)


def build_step_for(model: Model, shape: ShapeSpec, optimizer: AdamW | None):
    if shape.kind == "train":
        return build_train_step(model, optimizer)
    if shape.kind == "prefill":
        return build_prefill_step(model)
    return build_decode_step(model)
