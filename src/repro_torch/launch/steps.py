"""Step-function builders shared by training and serving.

The counterpart of ``repro/launch/steps.py`` for one device:
``build_train_step``, ``build_prefill_step`` and ``build_decode_step``
close over a model (and an optimizer) only. The reference's
``with_shardings``, ``serve_input_specs``, ``abstract_cell_args`` and
``build_step_for`` attach mesh shardings to abstract arguments for the
dry run; they need ``distributed`` and the registry's ``ShapeSpec``, and
wait for ``ROADMAP.md`` Queue 1, item 6.
"""

from __future__ import annotations

import torch

from ..models.model import Model
from ..optim import AdamW
from ..tree import leaves, unflatten


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
    ``_remat``): the same loss and gradients, at another peak memory."""
    compress = model.cfg.grad_compression

    def train_step(params, opt_state, batch):
        flat = [p.detach().requires_grad_() for p in leaves(params)]
        loss, metrics = model.loss(unflatten(params, flat), batch)
        grads = torch.autograd.grad(loss, flat, materialize_grads=True)
        if compress == "bf16":
            grads = [g.to(torch.bfloat16) for g in grads]
        new_params, new_opt, opt_metrics = optimizer.update(
            params, unflatten(params, list(grads)), opt_state)
        metrics = {k: v.detach() for k, v in metrics.items()}
        return new_params, new_opt, {**metrics, **opt_metrics, "loss": loss.detach()}

    return train_step


def build_prefill_step(model: Model):
    def prefill_step(params, batch):
        logits, _ = model.forward(params, batch)
        return logits

    return prefill_step


def build_decode_step(model: Model):
    def decode_step(params, cache, tokens, pos):
        return model.decode_step(params, cache, tokens, pos)

    return decode_step
