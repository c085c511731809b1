"""AdamW with global-norm clipping, cosine schedule, and fp32 master weights.

The counterpart of ``repro/optim/adamw.py``, with its state tree: ``step``
(a 0-d int32 tensor on the parameters' device), and ``master``, ``m`` and
``v``, each a float32 tree of the parameters' structure. Parameters stay
in their own dtype (bf16 compute precision) and are cast from the master
copy after each update.

:meth:`AdamW.update` is functional: it returns new parameters and a new
state and changes none of its arguments, so a state that a caller keeps
(the supervisor's replay point, a checkpoint being written) stays as it
was. The arithmetic is the reference's, op by op in float32, over all
leaves at once (``torch._foreach_*``: a few kernels a step, not a few a
leaf). ``step``, the learning rate, the bias corrections and the clip
scale stay on the device, so an update reads nothing back to the host.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..tree import leaves, tree_map, unflatten


@dataclass(frozen=True)
class CosineSchedule:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_ratio: float = 0.1

    def __call__(self, step: torch.Tensor) -> torch.Tensor:
        """The learning rate at ``step`` (a tensor), in float32 on its device."""
        step = step.float()
        warm = step / max(self.warmup_steps, 1)
        prog = torch.clamp(
            (step - self.warmup_steps) / max(self.total_steps - self.warmup_steps, 1),
            0.0,
            1.0,
        )
        cos = self.min_ratio + (1 - self.min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
        return self.peak_lr * torch.where(step < self.warmup_steps, warm, cos)


@dataclass(frozen=True)
class AdamW:
    schedule: CosineSchedule = CosineSchedule()
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0

    def init(self, params) -> dict:
        some = leaves(params)[0]
        return {
            "step": torch.zeros((), dtype=torch.int32, device=some.device),
            "master": tree_map(lambda p: p.detach().to(torch.float32, copy=True), params),
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                          params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                          params),
        }

    def update(self, params, grads, state) -> tuple:
        """Returns (new params, new state, {"grad_norm", "lr"}), the two
        metrics 0-d float32 tensors on the device. Each op of the reference
        is one ``foreach`` pass, in place on a temporary this call made, so
        no more than a few f32 copies of the parameters live at once."""
        g = [x.to(torch.float32, copy=True) for x in leaves(grads)]
        gnorm = torch.sqrt(sum(torch.sum(torch.square(x)) for x in g))
        scale = torch.clamp(self.clip_norm / (gnorm + 1e-12), max=1.0)
        torch._foreach_mul_(g, scale)

        step = state["step"] + 1
        lr = self.schedule(step)
        b1c = 1 - self.b1 ** step.float()
        b2c = 1 - self.b2 ** step.float()

        new_m = torch._foreach_mul(leaves(state["m"]), self.b1)
        torch._foreach_add_(new_m, torch._foreach_mul(g, 1 - self.b1))
        new_v = torch._foreach_mul(leaves(state["v"]), self.b2)
        torch._foreach_mul_(g, g)  # g is not needed past here: square it in place
        torch._foreach_mul_(g, 1 - self.b2)
        torch._foreach_add_(new_v, g)
        del g

        master = leaves(state["master"])
        upd = torch._foreach_div(new_m, b1c)  # mh, then the update
        den = torch._foreach_div(new_v, b2c)  # vh, then sqrt(vh) + eps
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        torch._foreach_div_(upd, den)
        del den
        torch._foreach_add_(upd, torch._foreach_mul(master, self.weight_decay))
        torch._foreach_mul_(upd, lr)
        new_master = torch._foreach_sub(master, upd)
        del upd

        new_params = unflatten(params, [mast.to(p.dtype) for p, mast
                                        in zip(leaves(params), new_master)])
        new_state = {"step": step,
                     "master": unflatten(state["master"], new_master),
                     "m": unflatten(state["m"], new_m),
                     "v": unflatten(state["v"], new_v)}
        return new_params, new_state, {"grad_norm": gnorm, "lr": lr}
