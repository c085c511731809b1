"""End-to-end training driver.

    PYTHONPATH=src python -m repro_torch.launch.train --arch paper-lm-100m \\
        --steps 100 --batch 8 --seq 256 [--reduced] [--ckpt-dir DIR] [--device cuda|cpu]

The counterpart of ``repro/launch/train.py``, with its flags, defaults and
lines, plus ``--device`` (``cuda`` unless asked otherwise; no card is an
error, never a fall-back to the CPU). It runs the full stack: the
synthetic data pipeline with prefetch, the train step (autograd and
AdamW, ``launch.steps.build_train_step``), the fault-tolerant supervisor
with async checkpoints and straggler monitoring when ``--ckpt-dir`` is
given, and a final loss report that must show the loss improved.
``--reduced`` swaps in the same-family smoke-scale config. On a card each
step is also timed by CUDA events, beside the wall clock.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointStore
from repro_torch.configs import get
from repro_torch.data import make_train_iterator
from repro_torch.launch.steps import build_train_step
from repro_torch.models.model import Model
from repro_torch.optim import AdamW, CosineSchedule
from repro_torch.runtime import TrainSupervisor
from repro_torch.tree import leaves


@dataclass
class TrainRun:
    params: dict
    opt_state: dict
    losses: list[float]  # one a step run, replays included
    wall_s: float  # the step loop by the host's clock, ending in a synchronise
    step_ms: list[float] = field(default_factory=list)  # CUDA events a step; empty on the CPU


def frontend(cfg, batch: int) -> dict:
    """The zero front-end embeddings of a vlm or encdec batch (the
    reference driver's ``add_frontend``); nothing for the other families."""
    rows = {"vlm": cfg.frontend_tokens, "encdec": cfg.encoder_seq_len}.get(cfg.family)
    if rows is None:
        return {}
    return {"frontend_embeds": np.zeros((batch, rows, cfg.d_model), np.float32)}


def train(model: Model, params: dict, *, steps: int, batch: int, seq: int, lr: float = 3e-4,
          ckpt_dir: str = "", ckpt_every: int = 50, log_every: int = 10) -> TrainRun:
    """``steps`` train steps of ``model`` from ``params`` on the synthetic
    stream (seed 0), the reference driver's loop: AdamW under a cosine
    schedule (warm-up 20 steps, decay over ``steps``); under the
    supervisor when ``ckpt_dir`` is given."""
    cfg = model.cfg
    optimizer = AdamW(schedule=CosineSchedule(peak_lr=lr, warmup_steps=20, total_steps=steps))
    opt_state = optimizer.init(params)
    step = build_train_step(model, optimizer)
    device = model.device
    on_card = device.type == "cuda"
    extra = {k: torch.from_numpy(v).to(device) for k, v in frontend(cfg, batch).items()}

    data = make_train_iterator(cfg.vocab_size, seq, batch, prefetch=2)
    batches = {}

    def batch_fn(i):
        while True:
            s, b = next(data)
            batches[s] = {**{k: torch.from_numpy(v).to(device) for k, v in b.items()}, **extra}
            if i in batches:
                return batches.pop(i)

    losses, step_ms = [], []

    def train_step(state, b):
        if on_card:
            begin = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            begin.record()
        new_params, new_opt, metrics = step(*state, b)
        if on_card:
            end.record()
        losses.append(float(metrics["loss"]))  # the reference's read of the loss
        if on_card:
            step_ms.append(begin.elapsed_time(end))
        return (new_params, new_opt), metrics

    if on_card:
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    try:
        if ckpt_dir:
            sup = TrainSupervisor(lambda state, b: train_step(state, b)[0],
                                  CheckpointStore(ckpt_dir), ckpt_every=ckpt_every)
            params, opt_state = sup.run((params, opt_state), batch_fn, steps)
            print(f"[train] straggler events: {len(sup.monitor.flagged)}; "
                f"restarts: {sup.restarts}")
        else:
            state = (params, opt_state)
            for i in range(steps):
                state, metrics = train_step(state, batch_fn(i))
                if i % log_every == 0:
                    print(f"  step {i:4d} loss={losses[-1]:.4f} "
                          f"lr={float(metrics['lr']):.2e} "
                          f"gnorm={float(metrics['grad_norm']):.3f}")
            params, opt_state = state
    finally:
        data.close()
    if on_card:
        torch.cuda.synchronize(device)
    return TrainRun(params, opt_state, losses, time.perf_counter() - t0, step_ms)


def main(argv=None) -> TrainRun:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--arch", default="paper-lm-100m")
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--reduced", action="store_true")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=50)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--log-every", type=int, default=10)
    p.add_argument("--device", default="cuda", help="cuda (the card) or cpu")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("training on cuda needs a CUDA device; pass --device cpu to run "
                         "on the CPU")

    cfg = get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    cfg = dataclasses.replace(cfg, remat="none")
    model = Model(cfg, device=args.device)
    params = model.init(0)
    n_params = sum(x.numel() for x in leaves(params))
    print(f"[train] arch={cfg.name} params={n_params/1e6:.1f}M "
          f"batch={args.batch} seq={args.seq}")

    run = train(model, params, steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every, log_every=args.log_every)
    losses, dt = run.losses, run.wall_s
    print(f"[train] {args.steps} steps in {dt:.1f}s "
          f"({args.steps / dt:.2f} steps/s); "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    if run.step_ms:
        ms = np.asarray(run.step_ms)
        print(f"[train] {np.median(ms):.3f} ms/step median by CUDA events around each step "
              f"(min {ms.min():.3f}, max {ms.max():.3f}); wall {dt / args.steps * 1e3:.3f} "
              f"ms/step; {args.batch * args.seq * args.steps / dt:.0f} tokens/s")
    if not losses[-1] < losses[0]:
        raise SystemExit("loss did not improve")
    return run


if __name__ == "__main__":
    main()
