"""Fault-tolerant training runtime: checkpoint/restart, straggler
mitigation, placement of a restored state.

The counterpart of ``repro/runtime/supervisor.py``:

* **Checkpoint/restart** — periodic async checkpoints (atomic, CRC-checked,
  see ``repro_torch.checkpoint``); any exception inside a step rolls back to
  the last complete step and replays. Data determinism
  (``repro_torch.data``) makes the replay exact.
* **Replay before the first checkpoint** — from the state ``run`` was
  given, which it keeps until it issues the first checkpoint (a
  reference: the train step is functional and changes no tensor of its
  input, so this holds one state, parameters and optimizer state, in
  memory beside the live one for those steps). The reference replays from
  step 0 on the state it had reached when the step failed, so its replay
  applies those steps twice (``ROADMAP.md`` Queue 3).
* **Straggler mitigation** — per-step wall times feed a rolling median; a
  step exceeding ``factor ×`` the median is flagged and counted.
* **Placement** — ``reshard`` moves each leaf of a state to the device named
  for it, or, given a mesh, places it as a DTensor with the placements named
  for it (the reference's move onto a new mesh's shardings, elastic
  rescale).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

from ..checkpoint import CheckpointStore
from ..distributed.spmd import place
from ..tree import tree_map


@dataclass
class StragglerMonitor:
    factor: float = 3.0
    window: int = 32
    times: list = field(default_factory=list)
    flagged: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        history = self.times[-self.window :]
        self.times.append(dt)
        if len(history) < 5:
            return False
        median = sorted(history)[len(history) // 2]
        if dt > self.factor * median:
            self.flagged.append((step, dt, median))
            return True
        return False


class TrainSupervisor:
    def __init__(
        self,
        step_fn,  # (state, batch) -> state, changing no tensor of its input
        store: CheckpointStore,
        *,
        ckpt_every: int = 50,
        straggler_factor: float = 3.0,
        max_restarts: int = 3,
    ):
        self.step_fn = step_fn
        self.store = store
        self.ckpt_every = ckpt_every
        self.monitor = StragglerMonitor(factor=straggler_factor)
        self.max_restarts = max_restarts
        self.restarts = 0

    def run(self, state, batch_fn, n_steps: int, *, fault_hook=None):
        """Run to ``n_steps``; ``fault_hook(step)`` may raise to simulate a
        node failure — the supervisor restores and replays."""
        step = 0
        if self.store.latest_step() is not None:
            step = self.store.latest_step()
            state = self.store.restore(step, state)
        start = (step, state)  # the replay point until a checkpoint is written
        while step < n_steps:
            try:
                t0 = time.perf_counter()
                if fault_hook is not None:
                    fault_hook(step)
                batch = batch_fn(step)
                state = self.step_fn(state, batch)
                if (step + 1) % self.ckpt_every == 0 or step + 1 == n_steps:
                    self.store.save(step + 1, state, blocking=False)
                    start = None  # the checkpoint is the replay point from here on
                self.monitor.observe(step, time.perf_counter() - t0)
                step += 1
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                self.store.wait()
                last = self.store.latest_step()
                if last is None:
                    if start is None:  # the checkpoint written since the start is gone
                        raise
                    step, state = start  # no checkpoint yet: replay from the start
                    continue
                state = self.store.restore(last, state)
                step = last
        self.store.wait()
        return state

    # ------------------------------------------------------------- placement

    @staticmethod
    def reshard(state, targets, mesh=None):
        """Move each leaf of ``state`` to its device in ``targets``, a tree of
        devices; or, given ``mesh``, place it on the mesh with its placements
        in ``targets``, a tree of the ``distributed.*_shardings`` (a
        DTensor leaf is gathered and placed anew)."""
        if mesh is None:
            return tree_map(lambda x, dev: x.to(dev), state, targets)
        return _map_placed(state, targets, lambda x, pl: place(x, mesh, pl))


def _map_placed(tree, placements, fn):
    """``fn(leaf, its placements)`` over a tree of dicts (placements are
    tuples, so ``tree_map`` would walk into them)."""
    if isinstance(tree, dict):
        return {k: _map_placed(v, placements[k], fn) for k, v in tree.items()}
    return fn(tree, placements)
