"""Scheduled launch executor: staged launches plus descriptor dedup.

The counterpart of ``repro/dispatch/executor.py``'s
:class:`ScheduledExecutor`. Each launch descriptor (a tree of dicts, lists
and leaves) flows through a :class:`~repro_torch.sched.state_cache.ConfigStateCache`:
fields bit-identical to the previous launch are elided from the traffic
accounting — they are device-resident state, exactly like an unwritten
configuration register. The device still sees the full argument tree; what
the report splits out is how many descriptor bytes needed to cross the
host→device boundary.

PyTorch dispatches CUDA work asynchronously, as JAX does. The staging ring
holds one CUDA event per launch, recorded on the current stream after the
launch; when the ring holds more than ``depth`` launches the oldest event is
synchronised. Launches on CPU tensors finish before they return, so their
ring entries are empty.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass

import torch

from repro_torch.sched.state_cache import ConfigStateCache, elision_ratio, nbytes_of


@dataclass
class ExecReport:
    wall_s: float
    host_prep_s: float
    steps: int
    bytes_per_step: float
    bytes_elided_per_step: float = 0.0  # descriptor bytes the cache kept off the wire

    @property
    def steps_per_s(self) -> float:
        return self.steps / self.wall_s if self.wall_s else 0.0

    @property
    def elision_ratio(self) -> float:
        return elision_ratio(self.bytes_per_step, self.bytes_elided_per_step)


def flatten_with_path(tree, prefix: str = "") -> list[tuple[str, object]]:
    """Leaves of a tree of dicts, lists and tuples with their key paths,
    spelt and ordered as ``jax.tree_util.tree_flatten_with_path`` and
    ``keystr`` do: dict keys sorted, ``"['positions']"``, ``"[0]"``; ``None``
    is an empty subtree. The order fixes the descriptor's field order and
    with it the byte accounting."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree)
                for leaf in flatten_with_path(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, v in enumerate(tree)
                for leaf in flatten_with_path(v, f"{prefix}[{i}]")]
    if tree is None:
        return []
    return [(prefix, tree)]


class _UnreadyLeaf:
    """Placeholder for a descriptor leaf still being computed on-device:
    carries its wire size but never compares equal, so accounting stays
    conservative (counted as sent) without ever forcing a sync."""

    __slots__ = ("nbytes",)

    def __init__(self, nbytes: int):
        self.nbytes = nbytes


def _host_view(v):
    """Host-side bit-stable view of a descriptor leaf. A CUDA tensor whose
    stream has not reached it yet is left opaque — the cache comparison must
    never block the pipeline it is measuring."""
    if not isinstance(v, torch.Tensor):
        return v
    if v.is_cuda:
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(v.device))
        if not ready.query():
            return _UnreadyLeaf(v.numel() * v.element_size())
    v = v.detach().cpu()
    if v.dtype == torch.bfloat16:  # numpy has no bfloat16: compare the bits
        v = v.view(torch.int16)
    return v.numpy()


def _leaf_bytes(name, v) -> int:
    return v.nbytes if isinstance(v, _UnreadyLeaf) else nbytes_of(v)


def _on_cuda(tree) -> bool:
    return any(isinstance(v, torch.Tensor) and v.is_cuda
               for _, v in flatten_with_path(tree))


class ScheduledExecutor:
    """Concurrent staging + runtime descriptor deduplication.

    Two entry points: the batch :meth:`run` loop (``host_prep`` builds each
    step's descriptor), and the incremental :meth:`launch` API that stateful
    callers — ``serving.ServingEngine``'s decode loop — drive one launch at
    a time while the executor keeps the staging ring and the traffic
    accounting. ``host_prep`` may be ``None`` for incremental use.
    """

    def __init__(self, device_fn, host_prep=None, depth: int = 2,
                 tenant: str = "exec", sync_fn=None):
        self.device_fn = device_fn
        self.host_prep = host_prep
        self.depth = depth
        self.tenant = tenant
        # what decides whether a launch ran on the card: a sub-tree of
        # device_fn's return (the serving engine picks the per-launch output)
        self.sync_fn = sync_fn or (lambda out: out)
        self.cache = ConfigStateCache(max_contexts=1, bytes_of=_leaf_bytes)
        self._inflight: deque = deque()
        self._steps = 0
        self._prep_s = 0.0
        self._sent = 0
        self._elided = 0

    @property
    def launches(self) -> int:
        return self._steps

    def launch(self, state, args):
        """One staged launch: route ``args`` through the descriptor cache,
        dispatch asynchronously, and block only when the staging ring
        exceeds ``depth`` — returns whatever ``device_fn`` returned, still
        in flight.

        No-aliasing contract: numpy leaves of ``args`` are cached by
        reference, so callers must not mutate a leaf in place between
        launches (pass a fresh array or a copy, as the serving engine's
        descriptors do) — otherwise the changed field compares equal to
        itself and is misreported as elided."""
        tp = time.perf_counter()
        # the cache comparison is host descriptor work: count it as prep
        # (T_calc), and compare host-side views so accounting never forces
        # a device sync mid-pipeline
        plan = self.cache.dispatch(
            self.tenant, {k: _host_view(v) for k, v in flatten_with_path(args)})
        self._prep_s += time.perf_counter() - tp
        self._sent += plan.bytes_sent
        self._elided += plan.bytes_elided
        state = self.device_fn(state, args)  # async dispatch: returns early
        done = None
        if _on_cuda(self.sync_fn(state)):
            done = torch.cuda.Event()
            done.record()
        self._inflight.append(done)
        if len(self._inflight) > self.depth:
            self._retire()
        self._steps += 1
        return state

    def _retire(self) -> None:
        done = self._inflight.popleft()
        if done is not None:
            done.synchronize()

    def drain(self) -> None:
        """Retire every staged launch (end-of-run / engine idle barrier)."""
        while self._inflight:
            self._retire()

    def report(self, wall_s: float) -> ExecReport:
        """Cumulative traffic split over every launch so far."""
        n = max(self._steps, 1)
        return ExecReport(wall_s, self._prep_s, self._steps,
                          self._sent / n, self._elided / n)

    def run(self, state, n_steps: int) -> tuple[object, ExecReport]:
        t0 = time.perf_counter()
        steps0, sent0, elided0, prep0 = (self._steps, self._sent,
                                         self._elided, self._prep_s)
        for step in range(n_steps):
            tp = time.perf_counter()
            args = self.host_prep(step)
            self._prep_s += time.perf_counter() - tp
            state = self.launch(state, args)
        self.drain()
        wall = time.perf_counter() - t0
        n = max(n_steps, 1)
        return state, ExecReport(
            wall, self._prep_s - prep0, self._steps - steps0,
            (self._sent - sent0) / n, (self._elided - elided0) / n,
        )
