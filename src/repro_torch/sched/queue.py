"""Launch queues: admission ordering and depth-k staged dispatch timing.

The port's own copy of ``repro/sched/queue.py``: the code is the
reference's, unchanged.

**Admission** (:class:`AdmissionQueue`): the order in which an open-loop
drain hands arrived requests to the scheduler — plain arrival order (ties
to higher priority), earliest-deadline-first over whatever has already
arrived, or cache-warmth-aware (``"warm"``: warm residents drain ahead of
cold tenants, bounded by each cold request's deadline slack). EDF only
reorders the *backlog*: with no backlog (or no deadlines set) it degrades
to the priority-class order, so best-effort traffic is unaffected.

**Staging** (:class:`LaunchQueue`): per-device dispatch timing.

Models the two configuration disciplines the paper characterizes, per
device, against a single host clock owned by the scheduler:

* **Sequential** (Gemmini, §2.2): the host stalls at launch until the
  macro-op retires. ``depth`` is irrelevant — there is never more than one
  invocation outstanding.
* **Concurrent** (OpenGeMM, §6.2): launches are *staged*; the host returns
  immediately and keeps configuring the next invocation while the device
  runs. Up to ``depth`` launches may be outstanding (the size of the staging
  register file / descriptor ring); when the ring is full the host blocks
  until the oldest invocation retires. ``depth=1`` degenerates to the
  interpreter's launch-blocks-until-free model; larger depths are the
  OpenGeMM-style ring that `dispatch.ConcurrentExecutor` realizes on the
  real JAX runtime.

Staged launches that have not yet *started* are preemptible: a
higher-priority request can cancel the newest staged entry
(:meth:`LaunchQueue.preempt_tail`) and take its ring slot — the scheduler
re-dispatches the victim afterwards. A macro-op that already began is never
aborted; only staging-register state is discarded.

The queue only does *timing*; byte accounting lives in the state cache and
placement lives in the scheduler.
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
from dataclasses import dataclass
from typing import Any, Iterable

from ..core.accelerators import AcceleratorModel
from ..engine.resources import Resource

ADMISSION_MODES = ("arrival", "edf", "warm")


def arrival_order(req) -> tuple[float, int, str]:
    """Admission sort key for open-loop drains — arrival time, ties to
    higher priority, then tenant for determinism. Shared by
    :meth:`Scheduler.run_open_loop` and ``cluster.Cluster.run`` so
    single-host and cluster runs admit identical traces identically."""
    return (req.arrival_time, -req.priority, req.tenant)


def edf_order(req) -> tuple[float, int, float, str]:
    """Earliest-deadline-first key over *arrived* requests. Requests
    without a deadline sort last (deadline = +inf), falling back to the
    priority-class order — a stream with no deadlines set behaves exactly
    like the priority scheduler."""
    deadline = getattr(req, "deadline", None)
    return (deadline if deadline is not None else float("inf"),
            -req.priority, req.arrival_time, req.tenant)


class AdmissionQueue:
    """Open-loop admission buffer: hands the scheduler its next request.

    ``mode="arrival"`` reproduces the classic drain (arrival order, ties to
    higher priority). ``mode="edf"`` admits everything that has arrived by
    the host clock and pops the earliest deadline among it — under a
    backlog (e.g. a burst episode), tight-deadline requests overtake loose
    ones they arrived behind.

    ``mode="warm"`` is cache-warmth-aware admission: among arrived
    requests, one whose tenant is *warm* (``warmth(req)`` — typically: a
    device cache still holds its context, so its config bytes elide) is
    admitted ahead of cold ones, letting a warm resident drain before a
    cold tenant forces a context turnover. The deferral is bounded by each
    cold request's deadline: once its slack (``deadline − now``) falls to
    ``warm_slack`` or below it jumps ahead of every non-urgent request —
    warmth batching must never buy config bytes with deadline misses.
    Within a class (urgent / warm / cold), EDF order applies."""

    def __init__(self, requests: Iterable, mode: str = "arrival", *,
                 warmth=None, warm_slack: float = 0.0):
        assert mode in ADMISSION_MODES, mode
        assert mode != "warm" or warmth is not None, \
            "mode='warm' needs a warmth(req) predicate"
        self.mode = mode
        self.warmth = warmth
        self.warm_slack = warm_slack
        self._future = deque(sorted(requests, key=arrival_order))
        self._ready: list[tuple] = []  # heap of (edf key, seq, request)
        self._seq = itertools.count()

    def __len__(self) -> int:
        return len(self._future) + len(self._ready)

    def _admit_until(self, t: float) -> None:
        while self._future and self._future[0].arrival_time <= t:
            req = self._future.popleft()
            heapq.heappush(self._ready, (edf_order(req), next(self._seq), req))

    def pop(self, now: float):
        """The next request to dispatch given host clock ``now``."""
        assert len(self), "pop from an empty admission queue"
        if self.mode == "arrival":
            return self._future.popleft()
        self._admit_until(now)
        if not self._ready:
            # the host is idle ahead of traffic: jump to the next arrival
            # instant and let everything landing there compete on deadline
            self._admit_until(self._future[0].arrival_time)
        if self.mode == "edf":
            return heapq.heappop(self._ready)[-1]
        return self._pop_warm(now)

    def _pop_warm(self, now: float):
        """Warmth-aware selection over the ready set: urgent (deadline
        slack ≤ ``warm_slack``) beats warm beats cold, EDF order within a
        class. A cold-only backlog drains in plain EDF order — warmth never
        idles the host waiting for a warm arrival that isn't here."""
        best_i = best_rank = None
        for i, (key, seq, req) in enumerate(self._ready):
            deadline = getattr(req, "deadline", None)
            urgent = deadline is not None and deadline - now <= self.warm_slack
            rank = (0 if urgent else 1,
                    0 if self.warmth(req) else 1,
                    key, seq)
            if best_rank is None or rank < best_rank:
                best_i, best_rank = i, rank
        chosen = self._ready.pop(best_i)[-1]
        heapq.heapify(self._ready)  # pop from the middle broke the heap
        return chosen


@dataclass(frozen=True)
class LaunchTiming:
    """One invocation's resolved timeline."""

    host_after: float  # host clock after the launch was issued
    start: float  # device begins the macro-op
    end: float  # macro-op retires
    stall: float  # host cycles spent blocked on this launch


@dataclass(frozen=True)
class Staged:
    """One entry in the staging ring."""

    start: float  # device time the macro-op begins
    end: float  # device time it retires
    priority: int = 0
    token: Any = None  # opaque scheduler handle (the LaunchRequest)


class LaunchQueue:
    """Launch staging for one device instance.

    The device's compute datapath is an engine resource
    (:class:`~repro.engine.resources.Resource`): every submitted macro-op
    reserves a busy interval on it, so ``device_free`` is the resource's
    clock and the scheduler's occupancy model (``EngineResources``) reads
    compute timelines straight from here."""

    def __init__(self, model: AcceleratorModel, depth: int = 2,
                 name: str = ""):
        assert depth >= 1
        self.model = model
        self.depth = depth if model.concurrent else 1
        self.compute = Resource(f"compute[{name or model.name}]",
                                kind="compute")
        self._inflight: deque[Staged] = deque()  # unretired invocations

    @property
    def device_free(self) -> float:
        """Device time the datapath is committed through (resource clock)."""
        return self.compute.free

    @property
    def outstanding(self) -> int:
        return len(self._inflight)

    def backlog(self, host: float) -> float:
        """Cycles the device is already committed beyond ``host`` — the
        load-balance term of the placement score."""
        return max(0.0, self.device_free - host)

    def admission_delay(self, host: float) -> float:
        """Cycles the *host* would block if it launched now (queue-full wait
        for concurrent devices; full occupancy for sequential ones).

        Pure query: the scheduler probes candidate devices with hypothetical
        future timestamps while scoring placements, so nothing may retire
        here — only ``submit`` advances queue state."""
        if not self.model.concurrent:
            return self.backlog(host)
        live = [s.end for s in self._inflight if s.end > host]
        if len(live) < self.depth:
            return 0.0
        return live[len(live) - self.depth] - host

    def tail(self) -> Staged | None:
        """The newest staged entry (the only preemptible one)."""
        return self._inflight[-1] if self._inflight else None

    def preempt_tail(self, host: float, priority: int) -> Staged | None:
        """Cancel the newest staged launch iff it has not yet started at
        ``host`` and its priority is strictly below ``priority``. Returns
        the cancelled entry (its ``token`` lets the scheduler re-dispatch
        the victim) or ``None`` when nothing is preemptible."""
        if not self.model.concurrent or not self._inflight:
            return None
        victim = self._inflight[-1]
        if victim.start <= host or victim.priority >= priority:
            return None
        self._inflight.pop()
        self.compute.pop_last()  # the victim's macro-op never ran
        # the device is committed only through the previous entry now; if the
        # ring emptied, it runs no later than the victim would have started
        self.compute.free = (
            self._inflight[-1].end if self._inflight else victim.start
        )
        return victim

    def _retire(self, host: float) -> None:
        while self._inflight and self._inflight[0].end <= host:
            self._inflight.popleft()

    def submit(self, host: float, duration: float, *, priority: int = 0,
               token: Any = None, ready: float = 0.0) -> LaunchTiming:
        """Issue a launch at host time ``host``; returns the resolved timing
        and the new host clock. ``ready`` is the config-complete edge: the
        macro-op may not start before its register image is fully on-device
        (an async overlapped transfer finishing after the host released —
        0.0 for serialized configuration, where the host clock already
        covers the transfer)."""
        t0 = host
        if self.model.concurrent:
            self._retire(host)
            # staging ring full: block until the oldest staged op frees a slot
            while len(self._inflight) >= self.depth:
                host = max(host, self._inflight.popleft().end)
        # sequential configuration keeps the host captive until retirement;
        # either way the datapath reservation is FIFO on the compute resource
        iv = self.compute.reserve(max(host, ready), duration,
                                  tag=getattr(token, "tenant", ""))
        start, end = iv.start, iv.end
        if self.model.concurrent:
            self._inflight.append(Staged(start, end, priority, token))
        else:
            host = end
        return LaunchTiming(host_after=host, start=start, end=end, stall=host - t0)

    def drain(self, host: float) -> float:
        """Host time once every staged invocation has retired."""
        self._inflight.clear()
        return max(host, self.device_free)
