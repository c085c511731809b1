"""The three-resource occupancy model of a configuration engine.

The port's own copy of ``repro/engine/resources.py``: the code is the
reference's, unchanged.

Until now the runtime smeared one *implicit* timeline across four layers:
``sched.Scheduler`` bumped a scalar host clock, ``fabric.LinkPort`` kept its
own ``busy_until``, ``sched.LaunchQueue`` its own ``device_free``, and
``cluster.Host`` re-derived a backlog estimate from all three with a bespoke
max/half-open formula. This module makes the model explicit: a launch's
configuration occupies **three distinct, serially-contended resources** —

* the **host** control thread (parameter calculation, descriptor build,
  write/launch instruction issue — the T_calc side of Eq. 4),
* the **wire** (the config DMA engine / interconnect transaction path —
  the transfer side of T_set that `repro.fabric` prices), and
* the accelerator's **compute** datapath (macro-op execution).

Colagrande & Benini's offload-overhead analysis makes the same cut at the
MPSoC level: issue, transfer, and execution are separate contended
resources, and setup only streams behind execution once they are modeled
separately. Each :class:`Resource` is FIFO — a reservation starts at
``max(earliest, free)`` — which is exactly the discipline every layer
already assumed; the refactor changes *where the intervals live* (one
queryable log per resource), not what they cost. The serialized engine mode
therefore reproduces the pre-refactor cycle counts bit-exactly, while the
overlapped mode (``engine.overlap``) gets the vocabulary it needs to place
a wire transfer *behind* compute instead of inside the host's captive time.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable

RESOURCE_KINDS = ("host", "wire", "compute", "resource")


@dataclass(frozen=True)
class Interval:
    """One busy occupancy of a resource."""

    start: float
    end: float
    tag: str = ""  # tenant / purpose

    @property
    def cycles(self) -> float:
        return self.end - self.start


class Resource:
    """One serially-occupied engine resource with a busy-interval log.

    Reservations are FIFO: a request placed with ``earliest`` starts at
    ``max(earliest, free)`` and pushes ``free`` to its end — the same
    discipline the scalar host clock, ``LinkPort.busy_until`` and
    ``LaunchQueue.device_free`` each implemented privately before. The log
    keeps every interval (zero-length ones included, so transfer *counts*
    survive on zero-cost links), which is what telemetry, the overlap
    accounting, and ``port_wait`` queries read.

    Two mutations besides :meth:`reserve`:

    * :meth:`advance` — move ``free`` forward *without* logging busy time:
      captive waiting (a host stalled on a wire or a macro-op) and open-loop
      idling are occupancy of nothing; they must not inflate busy cycles, or
      the serialized↔overlapped conservation invariant breaks.
    * :meth:`pop_last` — un-log the newest interval (a preempted staged
      launch whose macro-op never ran); the caller restores ``free``.
    """

    def __init__(self, name: str, kind: str = "resource"):
        assert kind in RESOURCE_KINDS, kind
        self.name = name
        self.kind = kind
        self.free = 0.0  # committed time: the clock of this resource
        self.log: list[Interval] = []
        # optional repro.power.EnergyModel attached by the scheduler when a
        # PowerSpec is in play — observation-only (never consulted by any
        # reserve/when/backlog path), read by the energy meter and the
        # windowed power monitor
        self.energy = None

    # -- queries (side-effect free) ------------------------------------------

    def when(self, earliest: float, duration: float) -> Interval:
        """Where a reservation *would* land, without taking it — the probe
        primitive placement scoring uses."""
        start = max(earliest, self.free)
        return Interval(start, start + duration)

    def backlog(self, now: float) -> float:
        """Cycles this resource is already committed beyond ``now``. The
        interval is half-open ``[start, end)``: work completing at exactly
        ``now`` holds the resource for zero further cycles."""
        return max(0.0, self.free - now)

    @property
    def busy_cycles(self) -> float:
        return sum(iv.cycles for iv in self.log)

    def overlap_with(self, start: float, end: float) -> float:
        """Cycles of ``[start, end)`` already covered by this resource's
        busy intervals — the quantum of *hiding*: a wire transfer's overlap
        with its device's compute intervals is exactly the config time the
        runtime kept off the critical path.

        FIFO reservations make both starts and ends non-decreasing in log
        order, so the scan walks backward and stops at the first interval
        ending at or before the window — O(overlapping intervals), not
        O(log length), keeping the per-dispatch query cheap on long runs."""
        total = 0.0
        for iv in reversed(self.log):
            if iv.end <= start:
                break  # every earlier interval ends no later
            if iv.start < end:
                covered = min(end, iv.end) - max(start, iv.start)
                if covered > 0.0:
                    total += covered
        return total

    def intervals(self) -> list[tuple[float, float, str]]:
        """(start, end, tag) in reservation order — renderable beside
        device gantts on one time axis."""
        return [(iv.start, iv.end, iv.tag) for iv in self.log]

    # -- mutations ------------------------------------------------------------

    def reserve(self, earliest: float, duration: float, tag: str = "") -> Interval:
        """Occupy the resource FIFO starting no earlier than ``earliest``."""
        assert duration >= 0.0, duration
        iv = self.when(earliest, duration)
        iv = Interval(iv.start, iv.end, tag)
        self.free = iv.end
        self.log.append(iv)
        return iv

    def advance(self, to: float) -> None:
        """Commit the resource's clock forward without logging busy time
        (captive stall or open-loop idle — occupancy of nothing)."""
        self.free = max(self.free, to)

    def pop_last(self) -> Interval | None:
        """Un-log the newest interval (preemption); the caller is
        responsible for restoring ``free`` to the machine's real state."""
        return self.log.pop() if self.log else None


def merge_intervals(intervals: Iterable[tuple]) -> list[tuple[float, float]]:
    """Union of ``(start, end, ...)`` intervals as disjoint sorted spans."""
    spans = sorted((iv[0], iv[1]) for iv in intervals if iv[1] > iv[0])
    merged: list[tuple[float, float]] = []
    for lo, hi in spans:
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def overlap_cycles(a: Iterable[tuple], b: Iterable[tuple]) -> float:
    """Cycles covered by both ``(start, end, ...)`` interval sequences —
    e.g. wire∩compute is the config time that hid. Each side is unioned
    first, so overlapping members (two devices computing at once) never
    double-count the same wall-clock cycle; the merged spans are sorted
    and disjoint, so one two-pointer sweep covers both lists."""
    sa, sb = merge_intervals(a), merge_intervals(b)
    total, i, j = 0.0, 0, 0
    while i < len(sa) and j < len(sb):
        lo = max(sa[i][0], sb[j][0])
        hi = min(sa[i][1], sb[j][1])
        if hi > lo:
            total += hi - lo
        # advance whichever span ends first — the other may still overlap
        if sa[i][1] <= sb[j][1]:
            i += 1
        else:
            j += 1
    return total


class EngineResources:
    """The three resources one scheduler (one host shard) dispatches onto.

    ``host`` and ``wire`` are single instances; ``compute`` is per device.
    The wire resource is *shared with* the fabric :class:`~repro.fabric.link.LinkPort`
    (the port reserves through it), so a cluster-level port shared by
    several hosts makes every sharer's config transfers contend on one
    timeline — the PCIe-switch model.
    """

    def __init__(self, host: Resource, wire: Resource,
                 compute: dict[str, Resource]):
        assert host.kind == "host" and wire.kind == "wire"
        self.host = host
        self.wire = wire
        self.compute = dict(compute)

    def all(self) -> dict[str, Resource]:
        out = {self.host.name: self.host, self.wire.name: self.wire}
        for res in self.compute.values():
            out[res.name] = res
        return out

    def port_wait(self, now: float) -> float:
        """Cycles a request arriving at ``now`` waits before its first
        config write can start on this engine — the later of the host
        control thread's and the wire's committed time. The two combine by
        ``max()``, never ``+``: a serialized host is captive for its own
        transfers, so the in-flight transfer is already inside the host
        clock and summing would double-count it; under overlap the wire can
        outrun the host and the wire term bites on its own. Both backlogs
        are half-open ``[start, end)`` queries (:meth:`Resource.backlog`).

        Note: *hidden* config accounting deliberately does **not** live
        here — a wire transfer only hides behind its own target device's
        compute, and only when asynchronous, so the authoritative numbers
        are the per-launch ``exposed_config`` the scheduler computes at
        dispatch (``DeviceTelemetry.exposed_config_cycles``)."""
        return max(0.0, self.host.backlog(now), self.wire.backlog(now))
