"""Runtime configuration–computation overlap (the §5.5 pass, at dispatch).

The port's own copy of ``repro/engine/overlap.py``: the code is the
reference's, unchanged.

The compiler half of the system (``core.passes.overlap``) hides T_set
*statically*: for concurrent-configuration targets it pipelines loops so
iteration ``i+1``'s setup runs while iteration ``i`` computes. This module
is the runtime twin. A scheduler dispatching launch N+1 while launch N's
macro-op is still running faces the same opportunity — and, without this
policy, wastes it: the serialized discipline keeps the host captive for the
wire time of its own config transfers.

Two modes, selected per scheduler:

* **serialized** — the pre-engine behavior, reproduced bit-exactly: the
  host reserves its instruction time, the transfer follows on the wire, and
  the host stays captive until the wire completes (``T_set`` is fully
  host-visible, Eq. 4's worst case).
* **overlapped** — double-buffered staging: when the transfer is an async
  **burst DMA** (the link has a DMA engine and the transport layer picked
  burst) onto a **concurrent-configuration** device, the host is released
  the moment the descriptor is enqueued (its instruction time only); the
  DMA engine streams the register image behind the accelerator's compute.
  Per-register MMIO stays captive even in overlapped mode — ordered device
  stores complete synchronously on the host — and sequential-configuration
  devices (Gemmini) cannot overlap at all (§2.2: the host stalls through
  the macro-op), exactly the asymmetry the paper measures.

**Double buffering.** The device holds ``buffers`` configuration banks
(default 2: active + shadow). A launch's bank is occupied from its
transfer's start until its macro-op *retires* — the active image drives the
datapath — so the async transfer for launch *k* may start no earlier than
the retirement of launch *k − buffers*. With two banks, launch N+1's write
plan streams while launch N computes (the §5.5 picture), and launch N+2's
must wait for N to retire. The config-complete edge is an invariant the
scheduler enforces: a launch's compute may not start before its transfer
ends (``StagePlan.config_done``), the runtime equivalent of the pass's
"staged fields are never observed by an earlier launch" soundness rule.
"""

from __future__ import annotations

from dataclasses import dataclass

from .resources import Resource

OVERLAP_MODES = ("serialized", "overlapped")

# transfer disciplines that release the host before the wire completes:
# burst DMA (descriptor enqueue, engine streams) and write-combined MMIO
# (posted writes land in the link's write buffer and drain behind the
# host). Plain MMIO is never here — ordered device stores complete
# synchronously.
ASYNC_XFER_MODES = ("burst", "wc")


@dataclass(frozen=True)
class StagePlan:
    """One launch's configuration placed onto the engine resources."""

    host_start: float  # control thread begins this launch's config work
    host_busy: float  # host instruction cycles (T_calc + issue)
    wire_start: float  # transfer begins on the wire
    config_done: float  # every register on-device; compute may not start earlier
    host_release: float  # host clock after config (captive through the wire
    #                      when synchronous; descriptor-enqueue when async)
    asynchronous: bool  # wire streamed behind the host (burst DMA) or captive


class OverlapPolicy:
    """Places each launch's config transfer: captive (serialized) or
    double-buffered async staging (overlapped)."""

    def __init__(self, mode: str = "serialized", buffers: int = 2):
        assert mode in OVERLAP_MODES, mode
        assert buffers >= 1, buffers
        self.mode = mode
        self.buffers = buffers
        # observation-only hook (repro.obs.trace): the owning scheduler
        # attaches its tracer so async staging decisions leave markers
        self.tracer = None
        # per device: (total launches committed, trailing retirement times
        # in dispatch order). Transfer k's bank wait is bounded by the
        # retirement of launch k-buffers, so only the trailing window is
        # kept — `buffers + 1` entries, one of slack because a preemption
        # (`preempted`) pops the newest entry between two commits
        self._committed: dict[str, int] = {}
        self._retired: dict[str, list[float]] = {}

    # -- queries --------------------------------------------------------------

    def is_async(self, concurrent: bool, xfer) -> bool:
        """Would this transfer stream behind the host? Burst DMA or posted
        write-combining onto a concurrent-configuration device with actual
        wire time to hide (:data:`ASYNC_XFER_MODES`)."""
        return (self.mode == "overlapped" and concurrent
                and xfer.mode in ASYNC_XFER_MODES and xfer.link_cycles > 0.0)

    def exposed_cost(self, concurrent: bool, xfer) -> float:
        """Host-visible cycles of this transfer — the placement-probe term.
        Async staging exposes only the host's instruction time; a captive
        transfer exposes the full ``T_set`` (host + wire)."""
        return xfer.host_cycles if self.is_async(concurrent, xfer) else xfer.t_set

    def bank_free(self, dev_id: str) -> float:
        """Earliest time a configuration bank frees on this device: the
        retirement of the launch ``buffers`` dispatches back."""
        total = self._committed.get(dev_id, 0)
        if total < self.buffers:
            return 0.0
        retired = self._retired[dev_id]
        # the trailing window holds launches [total - len(retired), total)
        return retired[len(retired) - self.buffers]

    # -- staging --------------------------------------------------------------

    def stage(self, *, dev_id: str, concurrent: bool, xfer, host: Resource,
              port, issue: float, tag: str = "") -> StagePlan:
        """Reserve the host and the wire for one launch's configuration.

        ``xfer`` is the fabric :class:`~repro.fabric.transport.TransferSchedule`
        (mode already chosen by cost); ``port`` the (possibly shared)
        :class:`~repro.fabric.link.LinkPort` whose wire resource the
        transfer occupies. Returns where everything landed; the caller
        submits compute no earlier than ``config_done`` and advances the
        host clock to ``host_release``.
        """
        h = host.reserve(issue, xfer.host_cycles, tag=tag)
        asynchronous = self.is_async(concurrent, xfer)
        earliest = h.end
        if asynchronous:
            # the shadow bank must be free before the DMA may fill it
            earliest = max(earliest, self.bank_free(dev_id))
        w = port.acquire(earliest, xfer.link_cycles, nbytes=xfer.nbytes,
                         tag=tag, mode=xfer.mode,
                         energy=getattr(xfer, "wire_energy", None))
        release = h.end if asynchronous else max(h.end, w.end)
        if self.tracer is not None and asynchronous:
            # the host was released at descriptor enqueue; note how long
            # the DMA then waited for a free shadow bank (double buffering)
            self.tracer.instant("async-stage", h.end, lane="host",
                                device=dev_id, tenant=tag,
                                bank_wait=max(0.0, earliest - h.end))
        return StagePlan(
            host_start=h.start,
            host_busy=xfer.host_cycles,
            wire_start=w.start,
            config_done=w.end,
            host_release=release,
            asynchronous=asynchronous,
        )

    def committed(self, dev_id: str, retire: float) -> None:
        """Record a staged launch's retirement time (frees its bank for
        the launch ``buffers`` dispatches ahead)."""
        retired = self._retired.setdefault(dev_id, [])
        retired.append(retire)
        self._committed[dev_id] = self._committed.get(dev_id, 0) + 1
        if len(retired) > self.buffers + 1:
            del retired[0]  # older entries can never bound a future transfer

    def preempted(self, dev_id: str) -> None:
        """Forget the newest commitment on a device — its staged launch
        was cancelled before starting, so its bank frees immediately."""
        retired = self._retired.get(dev_id)
        if retired:
            retired.pop()
            self._committed[dev_id] -= 1
