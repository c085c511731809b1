"""Typed interconnect links for configuration transport.

The port's own copy of ``repro/fabric/link.py``: the code is the
reference's, unchanged.

The paper's host model (and the scheduler above it) assumes config
writes land on a *core-local* CSR port: the only cost is host instruction
time. In deployed systems the write crosses an interconnect — a NoC hop to
a far cluster, or a PCIe transaction to a discrete card — whose latency and
bandwidth must show up in ``T_set`` (Eq. 4) and therefore as a ceiling on
the configuration roofline ("Know your rooflines!": transfer terms belong
on the plot, not in a footnote). Colagrande & Benini measure exactly this:
offload cost on a many-cluster MPSoC is dominated by the transport path,
not the accelerator.

Three link classes span the design space:

* :func:`csr_local` — the paper's baseline. Zero latency, infinite
  bandwidth: configuration cost is pure host instruction time, so every
  existing single-host result is reproduced bit-exactly.
* :func:`noc` — an on-chip network hop (or several): a handful of cycles
  of latency per transaction, wide links, a cheap DMA engine.
* :func:`pcie` — off-chip: hundreds of cycles per non-posted transaction,
  narrower effective bandwidth, expensive-but-amortizable DMA bursts.

Each link prices the two transport disciplines ``fabric.transport``
chooses between:

* **MMIO** (:meth:`LinkModel.mmio_cycles`) — one transaction per config
  write; every write pays the full link latency (writes to device registers
  are strongly ordered, so they do not pipeline).
* **Burst DMA** (:meth:`LinkModel.burst_cycles`) — the host programs a
  descriptor (``burst_setup``) and a DMA engine streams the whole register
  image at link bandwidth, paying the latency once per ``max_burst`` bytes.

:class:`LinkPort` adds the *contention* dimension: one link instance shared
by concurrent tenants serializes their transfers FIFO (a transfer occupies
the wire until it completes), and logs every transfer so
``sched.telemetry`` can export per-link busy/occupancy timelines.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

from ..engine.resources import Resource


@dataclass(frozen=True)
class LinkModel:
    """One interconnect class on the config-transport path."""

    name: str
    kind: str  # "csr" | "noc" | "pcie"
    latency: float  # cycles one transaction spends crossing the link
    bandwidth: float  # payload bytes per cycle once streaming
    supports_dma: bool  # is there a DMA engine that can burst descriptors?
    burst_setup: float = 0.0  # cycles to program one DMA burst descriptor
    max_burst: int = 4096  # payload bytes one burst descriptor may carry
    hops: int = 0  # topological distance (0 = core-local)
    # -- energy rates (pJ) — the joule axis the cycle model is blind to.
    # MMIO pays a handshake per ordered write; burst DMA pays a descriptor
    # setup per burst plus a streaming cost per byte. The per-byte cost is
    # shared, so the cycle-cheaper and joule-cheaper mode can differ: burst
    # amortizes *latency* aggressively but its descriptor setup energy can
    # exceed a few MMIO handshakes (transport.plan_fields(objective=...))
    mmio_write_energy: float = 0.0  # pJ per ordered register-write handshake
    byte_energy: float = 0.0  # pJ per payload byte streamed, either mode
    burst_setup_energy: float = 0.0  # pJ to build + launch one DMA descriptor
    # posted-write combining depth: how many config writes the link's write
    # buffer may coalesce into one transaction before it must drain. 0 (the
    # default, every stock link) disables the "wc" transport discipline
    # entirely, so existing MMIO numbers are reproduced bit-exactly.
    wc_depth: int = 0

    def write_cycles(self, nbytes: float) -> float:
        """One ordered register write of ``nbytes`` crossing the link."""
        return self.latency + nbytes / self.bandwidth

    def mmio_cycles(self, n_writes: int, nbytes_per_write: float) -> float:
        """``n_writes`` strongly-ordered register writes — each pays the
        full latency (device MMIO does not pipeline)."""
        return n_writes * self.write_cycles(nbytes_per_write)

    def burst_cycles(self, nbytes: float) -> float:
        """One DMA transfer of ``nbytes``: per-burst descriptor setup and
        latency, then the payload streams at link bandwidth."""
        assert self.supports_dma, f"link {self.name!r} has no DMA engine"
        bursts = max(1, math.ceil(nbytes / self.max_burst))
        return bursts * (self.burst_setup + self.latency) + nbytes / self.bandwidth

    def wc_cycles(self, n_writes: int, nbytes_per_write: float) -> float:
        """``n_writes`` *posted* register writes through a write-combining
        buffer: up to ``wc_depth`` consecutive writes coalesce into one
        transaction, so the link latency is paid once per batch instead of
        once per write, and the payload streams at link bandwidth — MMIO's
        ordering cost partially amortized, the way burst DMA amortizes it
        fully (no descriptor to program, but no deep bursts either)."""
        assert self.wc_depth >= 2, \
            f"link {self.name!r} has no write-combining buffer"
        if n_writes <= 0:
            return 0.0
        batches = math.ceil(n_writes / self.wc_depth)
        return (batches * self.latency
                + n_writes * nbytes_per_write / self.bandwidth)

    def transfer_energy(self, mode: str, nbytes: float,
                        n_writes: int | None = None) -> float:
        """Wire energy (pJ) of moving ``nbytes`` in ``mode``. When the MMIO
        write count is not known (e.g. a migration snapshot priced outside
        ``fabric.transport``), each write is assumed to carry ``max_burst``
        — a lower bound on handshake count. ``transport.TransferSchedule``
        passes the exact count, so launch traffic never takes the guess."""
        if nbytes <= 0:
            return 0.0
        streamed = nbytes * self.byte_energy
        if mode == "burst":
            bursts = max(1, math.ceil(nbytes / self.max_burst))
            return bursts * self.burst_setup_energy + streamed
        if n_writes is None:
            n_writes = max(1, math.ceil(nbytes / self.max_burst))
        if mode == "wc" and self.wc_depth >= 2:
            # one handshake per coalesced batch, not per posted write
            batches = max(1, math.ceil(n_writes / self.wc_depth))
            return batches * self.mmio_write_energy + streamed
        return n_writes * self.mmio_write_energy + streamed


def csr_local() -> LinkModel:
    """Core-local CSR port — the paper's host model. Zero wire cost, so the
    pre-fabric scheduler numbers are reproduced exactly; no DMA engine (a
    core writes its own CSRs faster than it could program a descriptor)."""
    return LinkModel(name="csr", kind="csr", latency=0.0,
                     bandwidth=float("inf"), supports_dma=False, hops=0,
                     mmio_write_energy=0.5, byte_energy=0.05)


def noc(hops: int = 1) -> LinkModel:
    """On-chip network: ~12 cycles of router/wire latency per hop, 8 B/cycle
    links, a lightweight cluster DMA (cf. the Snitch/Occamy iDMA path)."""
    assert hops >= 1
    # energy scales with distance: every hop's router switches per flit
    # (per-byte) and per handshake; the DMA descriptor setup energy is
    # deliberately the expensive term — on-chip it buys little over a few
    # cheap MMIO handshakes, so the joule-optimal crossover sits *later*
    # than the cycle-optimal one (pinned in tests/test_power.py)
    return LinkModel(name=f"noc{hops}" if hops > 1 else "noc", kind="noc",
                     latency=12.0 * hops, bandwidth=8.0, supports_dma=True,
                     burst_setup=24.0, max_burst=1024, hops=hops,
                     mmio_write_energy=6.0 * hops, byte_energy=0.3 * hops,
                     burst_setup_energy=48.0 * hops)


def pcie() -> LinkModel:
    """Off-chip PCIe: non-posted writes cost hundreds of cycles round-trip;
    DMA descriptors are expensive to build but carry 4 KiB bursts."""
    return LinkModel(name="pcie", kind="pcie", latency=350.0, bandwidth=4.0,
                     supports_dma=True, burst_setup=96.0, max_burst=4096,
                     hops=1, mmio_write_energy=150.0, byte_energy=1.0,
                     burst_setup_energy=400.0)


def with_write_combining(link: LinkModel, depth: int = 8) -> LinkModel:
    """The same link with an ``depth``-entry posted-write-combining buffer
    (and a ``_wc`` name suffix). A separate constructor — not a default —
    so every stock link keeps ``wc_depth=0`` and its committed transport
    numbers stay bit-exact."""
    assert depth >= 2, "a write-combining buffer needs ≥ 2 entries"
    return dataclasses.replace(link, name=f"{link.name}_wc", wc_depth=depth)


LINKS: dict[str, LinkModel] = {
    "csr": csr_local(),
    "noc": noc(),
    "noc2": noc(2),
    "pcie": pcie(),
    # write-combining variants: same wire, an 8-deep posted-write buffer
    "noc_wc": with_write_combining(noc()),
    "pcie_wc": with_write_combining(pcie()),
}


def resolve_link(spec: "LinkModel | str | None") -> LinkModel:
    """``None`` → the paper's core-local baseline; a string → ``LINKS``."""
    if spec is None:
        return LINKS["csr"]
    if isinstance(spec, LinkModel):
        return spec
    assert spec in LINKS, f"unknown link {spec!r} (have {sorted(LINKS)})"
    return LINKS[spec]


# -- contention --------------------------------------------------------------


@dataclass(frozen=True)
class Transfer:
    """One completed occupancy of a link."""

    start: float
    end: float
    nbytes: int
    tag: str  # tenant / purpose
    mode: str  # "mmio" | "burst" | "wc"
    energy: float = 0.0  # pJ this transfer burned on the wire

    @property
    def cycles(self) -> float:
        return self.end - self.start


class LinkPort:
    """One shared link instance: concurrent tenants' transfers serialize
    FIFO on the wire, and every occupancy is logged for telemetry.

    The wire is a reservable engine resource (:class:`~repro.engine.resources.Resource`,
    exposed as :attr:`res`): ``sched.Scheduler`` folds it into its
    :class:`~repro.engine.resources.EngineResources` so host, wire, and
    compute occupancy live in one vocabulary. One ``LinkPort`` may be
    shared by *several* hosts (a cluster-level PCIe switch): every
    sharer's config transfers then contend on the same FIFO timeline —
    ``cluster.Cluster.uniform(shared_port=True)`` builds that topology."""

    def __init__(self, link: LinkModel, name: str = "link"):
        self.link = link
        self.name = name
        self.res = Resource(name, kind="wire")
        self.log: list[Transfer] = []
        # observation-only hook (repro.obs.trace): set by the first
        # scheduler that attaches a tracer — always the *unbound* root, so
        # a port shared by several hosts traces under one fabric lane
        self.tracer = None

    @property
    def busy_until(self) -> float:
        """The wire's committed time (the resource's clock)."""
        return self.res.free

    def backlog(self, now: float) -> float:
        """Cycles the wire is already committed beyond ``now``."""
        return self.res.backlog(now)

    def acquire(self, now: float, cycles: float, *, nbytes: int = 0,
                tag: str = "", mode: str = "mmio",
                energy: float | None = None) -> Transfer:
        """Occupy the link for ``cycles`` starting no earlier than ``now``
        (a busy wire pushes the transfer back — bandwidth sharing as FIFO
        serialization). Returns the resolved transfer.

        ``energy`` is the transfer's wire joules; callers that priced the
        transfer (``transport.TransferSchedule``) pass the exact figure so
        the meter reads plan-time numbers verbatim. ``None`` falls back to
        the link's own estimate — migration snapshots and other non-launch
        traffic, where the MMIO write count is not known here."""
        if energy is None:
            energy = self.link.transfer_energy(mode, nbytes)
        iv = self.res.reserve(now, cycles, tag=tag)
        xfer = Transfer(start=iv.start, end=iv.end, nbytes=int(nbytes),
                        tag=tag, mode=mode, energy=float(energy))
        self.log.append(xfer)
        if self.tracer is not None and cycles > 0.0:
            self.tracer.span(mode, "wire", iv.start, iv.end, lane=self.name,
                             tenant=tag, nbytes=int(nbytes))
        return xfer

    # -- observables ---------------------------------------------------------

    @property
    def busy_cycles(self) -> float:
        return sum(t.cycles for t in self.log)

    @property
    def bytes_moved(self) -> int:
        return sum(t.nbytes for t in self.log)

    @property
    def transfer_joules(self) -> float:
        """Total wire energy (pJ) of every logged transfer."""
        return sum(t.energy for t in self.log)

    def occupancy(self, makespan: float) -> float:
        """Fraction of the run the wire was busy."""
        return self.busy_cycles / makespan if makespan else 0.0
