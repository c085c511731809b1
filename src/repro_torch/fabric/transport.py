"""Config-write transport: turn a cache write-plan into a transfer schedule.

The port's own copy of ``repro/fabric/transport.py``: the code is the
reference's, unchanged.

``sched.ConfigStateCache`` decides *what* must cross the host→device
boundary (the delta of a launch's register file); this module decides
*how*. Three disciplines compete, priced against one :class:`~.link.LinkModel`:

* **MMIO** — the host issues one register write per config-write
  instruction, exactly the paper's §2 model: host cycles are
  ``(writes · instrs_per_write + launch_instrs) · host_cpi`` (parameter
  calculation and instruction issue, the T_calc of Eq. 4) and every write
  pays the link's full transaction latency.
* **Burst DMA** — the host packs the register values into a descriptor in
  local memory (~1 store per field, so host cycles shrink to
  ``(n_fields + launch_instrs) · host_cpi``) and a DMA engine streams the
  image in bursts, paying link latency once per burst instead of per write.
* **Write-combined MMIO** (``"wc"``) — on links with a posted-write buffer
  (``LinkModel.wc_depth ≥ 2``): the host issues the same per-register
  writes, but the buffer coalesces up to ``wc_depth`` of them per
  transaction, paying latency once per batch — between the other two, and
  ``None`` (never chosen) on every stock link.

:func:`plan_fields` picks whichever yields the smaller ``T_set``
(host + wire) and reports both, so benchmarks can show the crossover: on a
zero-latency core-local CSR port MMIO always wins (and reproduces the
pre-fabric cost bit-exactly); once writes cross a NoC or PCIe, burst DMA
wins as soon as the plan exceeds a few registers.

The launch command itself also crosses the link (one field-sized write,
matching the existing byte accounting in ``sched.scheduler``).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..core.accelerators import AcceleratorModel
from .link import LinkModel

MODES = ("mmio", "burst", "wc")

# pJ one host control-thread cycle costs while issuing config instructions
# — kept here (not on a PowerSpec) because the transport layer must price a
# schedule's joules at *plan* time, before any scheduler exists; the meter
# (repro.power) uses the same constant so the two can never disagree
HOST_ENERGY_PER_CYCLE = 1.0


@dataclass(frozen=True)
class TransferSchedule:
    """One launch's configuration transfer, fully priced."""

    mode: str  # "mmio" | "burst"
    link: str  # LinkModel.name
    n_fields: int  # register fields crossing the boundary (launch excluded)
    nbytes: int  # config payload on the wire, launch write included
    host_cycles: float  # host instruction time (T_calc + issue)
    link_cycles: float  # time on the wire
    host_energy: float = 0.0  # pJ of host instruction issue
    wire_energy: float = 0.0  # pJ on the wire (handshakes/descriptors+bytes)

    @property
    def t_set(self) -> float:
        """Eq. 4's configuration term for this launch: the host is captive
        for its instruction time and (conservatively) the wire time."""
        return self.host_cycles + self.link_cycles

    @property
    def energy(self) -> float:
        """Configuration energy of this launch, pJ — the joule analogue of
        :attr:`t_set`."""
        return self.host_energy + self.wire_energy

    @property
    def edp(self) -> float:
        """Energy-delay product (pJ·cycles) — the balanced objective."""
        return self.energy * self.t_set


def mmio_schedule(n_fields: int, model: AcceleratorModel,
                  link: LinkModel) -> TransferSchedule:
    """Per-register MMIO: the paper's write discipline over the link."""
    writes = -(-n_fields // model.fields_per_write) if n_fields else 0
    host = (writes * model.instrs_per_write + model.launch_instrs) * model.host_cpi
    payload = model.fields_per_write * model.bytes_per_field
    wire = (link.mmio_cycles(writes, payload)
            + link.write_cycles(model.bytes_per_field))  # the launch write
    nbytes = (n_fields + 1) * model.bytes_per_field
    return TransferSchedule(
        mode="mmio",
        link=link.name,
        n_fields=n_fields,
        nbytes=nbytes,
        host_cycles=host,
        link_cycles=wire,
        host_energy=host * HOST_ENERGY_PER_CYCLE,
        # writes + 1: the launch write is an ordered handshake too
        wire_energy=link.transfer_energy("mmio", nbytes, n_writes=writes + 1),
    )


def burst_schedule(n_fields: int, model: AcceleratorModel,
                   link: LinkModel) -> TransferSchedule | None:
    """Coalesced burst descriptor, or ``None`` when the link has no DMA
    engine. The host touches each field once (a local store into the
    descriptor), then the wire streams the whole image."""
    if not link.supports_dma:
        return None
    host = (n_fields + model.launch_instrs) * model.host_cpi
    nbytes = (n_fields + 1) * model.bytes_per_field
    return TransferSchedule(
        mode="burst",
        link=link.name,
        n_fields=n_fields,
        nbytes=nbytes,
        host_cycles=host,
        link_cycles=link.burst_cycles(nbytes),
        host_energy=host * HOST_ENERGY_PER_CYCLE,
        wire_energy=link.transfer_energy("burst", nbytes),
    )


def wc_schedule(n_fields: int, model: AcceleratorModel,
                link: LinkModel) -> TransferSchedule | None:
    """Write-combined MMIO, or ``None`` on links without a posted-write
    buffer (``wc_depth < 2`` — every stock link, so nothing changes unless
    a ``*_wc`` link is chosen). The host issues the same per-register write
    instructions as MMIO — combining happens in the link's write buffer,
    not in software — but the wire coalesces up to ``wc_depth`` posted
    writes per transaction, paying link latency once per batch: MMIO's
    ordering cost partially amortized without programming a descriptor.
    The launch write is posted too (it drains the final batch)."""
    if link.wc_depth < 2:
        return None
    writes = -(-n_fields // model.fields_per_write) if n_fields else 0
    host = (writes * model.instrs_per_write + model.launch_instrs) * model.host_cpi
    payload = model.fields_per_write * model.bytes_per_field
    nbytes = (n_fields + 1) * model.bytes_per_field
    return TransferSchedule(
        mode="wc",
        link=link.name,
        n_fields=n_fields,
        nbytes=nbytes,
        host_cycles=host,
        link_cycles=link.wc_cycles(writes + 1, payload),
        host_energy=host * HOST_ENERGY_PER_CYCLE,
        # one handshake per coalesced batch; writes + 1 counts the launch
        wire_energy=link.transfer_energy("wc", nbytes, n_writes=writes + 1),
    )


TRANSPORTS = ("auto", "mmio", "burst", "wc")

# what "cheaper" means when mode="auto" compares the two disciplines:
# cycles is the historical (and default) axis; joules and energy-delay
# product can disagree with it, because burst DMA amortizes *latency*
# aggressively while its descriptor setup *energy* is the expensive term
OBJECTIVES = ("cycles", "joules", "edp")

_OBJECTIVE_KEYS = {
    "cycles": lambda s: s.t_set,
    "joules": lambda s: s.energy,
    "edp": lambda s: s.edp,
}


def plan_fields(n_fields: int, model: AcceleratorModel, link: LinkModel,
                mode: str = "auto",
                objective: str = "cycles") -> TransferSchedule:
    """Price an ``n_fields``-register plan. ``mode="auto"`` (the default)
    picks the cheaper of MMIO and burst DMA under ``objective`` — cycles
    (``t_set``, the historical behaviour, default), joules (``energy``),
    or ``edp`` — ties break toward less machinery (MMIO over
    write-combining over burst: no write buffer to drain, no descriptor to
    build). ``"mmio"`` forces per-register writes (the paper's baseline
    discipline, and the doctor's counterfactual knob); ``"burst"`` forces
    the DMA path, falling back to MMIO on links without a DMA engine;
    ``"wc"`` forces write-combined MMIO, falling back likewise on links
    without a posted-write buffer."""
    assert mode in TRANSPORTS, mode
    assert objective in OBJECTIVES, objective
    mmio = mmio_schedule(n_fields, model, link)
    if mode == "mmio":
        return mmio
    if mode == "wc":
        return wc_schedule(n_fields, model, link) or mmio
    burst = burst_schedule(n_fields, model, link)
    if mode == "burst":
        return burst or mmio
    key = _OBJECTIVE_KEYS[objective]
    best = mmio
    for cand in (wc_schedule(n_fields, model, link), burst):
        if cand is not None and key(cand) < key(best):
            best = cand
    return best


def plan_transfer(plan, model: AcceleratorModel, link: LinkModel,
                  objective: str = "cycles") -> TransferSchedule:
    """Price a ``sched.state_cache.WritePlan``'s sent set (duck-typed so
    the fabric layer stays import-free of ``repro.sched``)."""
    return plan_fields(len(plan.sent), model, link, objective=objective)


def crossover_fields(model: AcceleratorModel, link: LinkModel,
                     limit: int = 1024,
                     objective: str = "cycles") -> int | None:
    """Smallest plan size at which burst DMA beats per-register MMIO on
    this (device, link) pair under ``objective`` — ``None`` if MMIO wins
    up to ``limit`` (always the case on a core-local CSR port under
    cycles). The joule crossover sits later than the cycle one wherever
    the descriptor setup energy outweighs a few MMIO handshakes."""
    if not link.supports_dma:
        return None
    key = _OBJECTIVE_KEYS[objective]
    for n in range(1, limit + 1):
        if key(burst_schedule(n, model, link)) < key(mmio_schedule(n, model, link)):
            return n
    return None


def crossover_table(model: AcceleratorModel, link: LinkModel,
                    limit: int = 256,
                    objective: str = "cycles") -> list[tuple[int, str]]:
    """Winning-discipline regimes of ``plan_fields(mode="auto")`` over plan
    sizes 1..``limit``: ``[(n_start, mode), ...]``, one entry per regime
    change. On a write-combining link the table typically reads
    ``[(1, "wc"), (k, "burst")]`` — a few posted writes amortize latency
    without a descriptor, deep register images still want DMA; on stock
    links (``wc_depth=0``) the "wc" regime can never appear, which is the
    bit-exactness guarantee in table form."""
    table: list[tuple[int, str]] = []
    for n in range(1, limit + 1):
        mode = plan_fields(n, model, link, objective=objective).mode
        if not table or table[-1][1] != mode:
            table.append((n, mode))
    return table
