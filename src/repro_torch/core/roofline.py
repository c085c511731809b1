"""The Configuration Roofline Model (§4, Eqs. 1–5).

The port's own copy of ``repro/core/roofline.py``: the code is the
reference's, unchanged.

Implements, verbatim:

* Eq. 1 — classical processor roofline: ``min(P_peak, BW_mem × I_op)``.
* Eq. 2 — concurrent configuration roofline: ``min(P_peak, BW_cfg × I_OC)``.
* Eq. 3 — sequential configuration roofline (harmonic composition):
  ``1 / (1/P_peak + 1/(BW_cfg × I_OC))``.
* Eq. 4 — effective configuration bandwidth:
  ``N_cfg_bytes / (T_calc + T_set)``.
* Eq. 5 — the combined "roofsurface":
  ``min(P_peak, BW_mem × I_op, BW_cfg × I_OC)``.

Also ships the §4.6 Gemmini worked example as executable constants, which the
test suite asserts against the paper's published 41.49% / 26.78% utilization
numbers.
"""

from __future__ import annotations

from dataclasses import dataclass


def processor_roofline(p_peak: float, bw_mem: float, i_op: float) -> float:
    """Eq. 1 — attainable performance under the classical roofline."""
    return min(p_peak, bw_mem * i_op)


def concurrent_config_roofline(p_peak: float, bw_config: float, i_oc: float) -> float:
    """Eq. 2 — attainable performance with concurrent configuration."""
    return min(p_peak, bw_config * i_oc)


def sequential_config_roofline(p_peak: float, bw_config: float, i_oc: float) -> float:
    """Eq. 3 — attainable performance with sequential configuration."""
    if i_oc == float("inf"):
        return p_peak
    return 1.0 / (1.0 / p_peak + 1.0 / (bw_config * i_oc))


def effective_config_bandwidth(n_config_bytes: float, t_calc: float, t_set: float) -> float:
    """Eq. 4 — configuration bandwidth degraded by parameter calculation."""
    return n_config_bytes / (t_calc + t_set)


def roofsurface(
    p_peak: float, bw_mem: float, i_op: float, bw_config: float, i_oc: float
) -> float:
    """Eq. 5 — the combined processor + configuration roofline."""
    return min(p_peak, bw_mem * i_op, bw_config * i_oc)


def config_bound(p_peak: float, bw_config: float, i_oc: float) -> bool:
    """A workload is configuration-bound when the config term minimizes Eq. 2
    — i.e. it sits left of the knee point (§4.2)."""
    return bw_config * i_oc < p_peak


def knee_point(p_peak: float, bw_config: float) -> float:
    """The I_OC at which configuration and computation take equal time."""
    return p_peak / bw_config


@dataclass(frozen=True)
class RooflinePoint:
    """One measurement on the configuration roofline plot (Figure 12)."""

    name: str
    i_oc: float
    performance: float  # ops/cycle
    p_peak: float
    bw_config: float

    @property
    def bound(self) -> str:
        return "configuration" if config_bound(self.p_peak, self.bw_config, self.i_oc) else "compute"

    @property
    def attainable_sequential(self) -> float:
        return sequential_config_roofline(self.p_peak, self.bw_config, self.i_oc)

    @property
    def attainable_concurrent(self) -> float:
        return concurrent_config_roofline(self.p_peak, self.bw_config, self.i_oc)

    @property
    def utilization(self) -> float:
        return self.performance / self.p_peak


def host_roofline_point(
    name: str,
    *,
    total_ops: float,
    config_bytes: float,
    config_cycles: float,
    makespan: float,
    p_peak: float,
    calc_cycles: float = 0.0,
) -> RooflinePoint:
    """Configuration-roofline placement for one *host* of a cluster.

    Every device behind one control processor shares a serialized config
    port (Colagrande & Benini's offload amplification), so the host's
    ``BW_cfg`` is the port's *effective* bandwidth (Eq. 4 over the cycles
    the port actually spent writing plus computing parameters) and its
    ``P_peak`` is the sum over the pool — adding devices raises the roof
    but leaves the config bandwidth fixed, pushing the knee point right.
    """
    t_set = max(config_cycles, 1e-12)
    bw = effective_config_bandwidth(config_bytes, calc_cycles, t_set)
    return RooflinePoint(
        name=name,
        i_oc=total_ops / max(config_bytes, 1e-12),
        performance=total_ops / makespan if makespan else 0.0,
        p_peak=p_peak,
        bw_config=bw,
    )


def fabric_roofline_point(
    name: str,
    *,
    total_ops: float,
    config_bytes: float,
    host_cycles: float,
    link_cycles: float,
    makespan: float,
    p_peak: float,
) -> RooflinePoint:
    """Configuration-roofline placement with the *interconnect* priced in.

    When config writes cross a fabric link (``repro.fabric``) instead of a
    core-local CSR port, Eq. 4's split becomes: T_calc is the host's
    instruction time (parameter calculation + descriptor/write issue) and
    T_set is the cycles the bytes spent on the wire — so ``BW_cfg`` is the
    *link-effective* configuration bandwidth. "Know your rooflines!" in
    practice: the transfer term appears as an explicit ceiling, and a slow
    link drags the knee point right even when the host itself is fast.
    """
    bw = effective_config_bandwidth(config_bytes, host_cycles,
                                    max(link_cycles, 1e-12))
    return RooflinePoint(
        name=name,
        i_oc=total_ops / max(config_bytes, 1e-12),
        performance=total_ops / makespan if makespan else 0.0,
        p_peak=p_peak,
        bw_config=bw,
    )


def overlap_roofline_point(
    name: str,
    *,
    total_ops: float,
    config_bytes: float,
    exposed_cycles: float,
    makespan: float,
    p_peak: float,
    calc_cycles: float = 0.0,
) -> RooflinePoint:
    """Configuration-roofline placement with *runtime overlap* priced in.

    When the engine stages config transfers behind compute
    (``repro.engine.overlap``), part of T_set leaves the critical path: the
    effective configuration term of Eq. 4 is only the **exposed** config
    cycles — host instruction time plus whatever wire time compute failed
    to cover. ``BW_cfg`` rises accordingly and the ridge (knee) point
    ``P_peak / BW_cfg`` shifts left: workloads that were configuration-bound
    under serialized dispatch become compute-bound once their T_set hides.
    A serialized run has ``exposed == config_cycles`` and this point
    degenerates to :func:`host_roofline_point`.
    """
    t_set = max(exposed_cycles, 1e-12)
    bw = effective_config_bandwidth(config_bytes, calc_cycles, t_set)
    return RooflinePoint(
        name=name,
        i_oc=total_ops / max(config_bytes, 1e-12),
        performance=total_ops / makespan if makespan else 0.0,
        p_peak=p_peak,
        bw_config=bw,
    )


def decode_roofline_point(
    name: str,
    *,
    tokens: float,
    ops_per_token: float,
    descriptor_bytes: float,
    config_cycles: float,
    makespan: float,
    p_peak: float,
) -> RooflinePoint:
    """Configuration-roofline placement for a *serving* workload
    (``repro.bridge``): the operational unit is the decode step, so I_OC is
    token work over the **descriptor bytes actually sent** — the
    {tokens, positions, live-mask} delta each step ships against the
    device-resident KV cache and weights (§5.4's deduplicated-configuration
    serving design). ``BW_cfg`` is Eq. 4 over the cycles those bytes held
    the config port. Descriptor elision moves a serving point rightward on
    exactly the same axes as the compiled-program points — the roofline now
    answers "is this *LLM serving* configuration-bound?", not a GEMM proxy.
    """
    total_ops = tokens * ops_per_token
    bw = effective_config_bandwidth(descriptor_bytes, 0.0,
                                    max(config_cycles, 1e-12))
    return RooflinePoint(
        name=name,
        i_oc=total_ops / max(descriptor_bytes, 1e-12),
        performance=total_ops / makespan if makespan else 0.0,
        p_peak=p_peak,
        bw_config=bw,
    )


def predicted_roofline_point(
    name: str,
    *,
    ops: float,
    config_bytes: float,
    compute_cycles: float,
    config_cycles: float,
    p_peak: float,
    concurrent: bool = True,
) -> RooflinePoint:
    """A *model-predicted* placement on the configuration roofline — no
    run required. The calibrated analytical compute model
    (``engine.costmodel``) predicts the kernel's compute cycles and the
    fabric transport plan prices its config bytes; the steady-state launch
    period is their ``max`` under concurrent configuration (config streams
    behind compute) and their sum under sequential (the host is captive
    through T_set, Eq. 3's serialization). The resulting point answers
    "where *would* this shape land?" before any launch happens — the
    what-if twin of :func:`host_roofline_point`, and the quantity the
    overlap autotuner's wire/compute ratio is read off of."""
    t_set = max(config_cycles, 1e-12)
    period = max(compute_cycles, t_set) if concurrent \
        else compute_cycles + t_set
    bw = effective_config_bandwidth(config_bytes, 0.0, t_set)
    return RooflinePoint(
        name=name,
        i_oc=ops / max(config_bytes, 1e-12),
        performance=ops / period if period else 0.0,
        p_peak=p_peak,
        bw_config=bw,
    )


# --------------------------------------------------------------------------
# the energy roofline — Eq. 4 along the joule axis
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class EnergyRooflinePoint:
    """One measurement on the *energy* roofline ("Know your rooflines!"
    extended per-Watt): efficiency (ops/pJ) against configuration energy
    intensity, with the same harmonic composition as the cycle plot.

    The analogy is exact. Cycles: work and configuration serialize in
    *time*, so attainable ops/cycle = 1/(1/P_peak + 1/(BW_cfg·I_OC)).
    Joules: every op and every config byte costs *energy*, so attainable
    ops/pJ = 1/(1/peak_ops_per_joule + 1/(bw_e·I_OC)) where ``bw_e`` is
    config bytes per joule of configuration energy — and the ridge sits
    at I_OC = peak_ops_per_joule / bw_e, in ops per joule-normalized
    byte. Runtime overlap does **not** save config joules (the handshakes
    happen either way), but descriptor elision and burst DMA do — they
    raise ``bw_e`` and shift the energy ridge left, exactly as exposed
    T_set reduction shifts the cycle ridge."""

    name: str
    i_oc: float  # ops per config byte — same x-axis as the cycle plot
    efficiency: float  # achieved ops/pJ (total_ops / total_energy)
    peak_ops_per_joule: float  # datapath efficiency at full tilt
    bw_energy: float  # config bytes per pJ of configuration energy

    @property
    def attainable(self) -> float:
        """Roofline ceiling at this I_OC, ops/pJ (harmonic composition —
        the sequential/energy analogue of Eq. 5)."""
        return 1.0 / (1.0 / self.peak_ops_per_joule
                      + 1.0 / (self.bw_energy * self.i_oc))

    @property
    def ridge(self) -> float:
        """I_OC where config and compute burn equal joules — left of it,
        the workload is configuration-*energy*-bound."""
        return self.peak_ops_per_joule / self.bw_energy

    @property
    def energy_bound(self) -> str:
        return "configuration" if self.i_oc < self.ridge else "compute"

    @property
    def utilization(self) -> float:
        """Achieved fraction of the datapath's peak efficiency."""
        return self.efficiency / self.peak_ops_per_joule


def energy_roofline_point(
    name: str,
    *,
    total_ops: float,
    config_bytes: float,
    config_energy: float,
    total_energy: float,
    compute_power: float,
    p_peak: float,
) -> EnergyRooflinePoint:
    """Place one run on the energy roofline (tokens/ops per joule).

    ``config_energy`` is the run's configuration joules — host instruction
    issue plus wire transfer energy, i.e. ``repro.power`` 's metered
    ``summary["config_energy"]`` — playing T_set's role: ``bw_e`` =
    config bytes per config joule, so cheaper transport (burst DMA,
    elision) raises it and moves the ridge left. ``compute_power`` is the
    datapath's active pJ/cycle, giving peak efficiency ``p_peak /
    compute_power`` ops/pJ. For serving, pass token counts as
    ``total_ops`` to read tokens-per-joule off the same plot."""
    peak_opj = p_peak / max(compute_power, 1e-12)
    bw_e = config_bytes / max(config_energy, 1e-12)
    return EnergyRooflinePoint(
        name=name,
        i_oc=total_ops / max(config_bytes, 1e-12),
        efficiency=total_ops / total_energy if total_energy else 0.0,
        peak_ops_per_joule=peak_opj,
        bw_energy=bw_e,
    )


# --------------------------------------------------------------------------
# §4.6 worked example: Gemmini output-stationary 64×64×64 matmul
# --------------------------------------------------------------------------

GEMMINI_EXAMPLE = dict(
    total_ops=2 * 64 * 64 * 64,  # 524,288 ops
    p_peak=16 * 16 * 2,  # 512 ops/cycle
    rocc_bytes=16,  # bytes per RoCC custom instruction
    instrs_per_rocc=3,  # 2 loads + 1 custom
    cycles_per_instr=3,  # Rocket CPI from [17]
    n_rocc_setup=160,  # traced RoCC instructions to configure
    n_total_instrs=935,  # incl. 775 bit-packing/parameter calculation
)


def gemmini_example_theoretical() -> tuple[float, float, float]:
    """Returns (BW_config, I_OC, utilization) with the theoretical bandwidth —
    the paper derives ≈1.77 B/cycle, I_OC ≈ 204.8, utilization ≈ 41.5%."""
    e = GEMMINI_EXAMPLE
    bw = e["rocc_bytes"] / (e["instrs_per_rocc"] * e["cycles_per_instr"])
    i_oc = e["total_ops"] / (e["n_rocc_setup"] * e["rocc_bytes"])
    util = sequential_config_roofline(e["p_peak"], bw, i_oc) / e["p_peak"]
    return bw, i_oc, util


def gemmini_example_effective() -> tuple[float, float, float]:
    """Returns (BW_eff, I_OC, utilization) with the *effective* bandwidth
    (Eq. 4) — the paper reports ≈0.913 B/cycle and ≈26.78% utilization."""
    e = GEMMINI_EXAMPLE
    n_bytes = e["n_rocc_setup"] * e["rocc_bytes"]
    total_cycles = e["n_total_instrs"] * e["cycles_per_instr"]
    bw_eff = n_bytes / total_cycles
    i_oc = e["total_ops"] / n_bytes
    util = sequential_config_roofline(e["p_peak"], bw_eff, i_oc) / e["p_peak"]
    return bw_eff, i_oc, util
