"""Energy models for the engine's resources — the joule axis of the wall.

The port's own copy of ``repro/power/model.py``: the code is the
reference's, unchanged.

The paper's opening motivation is performance *per Watt*, yet everything
upstream of this module prices the configuration wall in cycles only.
"Know your rooflines!" (Verhelst et al.) argues the roofline family must
be extended along the energy axis; the neuromorphic bottleneck study
shows config/setup phases can dominate *energy* even when cycle counts
look healthy — MMIO's per-write handshakes burn joules that burst DMA
amortizes, and an idle-but-not-gated PCIe serdes burns them doing
nothing. This module supplies the rates; :mod:`repro.power.meter` turns
a finished run's busy-interval logs into a conservation-checked joule
attribution.

Three pieces:

* :class:`EnergyModel` — one resource's static rates: active power per
  busy cycle, idle power per idle cycle, a clock-gating factor scaling
  the idle burn (0 = perfect gating, 1 = no gating), and a wake-up /
  dead-time energy paid on every idle→busy transition (PLL relock,
  pipeline refill — the ESL-CGRA characterization's dead-time term).
* :class:`PowerSpec` — the rates for one scheduler's whole engine:
  ``host`` (the control thread), ``compute`` keyed by accelerator model
  name, ``wire`` keyed by link kind (idle/wake only — the wire's *busy*
  energy is per-transaction, priced on the
  :class:`~repro.fabric.link.LinkModel` itself so the transport layer's
  joule-objective mode choice and the meter read the same numbers).

Units are nominal picojoules with the cycle as the time unit, so
``active_power`` reads as pJ/cycle (≡ mW at 1 GHz) and every total is in
pJ. Nothing downstream depends on the unit — only on ratios.

All of this is observation-only: attaching an ``EnergyModel`` to a
resource never moves a clock, and a zero spec reproduces every cycle
report unchanged (pinned in ``tests/test_power.py``). The single place
energy may change *timing* is the explicit ``objective="joules"|"edp"``
transport knob (:func:`repro.fabric.transport.plan_fields`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Mapping

from ..core.accelerators import REGISTRY
from ..fabric.transport import HOST_ENERGY_PER_CYCLE

__all__ = ["EnergyModel", "PowerSpec", "ZERO_ENERGY",
           "DEFAULT_ENERGY_PER_OP", "HOST_ACTIVE_POWER"]

# the host control thread's active power, pJ per busy cycle — the *same*
# constant fabric.transport prices plan-time host energy with, so the
# joule objective and the meter can never disagree on what a cycle costs
HOST_ACTIVE_POWER = HOST_ENERGY_PER_CYCLE

# default datapath efficiency for REGISTRY models without explicit rates:
# active power = p_peak × this (pJ per op at full tilt)
DEFAULT_ENERGY_PER_OP = 0.25


@dataclass(frozen=True)
class EnergyModel:
    """Static power/energy rates of one serially-occupied resource."""

    active_power: float  # pJ per busy cycle
    idle_power: float = 0.0  # pJ per idle cycle, before gating
    gating: float = 1.0  # fraction of idle_power burned when idle (0..1]
    wake_energy: float = 0.0  # pJ dead-time cost per idle→busy transition

    def __post_init__(self) -> None:
        assert self.active_power >= 0.0, self.active_power
        assert self.idle_power >= 0.0, self.idle_power
        assert 0.0 <= self.gating <= 1.0, self.gating
        assert self.wake_energy >= 0.0, self.wake_energy

    @property
    def idle_rate(self) -> float:
        """Effective idle burn, pJ per idle cycle (gating applied)."""
        return self.idle_power * self.gating

    def active_energy(self, busy_cycles: float) -> float:
        return busy_cycles * self.active_power

    def idle_energy(self, idle_cycles: float) -> float:
        return max(0.0, idle_cycles) * self.idle_rate

    def wake_cost(self, wakeups: int) -> float:
        return wakeups * self.wake_energy


ZERO_ENERGY = EnergyModel(0.0, 0.0, 1.0, 0.0)


def _default_compute() -> dict[str, EnergyModel]:
    return {
        name: EnergyModel(
            active_power=model.p_peak * DEFAULT_ENERGY_PER_OP,
            idle_power=model.p_peak * DEFAULT_ENERGY_PER_OP * 0.1,
            gating=0.25,
            wake_energy=500.0,
        )
        for name, model in REGISTRY.items()
    }


def _default_wire() -> dict[str, EnergyModel]:
    # wire *busy* energy is per-transaction (LinkModel.transfer_energy);
    # these rates cover only the link's standing burn: a NoC router idles
    # cheap and gates well, a PCIe serdes burns real power just keeping
    # the lanes trained and pays a long recalibration on wake
    return {
        "csr": ZERO_ENERGY,
        "noc": EnergyModel(active_power=0.0, idle_power=0.5, gating=0.5,
                           wake_energy=20.0),
        "pcie": EnergyModel(active_power=0.0, idle_power=30.0, gating=0.8,
                            wake_energy=1000.0),
    }


@dataclass(frozen=True)
class PowerSpec:
    """The energy rates one scheduler's engine resources run at."""

    host: EnergyModel
    compute: Mapping[str, EnergyModel] = field(default_factory=dict)
    wire: Mapping[str, EnergyModel] = field(default_factory=dict)

    def compute_model(self, model_name: str) -> EnergyModel:
        return self.compute.get(model_name, ZERO_ENERGY)

    def wire_model(self, link_kind: str) -> EnergyModel:
        return self.wire.get(link_kind, ZERO_ENERGY)

    @classmethod
    def default(cls) -> "PowerSpec":
        """Nominal rates for every REGISTRY model and link kind: host at
        :data:`HOST_ACTIVE_POWER`, datapaths at
        :data:`DEFAULT_ENERGY_PER_OP` per op."""
        return cls(
            host=EnergyModel(active_power=HOST_ACTIVE_POWER, idle_power=0.25,
                             gating=0.4, wake_energy=50.0),
            compute=_default_compute(),
            wire=_default_wire(),
        )

    @classmethod
    def zero(cls) -> "PowerSpec":
        """All-zero occupancy rates: metering under this spec yields zero
        active/idle/wake joules on every lane — the regression pin that
        attaching energy observability cannot perturb cycle-only reports.
        Wire *transfer* joules are a property of the LinkModel, not of
        this spec, so launch traffic still meters its handshake/byte
        energy (zero only on links priced at zero)."""
        return cls(host=ZERO_ENERGY)
