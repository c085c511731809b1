"""Energy models for the engine's resources (:mod:`~repro_torch.power.model`)
and the conservation-checked joule attribution and windowed power meter
over finished runs (:mod:`~repro_torch.power.meter`), copies of the JAX
package's."""

from .meter import (
    EnergyLane,
    EnergyReport,
    PoolEnergySnapshot,
    attribute_energy,
    host_window_energy,
    max_window_energy,
    pool_window_energy,
    pool_window_power,
    power_counter_series,
    resource_window_energy,
    transfers_window_energy,
)
from .model import (
    DEFAULT_ENERGY_PER_OP,
    HOST_ACTIVE_POWER,
    ZERO_ENERGY,
    EnergyModel,
    PowerSpec,
)

__all__ = [
    "DEFAULT_ENERGY_PER_OP",
    "HOST_ACTIVE_POWER",
    "ZERO_ENERGY",
    "EnergyLane",
    "EnergyModel",
    "EnergyReport",
    "PoolEnergySnapshot",
    "PowerSpec",
    "attribute_energy",
    "host_window_energy",
    "max_window_energy",
    "pool_window_energy",
    "pool_window_power",
    "power_counter_series",
    "resource_window_energy",
    "transfers_window_energy",
]
