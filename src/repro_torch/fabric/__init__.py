"""The configuration fabric the port's cluster model prices writes over:
typed links with contention queues (:mod:`~repro_torch.fabric.link`) and
the MMIO-vs-burst transfer planner (:mod:`~repro_torch.fabric.transport`),
copies of the JAX package's. Context snapshots and migration are queued in
``ROADMAP.md``."""

from . import link, transport
from .link import LINKS, LinkModel, LinkPort, Transfer, csr_local, noc, pcie, resolve_link
from .transport import (
    TransferSchedule,
    burst_schedule,
    crossover_fields,
    mmio_schedule,
    plan_fields,
    plan_transfer,
)

__all__ = [
    "LINKS",
    "LinkModel",
    "LinkPort",
    "Transfer",
    "TransferSchedule",
    "burst_schedule",
    "crossover_fields",
    "csr_local",
    "link",
    "mmio_schedule",
    "noc",
    "pcie",
    "plan_fields",
    "plan_transfer",
    "resolve_link",
    "transport",
]
