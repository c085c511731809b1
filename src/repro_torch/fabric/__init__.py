"""The configuration fabric, copied from the JAX package: typed links
with contention queues (:mod:`~repro_torch.fabric.link`), the
MMIO-vs-burst transfer planner (:mod:`~repro_torch.fabric.transport`),
CRC-guarded register-context snapshots
(:mod:`~repro_torch.fabric.snapshot`), and the migration planner with
:class:`ContextStore` (:mod:`~repro_torch.fabric.migrate`), which persists
contexts through the port's ``checkpoint.CheckpointStore`` in the
reference's on-disk format."""

from . import link, migrate, snapshot, transport
from .link import LINKS, LinkModel, LinkPort, Transfer, csr_local, noc, pcie, resolve_link
from .migrate import (
    ContextStore,
    MigrationEstimate,
    MigrationPlanner,
    MigrationRecord,
    capture_contexts,
    context_device,
    install_contexts,
)
from .snapshot import ContextSnapshot, capture, delta_fields, install, ship_cycles
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
    "ContextSnapshot",
    "ContextStore",
    "LinkModel",
    "LinkPort",
    "MigrationEstimate",
    "MigrationPlanner",
    "MigrationRecord",
    "Transfer",
    "TransferSchedule",
    "burst_schedule",
    "capture",
    "capture_contexts",
    "context_device",
    "crossover_fields",
    "csr_local",
    "delta_fields",
    "install",
    "install_contexts",
    "link",
    "migrate",
    "mmio_schedule",
    "noc",
    "pcie",
    "plan_fields",
    "plan_transfer",
    "resolve_link",
    "ship_cycles",
    "snapshot",
    "transport",
]
