"""The multi-host cluster model, copied from the JAX package: open-loop
traffic (:mod:`~repro_torch.cluster.traffic`), hosts behind a serialized
config port (:mod:`~repro_torch.cluster.host`), cross-host routing and the
drain loop (:mod:`~repro_torch.cluster.router`), and SLO reports
(:mod:`~repro_torch.cluster.slo`). Load shedding and power capping are
queued in ``ROADMAP.md``."""

from . import host, router, slo, traffic
from .host import Host
from .router import ROUTERS, Cluster, Router
from .slo import ClusterReport, TenantSLO, TenantServing, build_report, percentile
from .traffic import ARRIVALS, TenantProfile, generate, slo_targets

__all__ = [
    "ARRIVALS",
    "ROUTERS",
    "Cluster",
    "ClusterReport",
    "Host",
    "Router",
    "TenantProfile",
    "TenantSLO",
    "TenantServing",
    "build_report",
    "generate",
    "host",
    "percentile",
    "router",
    "slo",
    "slo_targets",
    "traffic",
]
