"""The multi-host cluster model, copied from the JAX package: open-loop
traffic (:mod:`~repro_torch.cluster.traffic`), hosts behind a serialized
config port (:mod:`~repro_torch.cluster.host`), cross-host routing and the
drain loop (:mod:`~repro_torch.cluster.router`), SLO reports
(:mod:`~repro_torch.cluster.slo`), the load-shedding trigger that migrates
a hot host's tenant (:mod:`~repro_torch.cluster.shed`) and the power-cap
governor (:mod:`~repro_torch.cluster.powercap`)."""

from . import host, powercap, router, shed, slo, traffic
from .host import Host
from .router import ROUTERS, Cluster, Router
from .shed import ShedDecision, ShedTrigger
from .slo import ClusterReport, TenantSLO, TenantServing, build_report, percentile
from .traffic import ARRIVALS, TenantProfile, generate, slo_targets

__all__ = [
    "ARRIVALS",
    "ROUTERS",
    "Cluster",
    "ClusterReport",
    "Host",
    "Router",
    "ShedDecision",
    "ShedTrigger",
    "TenantProfile",
    "TenantSLO",
    "TenantServing",
    "build_report",
    "generate",
    "host",
    "percentile",
    "powercap",
    "router",
    "shed",
    "slo",
    "slo_targets",
    "traffic",
]
