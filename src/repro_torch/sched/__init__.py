"""The runtime scheduler, copied from the JAX package: the configuration-
state cache behind the executor's descriptor dedup
(:mod:`~repro_torch.sched.state_cache`), the staged launch queues
(:mod:`~repro_torch.sched.queue`), config-affinity placement over a device
pool (:mod:`~repro_torch.sched.scheduler`) and its telemetry
(:mod:`~repro_torch.sched.telemetry`)."""

from . import queue, scheduler, state_cache, telemetry
from .queue import (
    AdmissionQueue,
    LaunchQueue,
    LaunchTiming,
    Staged,
    arrival_order,
    edf_order,
)
from .scheduler import Device, LaunchRequest, Scheduler, requests_from_trace
from .state_cache import CacheStats, ConfigStateCache, WritePlan, elision_ratio, nbytes_of
from .telemetry import (
    DeviceTelemetry,
    LaunchRecord,
    LinkTelemetry,
    ResourceTelemetry,
    SchedulerReport,
    geomean,
)

__all__ = [
    "AdmissionQueue",
    "CacheStats",
    "ConfigStateCache",
    "Device",
    "DeviceTelemetry",
    "LaunchQueue",
    "LaunchRecord",
    "LaunchRequest",
    "LaunchTiming",
    "LinkTelemetry",
    "ResourceTelemetry",
    "Scheduler",
    "SchedulerReport",
    "Staged",
    "WritePlan",
    "arrival_order",
    "edf_order",
    "elision_ratio",
    "geomean",
    "nbytes_of",
    "queue",
    "requests_from_trace",
    "scheduler",
    "state_cache",
    "telemetry",
]
