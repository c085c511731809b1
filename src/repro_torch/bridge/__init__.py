"""repro_torch.bridge — the closed-loop serving bridge.

The counterpart of ``repro/bridge``: the port's serving engines **are** the
cluster model's tenants, and the multi-host roofline/SLO numbers are
produced by their actual decode launch descriptors — the workload the
paper's §5.4 deduplicated-configuration serving design was written for.

* :mod:`~repro_torch.bridge.descriptors` — launch-descriptor →
  register-field translation, built so the engine executor's
  leaf-granular descriptor cache and the cluster device's field-granular
  config-state cache make identical elision decisions on the same stream.
* :mod:`~repro_torch.bridge.tenant` — :class:`TenantEngine` wraps one
  engine as one tenant: mirrors its launch stream (via
  ``ServingEngine.on_launch``, observation-only — bridged token output
  stays bit-identical) and states the exact accounting identity between
  the two caches.
* :mod:`~repro_torch.bridge.driver` — :class:`ClosedLoopDriver`: a tenant
  emits its next decode launch only after the previous one completes on
  the cluster clock, so queueing delay throttles token throughput.
* :mod:`~repro_torch.bridge.report` — :class:`BridgeReport`: tokens/kcycle
  goodput, per-tenant decode-latency percentiles, per-step descriptor-byte
  timelines, serving roofline points, and the engine↔cluster config-byte
  parity check.

The engines compute on the card (or on the CPU, when their model was built
there); the cluster model is pure Python and prices the same launch stream
in accelerator cycles. ``chip_smoke.py``'s ``[bridge]`` phase runs it at
full width on the card: six tenants on two hosts under sticky affinity,
round-robin, host sampling and token-at-a-time prefill, with the card's
wall time per launch beside the model's cycles.
"""

from . import descriptors, driver, report, tenant
from .descriptors import (
    descriptor_fields,
    descriptor_nbytes,
    descriptor_request,
    leaf_digest,
    padded_nbytes,
)
from .driver import ClosedLoopDriver, StepRecord
from .report import BridgeReport, build_bridge_report
from .tenant import TenantEngine, decode_tile

__all__ = [
    "BridgeReport",
    "ClosedLoopDriver",
    "StepRecord",
    "TenantEngine",
    "build_bridge_report",
    "decode_tile",
    "descriptor_fields",
    "descriptor_nbytes",
    "descriptor_request",
    "descriptors",
    "driver",
    "leaf_digest",
    "padded_nbytes",
    "report",
    "tenant",
]
