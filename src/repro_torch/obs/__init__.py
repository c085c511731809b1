"""The observation and diagnosis layer the port's scheduler, cluster and
bridge report through, copied from the JAX package:

* :mod:`~repro_torch.obs.trace` — the span :class:`Tracer` every runtime
  layer feeds (a run with a tracer attached is bit-identical to one
  without), and :mod:`~repro_torch.obs.export`, which writes it as a
  Chrome-trace / Perfetto ``trace.json`` with the attribution and metrics
  embedded;
* :mod:`~repro_torch.obs.attribution` — the makespan decomposition per
  resource lane, conserved on every lane;
* :mod:`~repro_torch.obs.metrics` — the label-set metrics registry;
* :mod:`~repro_torch.obs.monitor` — the streaming monitor
  ``ClosedLoopDriver`` feeds;
* :mod:`~repro_torch.obs.diagnose`, :mod:`~repro_torch.obs.whatif` and
  :mod:`~repro_torch.obs.diff` — the config-wall doctor: regime, ranked
  recommendations priced by replay, and the differential view of two
  traces, behind ``python -m repro_torch.obs.doctor TRACE.json
  [--against OTHER.json]``.
"""

from . import attribution, diagnose, diff, export, metrics, monitor, trace
from . import whatif
from .attribution import AttributionReport, LaneAttribution, attribute
from .diagnose import Diagnosis, Recommendation, Regime, classify
from .diagnose import classify_cell, diagnose_doc
from .diagnose import diagnose as diagnose_report
from .export import chrome_trace, trace_power, validate_trace, write_trace
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, percentile
from .monitor import Alert, StreamMonitor, SustainedThreshold, WindowSeries, feed_step
from .trace import BoundTracer, CounterSample, Instant, Span, Tracer
from .whatif import WhatIf, predict_burst, predict_overlap, predict_staging

__all__ = [
    "Alert",
    "AttributionReport",
    "BoundTracer",
    "Counter",
    "CounterSample",
    "Diagnosis",
    "Gauge",
    "Histogram",
    "Instant",
    "LaneAttribution",
    "MetricsRegistry",
    "Recommendation",
    "Regime",
    "Span",
    "StreamMonitor",
    "SustainedThreshold",
    "Tracer",
    "WhatIf",
    "WindowSeries",
    "attribute",
    "attribution",
    "chrome_trace",
    "classify",
    "classify_cell",
    "diagnose",
    "diagnose_doc",
    "diagnose_report",
    "diff",
    "export",
    "feed_step",
    "metrics",
    "monitor",
    "percentile",
    "predict_burst",
    "predict_overlap",
    "predict_staging",
    "trace",
    "validate_trace",
    "whatif",
    "write_trace",
]
