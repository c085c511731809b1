"""The observation layer the port's scheduler, cluster and bridge report
through: the label-set metrics registry (:mod:`~repro_torch.obs.metrics`),
the makespan attribution (:mod:`~repro_torch.obs.attribution`) and the
streaming monitor ``ClosedLoopDriver`` feeds
(:mod:`~repro_torch.obs.monitor`), copies of the JAX package's. The span
tracer, its exporter and the diagnosis tools are queued in ``ROADMAP.md``."""

from . import attribution, metrics, monitor
from .attribution import AttributionReport, LaneAttribution, attribute
from .metrics import Counter, Gauge, Histogram, MetricsRegistry, percentile
from .monitor import Alert, StreamMonitor, SustainedThreshold, WindowSeries, feed_step

__all__ = [
    "Alert",
    "AttributionReport",
    "Counter",
    "Gauge",
    "Histogram",
    "LaneAttribution",
    "MetricsRegistry",
    "StreamMonitor",
    "SustainedThreshold",
    "WindowSeries",
    "attribute",
    "attribution",
    "feed_step",
    "metrics",
    "monitor",
    "percentile",
]
