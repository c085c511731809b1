"""Label-set metrics registry — counters, gauges, histograms.

The port's own copy of ``repro/obs/metrics.py``: the code is the
reference's, unchanged.

Every runtime layer used to grow its own ad-hoc counter fields
(``sched.telemetry.DeviceTelemetry``'s nine scalars, ``cluster.slo``'s
percentile recomputations, ``bridge.report``'s step sums). This module is
the one place a number lives: a metric is identified by a **name** plus a
sorted **label set** (``counter("sched.bytes_sent", device="opengemm:0")``),
registries fold across hosts (:meth:`MetricsRegistry.absorb` re-labels on
the way in), and the layer reports stay thin views — their public fields
read the registry instead of owning private accumulators.

Three metric kinds, all deterministic and dependency-free:

* :class:`Counter` — monotone by convention, but ``add`` accepts negative
  deltas: a preempted staged launch *un-happens* on the device (busy
  cycles, ops, and the launch count roll back — exactly what
  ``DeviceTelemetry.record_preemption`` has always done), and the registry
  must be able to express that without a parallel correction metric.
* :class:`Gauge` — last-write-wins scalar (makespans, port waits).
* :class:`Histogram` — stores raw samples so percentiles are *exact*
  (:func:`percentile`, the same deterministic linear interpolation
  ``cluster.slo`` has always used — it now lives here and is re-exported
  from there), not bucket approximations; sample counts at this repo's
  scale make that the right trade.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Sequence

LabelSet = tuple  # tuple[tuple[str, str], ...] — sorted, hashable


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0 ≤ q ≤ 100) by linear interpolation between
    order statistics — numpy's default method, implemented deterministically."""
    assert 0.0 <= q <= 100.0
    if not values:
        return 0.0
    vals = sorted(values)
    if len(vals) == 1:
        return vals[0]
    pos = (q / 100.0) * (len(vals) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(vals) - 1)
    frac = pos - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


def labelset(labels: Mapping[str, object]) -> LabelSet:
    """Canonical hashable form of a label mapping (values stringified)."""
    return tuple(sorted((k, str(v)) for k, v in labels.items()))


class Metric:
    """Common identity: a name plus a sorted label set."""

    kind = "metric"

    def __init__(self, name: str, labels: LabelSet):
        self.name = name
        self.labels = labels

    @property
    def label_dict(self) -> dict[str, str]:
        return dict(self.labels)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        pairs = ",".join(f"{k}={v}" for k, v in self.labels)
        return f"<{self.kind} {self.name}{{{pairs}}}>"


class Counter(Metric):
    """Accumulating scalar. ``add`` accepts negative deltas so preemption
    rollback (a staged launch that never ran) stays a first-class event."""

    kind = "counter"

    def __init__(self, name: str, labels: LabelSet):
        super().__init__(name, labels)
        self.value = 0.0

    def inc(self, delta: float = 1.0) -> None:
        self.value += delta

    def add(self, delta: float) -> None:
        self.value += delta


class Gauge(Metric):
    """Last-write-wins scalar (a makespan, a port-wait estimate)."""

    kind = "gauge"

    def __init__(self, name: str, labels: LabelSet):
        super().__init__(name, labels)
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class Histogram(Metric):
    """Raw-sample histogram: exact deterministic percentiles, no buckets."""

    kind = "histogram"

    def __init__(self, name: str, labels: LabelSet):
        super().__init__(name, labels)
        self.samples: list[float] = []

    def observe(self, value: float) -> None:
        self.samples.append(float(value))

    def extend(self, values: Iterable[float]) -> None:
        self.samples.extend(float(v) for v in values)

    @property
    def count(self) -> int:
        return len(self.samples)

    @property
    def total(self) -> float:
        return sum(self.samples)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.samples else 0.0

    def percentile(self, q: float) -> float:
        return percentile(self.samples, q)


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class MetricsRegistry:
    """All metrics of one run, keyed ``(name, label set)``.

    ``counter``/``gauge``/``histogram`` are get-or-create (the hot path
    caches the returned object and mutates it directly); ``total`` /
    ``samples`` / ``series`` are the read side the layer reports use as
    views; ``absorb`` folds a child registry in under extra labels (how a
    cluster report merges its hosts' scheduler registries)."""

    def __init__(self):
        self._metrics: dict[tuple[str, LabelSet], Metric] = {}

    # -- get-or-create --------------------------------------------------------

    def _get_or_create(self, kind: str, name: str,
                       labels: Mapping[str, object]) -> Metric:
        key = (name, labelset(labels))
        metric = self._metrics.get(key)
        if metric is None:
            metric = _KINDS[kind](name, key[1])
            self._metrics[key] = metric
        assert metric.kind == kind, (
            f"{name} already registered as {metric.kind}, requested {kind}")
        return metric

    def counter(self, name: str, **labels) -> Counter:
        return self._get_or_create("counter", name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get_or_create("gauge", name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get_or_create("histogram", name, labels)

    # -- queries --------------------------------------------------------------

    def __len__(self) -> int:
        return len(self._metrics)

    def get(self, name: str, **labels) -> Metric | None:
        return self._metrics.get((name, labelset(labels)))

    def has(self, name: str) -> bool:
        return any(n == name for n, _ in self._metrics)

    def names(self) -> list[str]:
        return sorted({n for n, _ in self._metrics})

    def series(self, name: str, **match) -> list[Metric]:
        """Every metric of ``name`` whose labels contain ``match``, in
        deterministic (label set) order."""
        want = labelset(match)
        out = [m for (n, ls), m in sorted(self._metrics.items())
               if n == name and all(pair in ls for pair in want)]
        return out

    def total(self, name: str, **match) -> float:
        """Sum of matching counter/gauge values (histograms sum their
        samples) — the aggregate the report properties are views of."""
        acc = 0.0
        for m in self.series(name, **match):
            acc += m.total if isinstance(m, Histogram) else m.value
        return acc

    def samples(self, name: str, **match) -> list[float]:
        """Concatenated raw samples of matching histograms."""
        out: list[float] = []
        for m in self.series(name, **match):
            assert isinstance(m, Histogram), f"{name} is a {m.kind}"
            out.extend(m.samples)
        return out

    # -- folding / export -----------------------------------------------------

    def absorb(self, other: "MetricsRegistry", **extra_labels) -> None:
        """Fold ``other`` in, extending every absorbed metric's label set
        with ``extra_labels`` (counters sum, gauges last-write-win,
        histograms concatenate) — the cluster's host-merge primitive."""
        for (name, ls), m in sorted(other._metrics.items()):
            merged = dict(ls)
            merged.update({k: str(v) for k, v in extra_labels.items()})
            if isinstance(m, Counter):
                self.counter(name, **merged).add(m.value)
            elif isinstance(m, Gauge):
                self.gauge(name, **merged).set(m.value)
            else:
                self.histogram(name, **merged).extend(m.samples)

    def collect(self) -> list[dict]:
        """Every metric as a plain dict, deterministically ordered — the
        JSON-exportable flat view (`trace.json` embeds this)."""
        out = []
        for (name, ls), m in sorted(self._metrics.items()):
            row: dict = {"name": name, "kind": m.kind, "labels": dict(ls)}
            if isinstance(m, Histogram):
                row.update(count=m.count, total=m.total, mean=m.mean,
                           p50=m.percentile(50), p95=m.percentile(95),
                           p99=m.percentile(99))
            else:
                row["value"] = m.value
            out.append(row)
        return out
