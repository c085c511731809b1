"""Sliding-window streaming metrics + hysteresis alerts over live runs.

The port's own copy of ``repro/obs/monitor.py``: the code is the
reference's, unchanged.

The :class:`~repro.obs.metrics.MetricsRegistry` answers *whole-run*
questions (totals, exact percentiles) after the fact; a closed loop needs
the *recent-past* view while the run is still going — "what is the
exposed-config ratio over the last 5k cycles", "how fast is this tenant
burning its SLO budget", "has this host's port pressure stayed high long
enough to act on". This module is that substrate:

* :class:`WindowSeries` — one (time, value) sample stream with a fixed
  lookback window; trims lazily on read, so writers stay O(1).
* :class:`StreamMonitor` — windows keyed by ``(name, label set)`` (the
  registry's naming discipline), with derived serving signals the bridge
  feeds per step: :meth:`exposed_config_ratio`, :meth:`slo_burn_rate`,
  :meth:`token_rate`.
* :class:`SustainedThreshold` — the debounced alert primitive: a keyed
  condition must hold for ``sustain`` consecutive updates before the alert
  fires, and stays fired until the condition breaks or the subscriber
  acknowledges (:meth:`SustainedThreshold.reset`). This is the exact rule
  ``cluster.shed.ShedTrigger`` used to keep privately ("a host above k×
  the median wait for N epochs sheds"); it now *subscribes* to this
  primitive instead of owning bespoke streak bookkeeping, so any other
  policy (autoscaler, power cap) debounces identically.

Everything here is observation-only and deterministic: feeding a monitor
never changes a run's timing, mirroring the tracer's bit-identity rule.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping

from .metrics import LabelSet, labelset


class WindowSeries:
    """(t, value) samples over a fixed trailing window.

    Samples must arrive in non-decreasing time order (simulated clocks
    only move forward). Reads take ``now`` explicitly — the monitor has no
    clock of its own — and lazily drop samples older than
    ``now - window``; a sample exactly at the window edge survives
    (half-open ``(now - window, now]``, matching the engine's half-open
    interval discipline)."""

    def __init__(self, window: float):
        assert window > 0.0, window
        self.window = window
        self._t: list[float] = []
        self._v: list[float] = []

    def observe(self, t: float, value: float) -> None:
        assert not self._t or t >= self._t[-1], (
            f"samples must be time-ordered: {t} after {self._t[-1]}")
        self._t.append(float(t))
        self._v.append(float(value))

    def trim(self, now: float) -> None:
        """Drop samples at or before ``now - window``."""
        cut = now - self.window
        i = 0
        while i < len(self._t) and self._t[i] <= cut:
            i += 1
        if i:
            del self._t[:i]
            del self._v[:i]

    # -- windowed queries -----------------------------------------------------

    def count(self, now: float) -> int:
        self.trim(now)
        return len(self._v)

    def sum(self, now: float) -> float:
        self.trim(now)
        return sum(self._v)

    def mean(self, now: float) -> float:
        self.trim(now)
        return sum(self._v) / len(self._v) if self._v else 0.0

    def last(self) -> float | None:
        return self._v[-1] if self._v else None

    def rate(self, now: float) -> float:
        """Sum over the window span — e.g. tokens/cycle when fed token
        counts. The denominator is the full window width, so a sparse
        stream reads as a low rate rather than a bursty one."""
        return self.sum(now) / self.window


class SustainedThreshold:
    """Keyed debounced alert: a key's condition must hold ``sustain``
    consecutive updates before :meth:`update` reports it as fired, and it
    keeps firing every update until the condition breaks or the subscriber
    calls :meth:`reset` (acknowledging the alert — e.g. after acting on
    it). ``on_alert(key, streak)`` is invoked on the False→True firing
    edge, the hook a dashboard or log sink subscribes to."""

    def __init__(self, sustain: int = 2,
                 on_alert: Callable[[str, int], None] | None = None):
        assert sustain >= 1, sustain
        self.sustain = sustain
        self.on_alert = on_alert
        self._streak: dict[str, int] = {}

    def streak(self, key: str) -> int:
        return self._streak.get(key, 0)

    def update(self, key: str, condition: bool) -> bool:
        """Feed one observation; returns whether the alert is fired."""
        if not condition:
            self._streak[key] = 0
            return False
        streak = self._streak.get(key, 0) + 1
        self._streak[key] = streak
        fired = streak >= self.sustain
        if fired and streak == self.sustain and self.on_alert is not None:
            self.on_alert(key, streak)
        return fired

    def reset(self, key: str) -> None:
        """Acknowledge: the subscriber acted, the key must re-sustain."""
        self._streak[key] = 0


@dataclass
class Alert:
    """One registered windowed threshold (see :meth:`StreamMonitor.alert`)."""

    name: str
    labels: LabelSet
    threshold: float
    above: bool
    trigger: SustainedThreshold

    def check(self, monitor: "StreamMonitor", now: float) -> bool:
        series = monitor.window(self.name, **dict(self.labels))
        value = series.mean(now)
        hot = value > self.threshold if self.above else value < self.threshold
        return self.trigger.update(f"{self.name}{dict(self.labels)}", hot)


class StreamMonitor:
    """Sliding windows keyed ``(name, label set)`` plus derived serving
    signals. The closed-loop bridge feeds one per step
    (``ClosedLoopDriver(..., monitor=...)``): ``bridge.tokens``,
    ``bridge.config_cycles``, ``bridge.exposed_config``,
    ``bridge.latency`` and ``bridge.slo_miss`` per tenant — the canonical
    names the ratio helpers below read."""

    def __init__(self, window: float = 10_000.0):
        self.default_window = window
        self._series: dict[tuple[str, LabelSet], WindowSeries] = {}
        self._alerts: list[Alert] = []

    # -- feeding --------------------------------------------------------------

    def window(self, name: str, **labels) -> WindowSeries:
        key = (name, labelset(labels))
        series = self._series.get(key)
        if series is None:
            series = self._series[key] = WindowSeries(self.default_window)
        return series

    def observe(self, name: str, t: float, value: float, **labels) -> None:
        self.window(name, **labels).observe(t, value)

    def series(self, name: str, **match) -> list[WindowSeries]:
        want = labelset(match)
        return [s for (n, ls), s in sorted(self._series.items())
                if n == name and all(pair in ls for pair in want)]

    def windowed_sum(self, name: str, now: float, **match) -> float:
        return sum(s.sum(now) for s in self.series(name, **match))

    # -- derived serving signals ----------------------------------------------

    def exposed_config_ratio(self, now: float, **match) -> float:
        """Exposed / total config cycles over the window — 1.0 means the
        engine hid nothing recently (the run-level ``hidden_fraction``'s
        streaming twin)."""
        cfg = self.windowed_sum("bridge.config_cycles", now, **match)
        if cfg <= 0.0:
            return 0.0
        return self.windowed_sum("bridge.exposed_config", now, **match) / cfg

    def slo_burn_rate(self, now: float, **match) -> float:
        """Fraction of recent steps that missed their SLO — the budget
        burn a shedding/autoscaling policy thresholds on."""
        total = sum(s.count(now) for s in self.series("bridge.slo_miss",
                                                      **match))
        if total == 0:
            return 0.0
        return self.windowed_sum("bridge.slo_miss", now, **match) / total

    def token_rate(self, now: float, **match) -> float:
        """Tokens per kilocycle over the window (per tenant with
        ``tenant=...``, cluster-wide without)."""
        tokens = self.windowed_sum("bridge.tokens", now, **match)
        return tokens / self.default_window * 1_000.0

    def power_draw(self, now: float, **match) -> float:
        """Mean draw over the window, pJ/cycle (≡ mW at 1 GHz): windowed
        joules under the canonical ``power.energy`` name (per host with
        ``host=...``, pool-wide without) over the window length. The
        cluster power cap (``cluster.powercap``) feeds this signal and
        thresholds a :class:`SustainedThreshold` on it."""
        joules = self.windowed_sum("power.energy", now, **match)
        return joules / self.default_window

    # -- alerts ---------------------------------------------------------------

    def alert(self, name: str, *, threshold: float, above: bool = True,
              sustain: int = 2,
              on_alert: Callable[[str, int], None] | None = None,
              **labels) -> Alert:
        """Register a debounced threshold over one windowed series: fires
        when the series' window mean stays past ``threshold`` for
        ``sustain`` consecutive :meth:`check_alerts` epochs."""
        alert = Alert(name=name, labels=labelset(labels),
                      threshold=threshold, above=above,
                      trigger=SustainedThreshold(sustain, on_alert=on_alert))
        self._alerts.append(alert)
        return alert

    def check_alerts(self, now: float) -> list[Alert]:
        """One alert epoch; returns the alerts currently fired."""
        return [a for a in self._alerts if a.check(self, now)]


def feed_step(monitor: StreamMonitor, *, tenant: str, completion: float,
              tokens: int, latency: float, config_cycles: float,
              exposed_config: float, slo_cycles: float | None) -> None:
    """Record one closed-loop step into the monitor under the canonical
    ``bridge.*`` names (``ClosedLoopDriver``'s per-step hook)."""
    monitor.observe("bridge.tokens", completion, float(tokens), tenant=tenant)
    monitor.observe("bridge.latency", completion, latency, tenant=tenant)
    monitor.observe("bridge.config_cycles", completion, config_cycles,
                    tenant=tenant)
    monitor.observe("bridge.exposed_config", completion, exposed_config,
                    tenant=tenant)
    if slo_cycles is not None:
        monitor.observe("bridge.slo_miss", completion,
                        1.0 if latency > slo_cycles else 0.0, tenant=tenant)
