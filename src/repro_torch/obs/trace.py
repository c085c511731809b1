"""Span-based tracer — the one event stream every runtime layer feeds.

The port's own copy of ``repro/obs/trace.py``: the code is the
reference's, unchanged.

A :class:`Tracer` is a passive sink: the scheduler, overlap policy, fabric
port, cluster host, and closed-loop bridge each emit **spans** (an interval
of occupancy on a named lane), **instants** (zero-width markers like the
config-complete edge), and **counter samples** (cumulative tokens), all in
the same cycle clock their resource model already runs on. Hooks are
observation-only — a run with a tracer attached produces bit-identical
timing to one without (the tracer never touches a clock), which is the
property that lets the golden-trace test pin exact timestamps.

Lanes use the engine's resource vocabulary so the exported trace reads
like the three-resource model: ``host`` (control thread), ``cfg[noc]`` /
``cfg[pcie]:shared`` (the wire — the fabric port's own name), and
``compute[<device>]`` lanes, plus per-tenant ``tenant[<t>]`` lanes
(queued → launch) and per-tenant ``step[<t>]`` lanes from the closed-loop
bridge. The span taxonomy per launch:

    queued        tenant lane   arrival → issue (admission wait)
    config-issue  host lane     host instruction time (T_calc + issue)
    wire-captive  host lane     serialized wait for the wire (Eq. 4 worst case)
    launch-stall  host lane     blocked on the device (ring full / sequential)
    mmio | burst  wire lane     the transfer occupying the link
    config-done   instant       register image fully on-device
    compute       compute lane  macro-op start → retire
    launch        tenant lane   issue → retire, tagged with exposed_config

:meth:`Tracer.bind` returns a :class:`BoundTracer` sharing the same sink
with default tags merged into every event — ``cluster.Host`` binds
``host=<id>`` so one cluster-wide tracer still attributes every span. The
shared fabric port deliberately receives the *unbound* root (a wire shared
by several hosts belongs to no one host's process group).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class Span:
    """One interval of occupancy on a lane."""

    name: str
    cat: str  # taxonomy category: queueing|config|wire|stall|compute|launch|step
    start: float
    end: float
    lane: str
    tags: dict = field(default_factory=dict)

    @property
    def cycles(self) -> float:
        return self.end - self.start


@dataclass(frozen=True)
class Instant:
    """A zero-width marker (e.g. the config-complete edge)."""

    name: str
    ts: float
    lane: str
    tags: dict = field(default_factory=dict)


@dataclass(frozen=True)
class CounterSample:
    """One sample of a cumulative series (e.g. tokens produced)."""

    name: str
    ts: float
    value: float
    lane: str
    tags: dict = field(default_factory=dict)


class Tracer:
    """The event sink. All emission methods are O(1) appends."""

    def __init__(self):
        self.spans: list[Span] = []
        self.instants: list[Instant] = []
        self.counters: list[CounterSample] = []

    @property
    def root(self) -> "Tracer":
        return self

    # -- emission -------------------------------------------------------------

    def span(self, name: str, cat: str, start: float, end: float, *,
             lane: str, **tags) -> None:
        assert end >= start, (name, start, end)
        self.spans.append(Span(name, cat, start, end, lane, tags))

    def instant(self, name: str, ts: float, *, lane: str, **tags) -> None:
        self.instants.append(Instant(name, ts, lane, tags))

    def counter(self, name: str, ts: float, value: float, *,
                lane: str, **tags) -> None:
        self.counters.append(CounterSample(name, ts, float(value), lane, tags))

    # -- derived --------------------------------------------------------------

    def bind(self, **tags) -> "BoundTracer":
        """A view of this sink with ``tags`` merged into every event."""
        return BoundTracer(self, tags)

    def lanes(self) -> list[str]:
        """Every lane that received an event, first-appearance order."""
        seen: dict[str, None] = {}
        for ev in (*self.spans, *self.instants, *self.counters):
            seen.setdefault(ev.lane, None)
        return list(seen)

    def spans_on(self, lane: str) -> list[Span]:
        return [s for s in self.spans if s.lane == lane]

    def __len__(self) -> int:
        return len(self.spans) + len(self.instants) + len(self.counters)


class BoundTracer:
    """Shares a root sink; merges default tags into every event. Explicit
    per-event tags win over the bound defaults; ``bind`` nests."""

    def __init__(self, root: Tracer, tags: dict):
        self.root = root
        self.tags = dict(tags)

    def _merge(self, tags: dict) -> dict:
        merged = dict(self.tags)
        merged.update(tags)
        return merged

    def span(self, name: str, cat: str, start: float, end: float, *,
             lane: str, **tags) -> None:
        self.root.span(name, cat, start, end, lane=lane, **self._merge(tags))

    def instant(self, name: str, ts: float, *, lane: str, **tags) -> None:
        self.root.instant(name, ts, lane=lane, **self._merge(tags))

    def counter(self, name: str, ts: float, value: float, *,
                lane: str, **tags) -> None:
        self.root.counter(name, ts, value, lane=lane, **self._merge(tags))

    def bind(self, **tags) -> "BoundTracer":
        return BoundTracer(self.root, self._merge(tags))
