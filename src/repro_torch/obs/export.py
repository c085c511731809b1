"""Chrome-trace / Perfetto exporter for :class:`~repro.obs.trace.Tracer`.

The port's own copy of ``repro/obs/export.py``: the code is the
reference's, unchanged.

Produces the Trace Event Format (the ``chrome://tracing`` / Perfetto JSON
dialect): spans become complete (``"X"``) events, instants ``"i"``,
counter samples ``"C"``, plus ``"M"`` metadata naming every process and
thread. Timestamps are emitted in the runtime's own cycle clock (the
nominal unit is µs — one cycle reads as one microsecond, which is
irrelevant for inspection and keeps the numbers exact).

Grouping mirrors the runtime topology: each **process** is a host (the
``host=`` tag a :class:`~repro.obs.trace.BoundTracer` stamps), with the
shared fabric wire under a ``fabric`` process (a wire shared by several
hosts belongs to none of them) and closed-loop step lanes under
``bridge``; each **thread** is a lane — ``host``, ``cfg[<link>]``,
``compute[<device>]``, ``tenant[<t>]`` — sorted so the resource lanes of
the engine's three-resource model sit on top.

``write_trace`` embeds two structured side-channels next to
``traceEvents`` (Chrome and Perfetto ignore unknown top-level keys): the
cycle-attribution report (``"attribution"`` — the CI conservation gate
reads it straight out of the artifact) and the metrics registry
(``"metrics"``).
"""

from __future__ import annotations

import json

from .trace import Tracer

# thread ordering inside a process: engine resources first, then power
# counter lanes, then tenants
_LANE_ORDER = (("host", 0), ("cfg[", 1), ("compute[", 2), ("power[", 30),
               ("tenant[", 40), ("step[", 50), ("tokens[", 60))


def _lane_sort_index(lane: str) -> int:
    for prefix, base in _LANE_ORDER:
        if lane.startswith(prefix):
            return base
    return 80


def _process_for(lane: str, tags: dict) -> str:
    if lane.startswith("cfg["):
        return "fabric"
    if lane.startswith(("step[", "tokens[")):
        return "bridge"
    return str(tags.get("host", "run"))


def _json_tags(tags: dict) -> dict:
    return {k: v for k, v in tags.items() if k != "host"}


def chrome_trace(tracer: Tracer) -> dict:
    """The tracer's events as a Trace Event Format document (a dict)."""
    pids: dict[str, int] = {}
    tids: dict[tuple[int, str], int] = {}
    meta: list[dict] = []

    def _pid(name: str) -> int:
        if name not in pids:
            pids[name] = len(pids) + 1
            meta.append({"ph": "M", "name": "process_name", "pid": pids[name],
                         "args": {"name": name}})
        return pids[name]

    def _tid(pid: int, lane: str) -> int:
        key = (pid, lane)
        if key not in tids:
            tids[key] = len(tids) + 1
            meta.append({"ph": "M", "name": "thread_name", "pid": pid,
                         "tid": tids[key], "args": {"name": lane}})
            meta.append({"ph": "M", "name": "thread_sort_index", "pid": pid,
                         "tid": tids[key],
                         "args": {"sort_index": _lane_sort_index(lane)}})
        return tids[key]

    events: list[dict] = []
    for s in tracer.spans:
        pid = _pid(_process_for(s.lane, s.tags))
        events.append({
            "name": s.name, "cat": s.cat, "ph": "X",
            "ts": s.start, "dur": s.end - s.start,
            "pid": pid, "tid": _tid(pid, s.lane),
            "args": _json_tags(s.tags),
        })
    for i in tracer.instants:
        pid = _pid(_process_for(i.lane, i.tags))
        events.append({
            "name": i.name, "cat": "instant", "ph": "i", "s": "t",
            "ts": i.ts, "pid": pid, "tid": _tid(pid, i.lane),
            "args": _json_tags(i.tags),
        })
    for c in tracer.counters:
        pid = _pid(_process_for(c.lane, c.tags))
        events.append({
            "name": c.name, "ph": "C", "ts": c.ts,
            "pid": pid, "tid": _tid(pid, c.lane),
            "args": {"value": c.value},
        })
    # metadata first so viewers name tracks before populating them; events
    # in timestamp order (stable on ties, preserving emission order)
    events.sort(key=lambda e: e["ts"])
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def validate_trace(doc: dict) -> list[str]:
    """Schema problems of a Trace Event document (empty list = loadable).
    The checks mirror what ``chrome://tracing`` / Perfetto require of the
    JSON object format; the CI gate and the golden-trace test share them."""
    problems: list[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents missing or not a list"]
    for idx, ev in enumerate(events):
        where = f"traceEvents[{idx}]"
        if not isinstance(ev, dict):
            problems.append(f"{where}: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "C", "M"):
            problems.append(f"{where}: unknown ph {ph!r}")
            continue
        if ph == "M":
            if ev.get("name") not in ("process_name", "thread_name",
                                      "thread_sort_index"):
                problems.append(f"{where}: unknown metadata {ev.get('name')!r}")
            continue
        for field in ("name", "ts", "pid", "tid"):
            if field not in ev:
                problems.append(f"{where}: missing {field!r}")
        if ph == "X":
            if "dur" not in ev:
                problems.append(f"{where}: X event missing dur")
            elif ev["dur"] < 0:
                problems.append(f"{where}: negative dur {ev['dur']}")
    return problems


def trace_power(tracer: Tracer, report) -> None:
    """Emit per-lane ``power[<lane>]`` counter samples onto ``tracer``
    from a finished report's resource telemetry: each lane steps to its
    active draw at every busy-interval edge (pJ/cycle — reads as mW at
    1 GHz in the viewer). No-op for runs without an attached PowerSpec."""
    from ..power.meter import power_counter_series
    for lane, points in power_counter_series(report).items():
        host, _, res = lane.rpartition("/")
        for ts, watts in points:
            if host:
                tracer.counter(f"power[{res}]", ts, watts, lane=f"power[{res}]",
                               host=host)
            else:
                tracer.counter(f"power[{res}]", ts, watts, lane=f"power[{res}]")


def write_trace(tracer: Tracer, path: str, *, attribution=None,
                metrics=None, energy=None) -> dict:
    """Export ``tracer`` to ``path`` as Perfetto-loadable JSON; returns the
    written document. ``attribution`` (an
    :class:`~repro.obs.attribution.AttributionReport`), ``metrics`` (a
    :class:`~repro.obs.metrics.MetricsRegistry`), and ``energy`` (a
    :class:`~repro.power.meter.EnergyReport`) are embedded as extra
    top-level keys — trace viewers ignore them, the CI gate reads them."""
    doc = chrome_trace(tracer)
    if attribution is not None:
        doc["attribution"] = attribution.to_dict()
    if metrics is not None:
        doc["metrics"] = metrics.collect()
    if energy is not None:
        doc["energy"] = energy.to_dict()
    problems = validate_trace(doc)
    assert not problems, problems
    with open(path, "w") as f:
        json.dump(doc, f, indent=1)
    return doc
