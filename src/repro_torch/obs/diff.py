"""Differential trace comparison: decompose a regression into components.

The port's own copy of ``repro/obs/diff.py``: the code is the
reference's, unchanged.

When a CI geomean floor trips, the interesting question is never "did it
get slower" (the gate already said so) but *where the cycles went*. This
module compares two runs — trace documents (``TRACE_*.json`` as
``obs.export.write_trace`` wrote them), attribution dicts, or live
:class:`~repro.obs.attribution.AttributionReport` objects — and
decomposes the makespan delta into per-lane, per-component deltas plus
metric-total deltas, ranked by magnitude.

**Stable lane matching.** Lanes match by name first. Lanes left unmatched
are then paired by kind when each side has exactly one of that kind —
a run that moved from ``cfg[noc]`` to ``cfg[noc2]`` still diffs its wire
against the other run's wire (reported as ``renamed``). Anything still
unmatched is ``added``/``removed`` with its full busy time as the delta.

Deliberately stdlib-only with **no package-relative imports**:
``benchmarks/obs_gate.py`` loads this file by path (no ``PYTHONPATH``) to
pre-triage floor failures in CI, so it must import standalone.
"""

from __future__ import annotations

__all__ = ["diff", "render"]


def _attribution(x) -> dict:
    """Coerce any accepted input to an attribution dict."""
    if hasattr(x, "to_dict"):
        x = x.to_dict()
    assert isinstance(x, dict), f"cannot diff a {type(x).__name__}"
    if "attribution" in x:  # a full trace document
        return x["attribution"]
    assert "lanes" in x, "not an attribution: no 'lanes' key"
    return x


def _metrics(x) -> dict:
    """name+labels -> scalar value, for inputs that carry a metrics block
    (counters/gauges use their value; histograms their total)."""
    rows = x.get("metrics", []) if isinstance(x, dict) else []
    out = {}
    for row in rows:
        key = row["name"] + "".join(
            f"{{{k}={v}}}" for k, v in sorted(row.get("labels", {}).items()))
        out[key] = row.get("value", row.get("total", 0.0))
    return out


def _busy(lane: dict) -> float:
    return sum(v for k, v in lane["components"].items() if k != "idle")


def _match_lanes(base: dict, other: dict) -> list:
    """[(base_name, other_name, status)] — by name, then kind-singleton."""
    pairs = [(n, n, "matched") for n in base if n in other]
    left = {n: l for n, l in base.items() if n not in other}
    right = {n: l for n, l in other.items() if n not in base}
    for kind in ("host", "wire", "compute"):
        lk = [n for n, l in sorted(left.items()) if l["kind"] == kind]
        rk = [n for n, l in sorted(right.items()) if l["kind"] == kind]
        if len(lk) == 1 and len(rk) == 1:
            pairs.append((lk[0], rk[0], "renamed"))
            del left[lk[0]]
            del right[rk[0]]
    pairs.extend((n, None, "removed") for n in sorted(left))
    pairs.extend((None, n, "added") for n in sorted(right))
    return pairs


def diff(base, other) -> dict:
    """Compare two runs; deltas are ``other − base`` (positive = the
    second run spent more). Returns a JSON-ready dict whose ``ranked``
    list names the largest per-lane component movements first — the
    triage order."""
    base_doc = base if isinstance(base, dict) else {}
    other_doc = other if isinstance(other, dict) else {}
    a = _attribution(base)
    b = _attribution(other)
    out: dict = {
        "makespan": {
            "base": a["makespan"], "other": b["makespan"],
            "delta": b["makespan"] - a["makespan"],
        },
        "exposed_config": {
            "base": a["exposed_config"], "other": b["exposed_config"],
            "delta": b["exposed_config"] - a["exposed_config"],
        },
    }
    summary = {}
    for key in sorted(set(a["summary"]) | set(b["summary"])):
        av = a["summary"].get(key, 0.0)
        bv = b["summary"].get(key, 0.0)
        summary[key] = {"base": av, "other": bv, "delta": bv - av}
    out["summary"] = summary

    lanes: dict = {}
    ranked: list = []
    for base_name, other_name, status in _match_lanes(a["lanes"], b["lanes"]):
        name = other_name or base_name
        la = a["lanes"].get(base_name, {"components": {}}) if base_name else \
            {"components": {}}
        lb = b["lanes"].get(other_name, {"components": {}}) if other_name \
            else {"components": {}}
        comps = {}
        for key in sorted(set(la["components"]) | set(lb["components"])):
            av = la["components"].get(key, 0.0)
            bv = lb["components"].get(key, 0.0)
            comps[key] = {"base": av, "other": bv, "delta": bv - av}
            if key != "idle" and bv != av:
                ranked.append({"lane": name, "component": key,
                               "delta": bv - av})
        entry: dict = {"status": status, "components": comps}
        if status == "renamed":
            entry["base_lane"] = base_name
        lanes[name] = entry
    ranked.sort(key=lambda r: (-abs(r["delta"]), r["lane"], r["component"]))
    out["lanes"] = lanes
    out["ranked"] = ranked

    ma, mb = _metrics(base_doc), _metrics(other_doc)
    if ma or mb:
        out["metrics"] = {
            key: {"base": ma.get(key, 0.0), "other": mb.get(key, 0.0),
                  "delta": mb.get(key, 0.0) - ma.get(key, 0.0)}
            for key in sorted(set(ma) | set(mb))
            if mb.get(key, 0.0) != ma.get(key, 0.0)
        }
    return out


def render(d: dict, top: int = 8) -> str:
    """Human triage view of a :func:`diff` result."""
    mk = d["makespan"]
    sign = "+" if mk["delta"] >= 0 else ""
    out = [
        f"trace diff — makespan {mk['base']:.1f} → {mk['other']:.1f} "
        f"({sign}{mk['delta']:.1f} cycles)",
        f"exposed config {d['exposed_config']['base']:.1f} → "
        f"{d['exposed_config']['other']:.1f}",
        "largest component movements (other − base):",
    ]
    for row in d["ranked"][:top]:
        out.append(f"  {row['delta']:>+10.1f}  {row['lane']} / "
                   f"{row['component']}")
    if not d["ranked"]:
        out.append("  (no component moved)")
    extra = [name for name, lane in sorted(d["lanes"].items())
             if lane["status"] in ("added", "removed", "renamed")]
    if extra:
        out.append("lane matching: " + ", ".join(
            f"{n} [{d['lanes'][n]['status']}]" for n in extra))
    return "\n".join(out)
