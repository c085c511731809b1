"""What every cell shares: finding its files by name, the look for JAX,
and the result line.

A cell of ``BENCHMARK.json`` names a configuration (its file in the
manifest), a traffic mix (``bench/traffic/<traffic>.json``, whose ``entry``
names a module of ``bench/entries``) and its own limits
(``bench/limits/<cell>.json``). A per-layer metric is read by
``bench/metrics/<name>.py``; a family's counts and reference are
``bench/counts/<family>.py`` and ``bench/reference/<family>.py``.

The program runs a configuration's registered ``ModelConfig``, cut where
the file says so (:func:`program_config`): to the file's depth, where the
file lists the key that sets it under ``reduced``, and with the few settings
of :data:`SETTINGS` that its ``"program"`` mapping puts over it.
"""

from __future__ import annotations

import importlib
import json
import sys
from dataclasses import dataclass, replace
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
BENCH = ROOT / "bench"
# top-level module names that no run may hold once its window has closed:
# JAX, its libraries, the JAX package and the JAX package's own benchmarks
FORBIDDEN = ("jax", "jaxlib", "flax", "repro", "benchmarks")
# the one ModelConfig field that a cut to a card changes: depth
CUT = "n_layers"
# the ModelConfig fields that a file's "program" may set, each with a reason
# under "assumed": settings of the published model that the port's defaults
# do not state, never a precision, a width or a kernel route
SETTINGS = frozenset({"capacity_factor"})


class Refused(Exception):
    """A run that ends without a result line."""


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict  # name -> {"limit": ..., readings it was set from}

    def module(self, kind: str):
        """``bench.<kind>.<family>`` for this cell's configuration."""
        return importlib.import_module(f"bench.{kind}.{self.config['family']}")


def _json(path: Path) -> dict:
    try:
        return json.loads(path.read_text())
    except FileNotFoundError as e:
        raise Refused(f"missing {path.relative_to(ROOT)}") from e


def manifest(root: Path = ROOT) -> dict:
    return _json(root / "BENCHMARK.json")


def load_cell(name: str, root: Path = ROOT) -> Cell:
    spec = manifest(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise Refused(f"no cell {name!r} in BENCHMARK.json; cells: {sorted(cells)}")
    w = cells[name]
    config = _json(root / {c["name"]: c for c in spec["configs"]}[w["config"]]["file"])
    return Cell(name, w["chips"], config, _json(BENCH / "traffic" / f"{w['traffic']}.json"),
                _json(BENCH / "limits" / f"{name}.json"))


def cut_refusals(registered, config: dict, program_fields) -> list[str]:
    """Where a configuration file breaks the rules of a cut. Its numbers
    (``program_fields(config)``) are the registered configuration's, but
    depth (:data:`CUT`), which may be less only where the file lists the key
    that sets it under ``reduced`` and that key's ``published`` value gives
    the registered depth. Its ``"program"`` holds only :data:`SETTINGS`, each
    with a reason under ``assumed``."""
    published = {k: v for k, v in config.get("published", {}).items() if k in config["reduced"]}
    as_published = program_fields({**config, **published})
    out = []
    for key, value in program_fields(config).items():
        was = getattr(registered, key)
        if value == was:
            continue
        if key != CUT:
            out.append(f"{key} {value!r} (registered {was!r}): a cut changes depth alone")
        elif as_published[key] != was or value > was:
            out.append(f"{key} {value!r} (registered {was!r}): no key of reduced has a "
                       f"published value that gives {was!r}")
    for key, value in config.get("program", {}).items():
        if key not in SETTINGS:
            out.append(f"{key} is no setting that a file may change ({', '.join(sorted(SETTINGS))})")
        elif key not in config.get("assumed", {}):
            out.append(f"{key} {value!r} (registered {getattr(registered, key)!r}) has no "
                       f"reason under assumed")
    return out


def program_config(registered, config: dict, program_fields):
    """The configuration that the program runs: the registered one at the
    file's depth, with the file's ``"program"`` settings over it."""
    refused = cut_refusals(registered, config, program_fields)
    if refused:
        raise Refused(f"the cut of {config['name']}: {'; '.join(refused)}")
    return replace(registered, **{CUT: program_fields(config)[CUT]}, **config.get("program", {}))


def metrics_of(spec: dict, cell: str, kind: str) -> list[dict]:
    """The cell's metrics of ``kind`` (``end_to_end`` or ``per_layer``)."""
    return [m for m in spec[kind] if cell in m.get("workloads", [cell])]


def forbidden_modules() -> list[str]:
    """Loaded modules whose whole top-level name is forbidden (``repro_torch``
    is not ``repro``)."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


def per_layer(spec: dict, cell: str, window) -> dict:
    """Each per-layer metric of the cell that its reader finds, with its unit."""
    out = {}
    for m in metrics_of(spec, cell, "per_layer"):
        value = importlib.import_module(f"bench.metrics.{m['name']}").read(window)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def compared_lines(compared: dict) -> list[str]:
    return [f"compared {name} {c['value']!r} limit {c['limit']!r}" for name, c in compared.items()]


def result_line(spec: dict, cell: Cell, result, trace: bool) -> dict:
    """The JSON object of the run's last line of standard output."""
    if trace:
        metrics = per_layer(spec, cell.name, result.window)
    else:
        units = {m["name"]: m["unit"] for m in metrics_of(spec, cell.name, "end_to_end")}
        metrics = {name: {"value": value, "unit": units[name]}
                   for name, value in result.end_to_end.items() if name in units}
    device = {"platform": "gpu", "kind": result.device_kind, "count": cell.chips,
              "memory_peak_bytes": result.memory_peak_bytes}
    line = {"correct": result.correct, "attempted": result.attempted, "failed": result.failed,
            "metrics": metrics, "device": device}
    span = getattr(result.window, "span", None)
    if trace and span is not None:
        device.update(busy_s=span.busy_s, window_s=span.window_s)
        line["breakdown"] = span.breakdown()
    line["compared"] = result.compared
    return line
