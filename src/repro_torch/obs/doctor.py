"""``python -m repro_torch.obs.doctor TRACE.json [--against OTHER.json]``

The port's own copy of ``repro/obs/doctor.py``: the code is the
reference's, unchanged.

The command-line face of the diagnosis layer: feed it a trace a benchmark
wrote with ``--trace-out`` and it prints the config-wall doctor's
transcript (regime, lane table, ranked recommendations). With
``--against`` it also renders the differential decomposition of the two
runs — the triage view a CI floor failure ships as a ``DIAG_*.json``
artifact. ``--json`` writes the machine-readable version alongside.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import diff as _diff
from .diagnose import diagnose_doc


def load_trace(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    assert isinstance(doc, dict) and "attribution" in doc, (
        f"{path} is not a trace with an attribution block — re-export it "
        f"with --trace-out (obs.export.write_trace embeds attribution)")
    return doc


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.doctor",
        description="Diagnose a config-wall trace: regime classification, "
                    "per-lane breakdown, ranked mitigations.")
    ap.add_argument("trace", help="TRACE_*.json written via --trace-out")
    ap.add_argument("--against", metavar="OTHER",
                    help="second trace to diff this one against "
                         "(deltas are TRACE − OTHER)")
    ap.add_argument("--json", metavar="OUT", dest="json_out",
                    help="also write the diagnosis (and diff) as JSON")
    args = ap.parse_args(argv)

    doc = load_trace(args.trace)
    diag = diagnose_doc(doc)
    print(diag.render())

    payload: dict = {"diagnosis": diag.to_dict()}
    if args.against:
        other = load_trace(args.against)
        d = _diff.diff(other, doc)  # deltas read as "this trace − baseline"
        print()
        print(_diff.render(d))
        payload["diff"] = d
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"\nwrote {args.json_out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
