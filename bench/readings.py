"""The readings that a cell's limit is set from, on the machine this runs on.

    python3 bench/readings.py --workload <cell> --seeds 1,2,3 [--control 3] [--fault <name>]

For each seed: the weights drawn from it, one ``serve()`` call at the
cell's own batch, steps and cache length, and the widest reference-logit
gap of its outputs (the number a run compares); for the first ``--control``
seeds also the control's, the gap of the tokens that the reference with
fp8 products puts first at the same inputs. With ``--fault``, the program
runs with a fault of ``bench.faults.TIME_MIX`` planted (an RWKV cell), and
its gap is the fault's reading. One JSON line a seed; the model is set up
once.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seeds: list[int], controls: int, device: str = "cuda", arch=None,
             shape: dict | None = None, fault: str | None = None):
    """Yields ``{"seed", "program", "control"}`` a seed (``control`` None
    past the first ``controls`` seeds); ``shape`` overrides the traffic's
    batch or steps (a test's shorter run); ``fault`` names a fault of
    ``bench.faults.TIME_MIX`` planted in the program's calls."""
    import contextlib
    import dataclasses

    import torch

    from bench.entries.serve_fused import Program, _Warmups, judge
    from bench.faults import TIME_MIX

    if shape:
        cell = dataclasses.replace(cell, traffic={**cell.traffic, **shape})
    prog = Program(cell, device, arch)
    for i, seed in enumerate(seeds):
        t = time.perf_counter()
        params = prog.weights(cell, seed)
        warmups = _Warmups(prog.ops)
        planted = TIME_MIX[fault](prog.cfg.n_layers) if fault else contextlib.nullcontext()
        try:
            with planted:
                calls = [prog.call(params, warmups)]
        finally:
            warmups.close()
        sequences, failed = prog.sequences(calls)
        del calls
        program = judge(cell, params, sequences, seed, device) if len(sequences) else None
        control = judge(cell, params, sequences, seed, device, control=True) \
            if i < controls and len(sequences) else None
        yield {"seed": seed, "program": program, "control": control, "failed": failed,
               "seconds": time.perf_counter() - t}
        del params
        if device == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--control", type=int, default=3, help="seeds that also read the control")
    p.add_argument("--fault", default=None, help="a fault of bench.faults.TIME_MIX to plant")
    args = p.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from bench import harness

    cell = harness.load_cell(args.workload)
    for r in readings(cell, [int(s) for s in args.seeds.split(",")], args.control,
                      fault=args.fault):
        print(json.dumps({"cell": cell.name, "fault": args.fault, **r}), flush=True)


if __name__ == "__main__":
    main()
