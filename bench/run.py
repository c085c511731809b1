"""Run one cell of the port's benchmark once, on the machine it starts on.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell is an entry of ``BENCHMARK.json``.
With ``--trace 0`` the last line of standard output is a JSON object with
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics;
each names ``correct``, the numbers compared last. The exit code is not 0,
and no result is printed, where no CUDA device (or fewer than the cell
asks for) is found, where the program is missing, or where JAX or the JAX
package was loaded. The program's one kernel on this path is built by
``nvcc`` into ``src/repro_torch/kernels/build/`` of the checkout; the
program sets no other build or kernel cache.
"""

import time

T_START = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]
    from bench import harness

    try:
        spec = harness.manifest()
        cell = harness.load_cell(args.workload)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            raise harness.Refused(f"cell {cell.name} needs {cell.chips} CUDA device(s); found "
                                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        entry = importlib.import_module(f"bench.entries.{cell.traffic['entry']}")
        result = entry.run(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
        found = harness.forbidden_modules()
        if found:
            raise harness.Refused(f"loaded in this process: {', '.join(found)}")
        line = harness.result_line(spec, cell, result, bool(args.trace))
    except (harness.Refused, ImportError) as e:
        print(f"bench: {type(e).__name__}: {e}", file=sys.stderr)
        return 2
    for text in result.notes:
        print(text, file=sys.stderr)
    for text in harness.compared_lines(line["compared"]):
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
