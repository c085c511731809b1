"""Multi-pod dry run: trace one (arch × shape × mesh) cell on the production
mesh, in one process, on meta tensors.

The counterpart of ``repro/launch/dryrun.py``. The reference fakes 512
host devices, AOT-lowers and compiles the sharded step, and reads XLA's
memory and cost analyses and the collectives of the compiled HLO. The port
starts a ``fake`` process group of 256 (or 512) ranks in this one process,
builds the production ``DeviceMesh`` over it, gives the step DTensors of
meta local shards with the ``distributed`` placements
(``steps.abstract_cell_args``) and runs it once as rank 0: nothing is
allocated or computed, and the collectives go nowhere, but every op is
dispatched with its local shapes and every collective the placements
force is issued.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k [--multi-pod] [--preset optimized] \\
        [--override k=v] [--out results/cell.json]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] \\
        [--out results/cells.json] [--placements DIR]

``--all`` traces every applicable cell of ``configs.cells()``, a cell a
process (each its own ``fake`` process group), half the host's cores at a
time, and prints a line a cell and the total seconds. A cell that raises
is recorded ``{"status": "failed", "error": ...}`` and the command exits
1. ``--placements`` writes the placements of every op the step gives
DTensor (``distributed.spmd.recording``) to a file (one cell) or a file a
cell in a directory (``--all``): the plans of two torches compare line by
line.

The record keeps the reference's keys where a torch twin exists:

* ``per_device_bytes``: the bytes of a device's arguments (params,
  optimizer state, inputs, cache) from the placements' local shapes, split
  by tree in ``arg_bytes``;
* ``hlo_flops``: a device's FLOPs times the chips. They are counted by
  ``torch.utils.flop_counter``'s formulas (``FlopCounterMode``'s) on the
  local ops each DTensor op and each local region (the MoE all-to-all's
  experts) dispatches, so the count is what every device computes,
  replicated work included, as the reference's ``cost_analysis`` of the
  partitioned program times the chips is; a ``FlopCounterMode`` around
  DTensor ops would count their global shapes instead;
* ``collectives``: the count of each collective from ``CommDebugMode``
  and its per-device wire bytes by the reference's ring formulas
  (``hlo_analysis._wire_bytes``) from the collective's result size and
  group size; ``coll_bytes`` is their sum and ``collective_s`` each over
  the link its group crosses; ``collectives_by_op`` counts each kind by
  the op that issued it (``distributed.spmd.current_op``: an aten op,
  ``constrain`` at a layer boundary, ``other`` outside both: a
  redistribution's backward, the optimizer's placements), and
  ``flops_by_op`` splits ``hlo_flops`` so;
* the ``RooflineTerms`` (``hlo_analysis``), on the H100's constants.

Keys with no torch twin, left out: ``compile_s`` (there is no compilation;
``trace_s`` is the traced step's seconds) and ``memory_analysis`` (XLA's
buffer assignment: arguments, outputs, aliases and temporaries; the port
records its arguments alone); ``hlo_bytes`` stands for the arguments'
bytes on every device, read once, where the reference's is XLA's "bytes
accessed". The reference's second, unrolled lowering for exact FLOPs is
not needed: the port's layers are a Python loop, traced whole.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils.flop_counter import flop_registry

from ..configs import SHAPES, applicable, cells, get
from ..distributed.sharding import named_leaves
from ..distributed.spmd import _F32_OUT, current_op, recording, trips
from ..models.model import Model
from ..optim import AdamW
from . import steps as steps_lib
from .hlo_analysis import CollectiveStats, RooflineTerms
from .mesh import make_production_mesh


def optimized_policy(cfg, shape_kind: str, global_batch: int = 0,
                     chips: int = 256) -> dict:
    """The best-known distribution policy per (family × step kind), derived
    from the §Perf hillclimb (EXPERIMENTS.md). This is the beyond-paper
    configuration — the baseline tables use the naive defaults."""
    over: dict = {}
    if cfg.n_experts:
        over["moe_impl"] = "shard_map"  # explicit a2a EP (all step kinds)
    if shape_kind in ("train", "prefill"):
        over["attn_chunk"] = 512  # flash-style attention on the XLA path
        if shape_kind == "train":
            over["grad_compression"] = "bf16"
        # GQA/odd head counts that don't divide the 16-way model axis force
        # S² score resharding: replicate attention, keep TP in the MLPs.
        # RWKV: TP in the time-mix puts a reduce inside every scan step.
        if cfg.family == "ssm" or (
            cfg.n_kv_heads and (cfg.n_kv_heads % 16 or cfg.n_heads % 16)
        ):
            over["tp_attention"] = 0
        if cfg.family == "hybrid":
            over["ssm_chunk"] = 512  # SSD-style chunked Mamba scan (memory)
        if (
            cfg.param_count() < 2e9
            and shape_kind == "train"
            and global_batch % chips == 0  # the batch must tile every chip
        ):
            over["pure_dp"] = 1
            over.pop("tp_attention", None)
    else:  # decode
        over["cache_shard_seq"] = 1  # flash-decoding cache layout
    return over


# the functional collectives' kinds, as the reference's HLO names them
_KINDS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


class _Counter(CommDebugMode):
    """``CommDebugMode`` (it counts the collectives) that also adds up the
    local ops' FLOPs and each collective's wire bytes. A DTensor op is
    handed on to DTensor (``CommDebugMode`` returns ``NotImplemented``), so
    what is counted here is what it dispatches: local ops and
    collectives."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.stats = CollectiveStats()
        self.by_op: dict[str, dict[str, int]] = {}
        self.flops_by_op: dict[str, int] = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = super().__torch_dispatch__(func, types, args, kwargs)
        if out is NotImplemented or isinstance(func, torch._ops.HigherOrderOperator):
            return out
        kind = _KINDS.get(func._overloadpacket.__name__)
        if kind is not None and func.namespace.startswith("_c10d_functional"):
            group = dist.distributed_c10d._resolve_process_group(args[-1])
            result = out if isinstance(out, torch.Tensor) else out[0]
            for _ in range(trips()):
                self.stats.add(kind, result.numel() * result.element_size(), group.size())
            kinds = self.by_op.setdefault(current_op() or "other", {})
            kinds[kind] = kinds.get(kind, 0) + trips()
        count = flop_registry.get(func._overloadpacket)
        if func in _F32_OUT.values():  # the product's count takes its two operands
            args = args[:2]
        if count is not None and not any(isinstance(a, FakeTensor) for a in args):
            # (DTensor runs each op once on fake tensors of the global shapes,
            # for the output's metadata: that run computes nothing)
            n = trips() * count(*args, **(kwargs or {}), out_val=out)
            self.flops += n
            op = current_op() or "other"
            self.flops_by_op[op] = self.flops_by_op.get(op, 0) + n
        return out


def _fake_world(size: int) -> None:
    """A ``fake`` process group of ``size`` ranks in this process, as rank 0."""
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return
        dist.destroy_process_group()
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)


def _local_bytes(tree) -> int:
    total = 0
    for _, leaf in named_leaves(tree):
        local = leaf.to_local() if isinstance(leaf, DTensor) else leaf
        total += local.numel() * local.element_size()
    return total


def run_cell(arch: str, shape_name: str, multi_pod: bool, overrides: dict | None = None,
             preset: str = "", placements: str = "") -> dict:
    """One dry-run cell: the record described in the module's docstring, or
    ``{"status": "skipped", "reason": ...}`` where :func:`applicable` says no.
    The reference's ``donate`` has no twin: the port's steps take no
    donation. ``placements`` names a file for the ops' placements."""
    cfg = get(arch)
    shape = SHAPES[shape_name]
    chips = 512 if multi_pod else 256
    if preset == "optimized":
        cfg = dataclasses.replace(
            cfg, **optimized_policy(cfg, shape.kind, shape.global_batch, chips))
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    ok, reason = applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "status": "skipped", "reason": reason}

    _fake_world(chips)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    optimizer = AdamW() if shape.kind == "train" else None
    model = Model(cfg, device="meta")
    step = steps_lib.build_step_for(model, shape, optimizer)
    kind, args, _ = steps_lib.abstract_cell_args(model, shape, mesh, optimizer)
    names = {"train": ("params", "opt_state", "inputs"), "prefill": ("params", "inputs"),
             "decode": ("params", "cache", "inputs", "inputs")}[kind]
    arg_bytes: dict[str, int] = {}
    for name, arg in zip(names, args):
        arg_bytes[name] = arg_bytes.get(name, 0) + _local_bytes(arg)
    t0 = time.time()
    with _Counter() as counter, recording() as log:
        step(*args)
    trace_s = time.time() - t0
    if placements:
        os.makedirs(os.path.dirname(placements) or ".", exist_ok=True)
        with open(placements, "w") as f:
            f.write("\n".join(log) + "\n")

    counts = {str(k).split(".")[-1]: v for k, v in counter.get_comm_counts().items()}
    stats = counter.stats
    per_device = sum(arg_bytes.values())
    n_active = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if kind in ("train", "prefill") else 1)
    terms = RooflineTerms(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=float(counter.flops * chips),
        hlo_bytes=float(per_device * chips),
        coll_bytes=stats.total_bytes,
        model_flops=(6 if kind == "train" else 2) * n_active * tokens,
        per_device_bytes=per_device,
        collectives={k: {"bytes": stats.bytes_by_kind[k], "count": stats.count_by_kind[k]}
                     for k in stats.bytes_by_kind},
        coll_s=stats.seconds,
    )
    return {"status": "ok", "kind": kind, "trace_s": trace_s, "arg_bytes": arg_bytes,
            "comm_counts": counts, "collectives_by_op": counter.by_op,
            "flops_by_op": {k: float(v * chips) for k, v in counter.flops_by_op.items()},
            "torch": torch.__version__, **terms.to_dict()}


def _cell_args(args, arch: str, shape: str) -> list[str]:
    out = ["--arch", arch, "--shape", shape]
    if args.multi_pod:
        out.append("--multi-pod")
    if args.preset:
        out += ["--preset", args.preset]
    for item in args.override:
        out += ["--override", item]
    return out


def _in_subprocess(args, arch: str, shape: str) -> dict:
    """One cell in a process of its own: its record, or a ``failed`` one
    with the end of its errors."""
    src = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [src, *filter(None, [os.environ.get("PYTHONPATH")])])}
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cell.json")
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", *_cell_args(args, arch, shape),
               "--out", out]
        if args.placements:
            cmd += ["--placements", os.path.join(args.placements, f"{arch}__{shape}.txt")]
        t0 = time.time()
        run = subprocess.run(cmd, capture_output=True, text=True, env=env)
        wall = time.time() - t0
        if run.returncode == 0 and os.path.exists(out):
            with open(out) as f:
                return {**json.load(f), "wall_s": wall}
    return {"arch": arch, "shape": shape, "mesh": "pod2x16x16" if args.multi_pod else "pod16x16",
            "status": "failed", "error": run.stderr[-2000:], "wall_s": wall}


def _line(r: dict) -> str:
    head = f"[dryrun] {r['arch']} × {r['shape']} × {r['mesh']}:"
    if r["status"] != "ok":
        said = (r.get("error") or r.get("reason") or "").strip().splitlines()
        return f"{head} {r['status'].upper()} in {r['wall_s']:.1f} s: " + "".join(said[-1:])
    return (f"{head} {r['trace_s']:.1f} s, "
            f"{r['per_device_bytes'] / 2**30:.2f} GiB a device, flops/model "
            f"{r['hlo_flops'] / r['model_flops']:.2f}, dominant {r['dominant']}, "
            f"collectives { {k: v['count'] for k, v in r['collectives'].items()} }")


def _run_all(args) -> int:
    t0 = time.time()
    todo = [(arch.name, shape.name) for arch, shape, _, _ in cells()]
    records = []
    with ThreadPoolExecutor(max(1, (os.cpu_count() or 2) // 2)) as pool:
        for fut in [pool.submit(_in_subprocess, args, a, s) for a, s in todo]:
            records.append(fut.result())
            print(_line(records[-1]), flush=True)
    failed = sum(r["status"] == "failed" for r in records)
    print(f"[dryrun] {len(records)} cells, {failed} failed, in {time.time() - t0:.1f} s "
          f"(torch {torch.__version__})")
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(records, f, indent=2)
    return 1 if failed else 0


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--arch")
    p.add_argument("--shape")
    p.add_argument("--all", action="store_true", help="every applicable cell of cells()")
    p.add_argument("--multi-pod", action="store_true")
    p.add_argument("--out", default="")
    p.add_argument("--preset", default="", choices=("", "optimized"),
                   help="optimized = best-known policy from §Perf hillclimbs")
    p.add_argument("--override", action="append", default=[],
                   help="cfg overrides, e.g. --override remat=dots")
    p.add_argument("--placements", default="",
                   help="write each op's placements: a file (one cell) or a directory (--all)")
    args = p.parse_args()
    if args.all:
        sys.exit(_run_all(args))

    overrides = {}
    for item in args.override:
        k, v = item.split("=", 1)
        try:
            v = int(v)
        except ValueError:
            pass
        overrides[k] = v

    if not (args.arch and args.shape):
        p.error("--arch and --shape, or --all")
    record = run_cell(args.arch, args.shape, args.multi_pod, overrides=overrides or None,
                      preset=args.preset, placements=args.placements)

    if record["status"] == "ok":
        print(f"[dryrun] {args.arch} × {args.shape} × {record['mesh']}: TRACED "
              f"in {record['trace_s']:.1f}s")
        print(f"  bytes/device (arguments): {record['per_device_bytes']/2**30:.2f} GiB "
              f"{record['arg_bytes']}")
        print(f"  flops (global): {record['hlo_flops']:.3e}")
        print(f"  collectives: {record['collectives']}")
        print(f"  roofline terms (s): compute={record['compute_s']:.4e} "
              f"memory={record['memory_s']:.4e} collective={record['collective_s']:.4e}"
              f"  dominant={record['dominant']}")
        print(f"  MODEL_FLOPS={record['model_flops']:.3e} "
              f"useful/HLO={record['useful_flops_ratio']:.3f} "
              f"roofline_fraction={record['roofline_fraction']:.3f}")
    else:
        print(f"[dryrun] {args.arch} × {args.shape}: SKIPPED — {record['reason']}")

    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(record, f, indent=2)
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
