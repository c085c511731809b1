"""The port's dry run (``python -m repro_torch.launch.dryrun``): cells traced
on the production meshes over the ``fake`` backend, with JAX and the JAX
package unimportable; its FLOPs, collectives and roofline terms; and the
kernel wrappers' shape-only route on ``meta`` tensors that lets it trace a
MoE router."""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.kernels import ops, sampling
from repro_torch.launch.hlo_analysis import (
    HBM_BW,
    IB_BW,
    NVLINK_BW,
    PEAK_FLOPS,
    CollectiveStats,
    RooflineTerms,
    _wire_bytes,
    link_bw,
)

ROOT = pathlib.Path(__file__).resolve().parents[1]

_CELL_WITHOUT_JAX = """
import runpy, sys
for name in ("jax", "jaxlib", "repro", "ml_dtypes"):
    sys.modules[name] = None
sys.argv = ["dryrun", *sys.argv[1:]]
runpy.run_module("repro_torch.launch.dryrun", run_name="__main__", alter_sys=True)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("no jax")
"""


def _run(tmp_path, *args) -> subprocess.CompletedProcess:
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-c", _CELL_WITHOUT_JAX, *args, "--out",
                           str(tmp_path / "cell.json")],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=600)


def _cell(tmp_path, *args) -> dict:
    out_file = tmp_path / "cell.json"
    out = _run(tmp_path, *args)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "no jax" in out.stdout
    return json.loads(out_file.read_text())


# hlo_flops count what every device computes (replicated work included: a
# batch that does not divide the data axis runs whole on each of its 16
# devices), attention's S² terms and remat's recomputation, over 2·N_active
# (decode) or 6·N_active (train) a token; N_active counts the embedding,
# which a step only gathers, so a recurrent decode's ratio may fall below 1
FLOPS_FACTOR = (0.5, 50.0)


@pytest.mark.parametrize("arch,shape,extra,kind", [
    ("qwen2-0.5b", "train_4k", [], "train"),
    ("phi3.5-moe-42b-a6.6b", "decode_32k", [], "decode"),
    ("rwkv6-7b", "long_500k", [], "decode"),
    ("qwen2-0.5b", "prefill_32k", ["--multi-pod"], "prefill"),
])
def test_the_dry_run_traces_a_cell_without_jax(tmp_path, arch, shape, extra, kind):
    rec = _cell(tmp_path, "--arch", arch, "--shape", shape, *extra)
    assert rec["status"] == "ok" and rec["kind"] == kind
    assert rec["mesh"] == ("pod2x16x16" if extra else "pod16x16")
    assert rec["chips"] == (512 if extra else 256)
    lo, hi = FLOPS_FACTOR
    assert lo <= rec["hlo_flops"] / rec["model_flops"] <= hi, rec["hlo_flops"] / rec["model_flops"]
    # the arguments' bytes a device, by tree, from the placements' local shapes
    assert rec["per_device_bytes"] == sum(rec["arg_bytes"].values())
    assert set(rec["arg_bytes"]) == {"train": {"params", "opt_state", "inputs"},
                                     "prefill": {"params", "inputs"},
                                     "decode": {"params", "cache", "inputs"}}[kind]
    # the placements force redistributions (TP products, the vocabulary-sharded
    # head, ZeRO's gathers): collectives, each with its wire bytes
    counts = {k: v["count"] for k, v in rec["collectives"].items()}
    assert counts.get("all-gather", 0) > 0 and counts.get("all-reduce", 0) > 0
    assert rec["coll_bytes"] == sum(v["bytes"] for v in rec["collectives"].values()) > 0
    assert rec["dominant"] in ("compute", "memory", "collective")
    terms = RooflineTerms(arch, shape, rec["mesh"], rec["chips"], rec["hlo_flops"],
                          rec["hlo_bytes"], rec["coll_bytes"], rec["model_flops"],
                          rec["per_device_bytes"], coll_s=rec["collective_s"])
    assert terms.to_dict() | {"collectives": rec["collectives"]} == \
        {k: rec[k] for k in terms.to_dict()}


def _plan() -> dict:
    """The one plan, whatever the torch: each collective's count by kind and
    the FLOPs over the model's, as torch 2.13 (here) and 2.11 (the H100
    machine's) both trace them: ``chip_smoke.py``'s ``DRYRUN_CELLS``, which
    its ``[dryrun]`` phase holds the card machine's torch to, and jamba's
    decode."""
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    return {**chip_smoke.DRYRUN_CELLS,
            ("jamba-1.5-large-398b", "decode_32k", False): (
                {"all-gather": 279, "all-reduce": 253}, 9.924046891706395)}


PLAN = _plan()


@pytest.mark.parametrize("arch,shape,pods", list(PLAN))
def test_the_one_plan_pins_each_collective_count(tmp_path, arch, shape, pods):
    """A torch that plans a cell otherwise (another collective, another
    placement of an op's output) fails here: the counts by kind are equal
    and the FLOPs within 1e-6. Every collective is charged to the op that
    issued it; whisper's decode's all-gathers are its cross-attention's
    per-row ``select`` of the batch-split encoder K/V (``layers.cross_attend``,
    a ``bmm`` a batch row: 24 layers × 128 rows × q, k and v), and
    qwen2-0.5b's embedding is looked up into a partial sum (rule 7)."""
    placements = tmp_path / "placements.txt"
    rec = _cell(tmp_path, "--arch", arch, "--shape", shape, *(["--multi-pod"] if pods else []),
                "--placements", str(placements))
    want, ratio = PLAN[(arch, shape, pods)]
    assert rec["status"] == "ok" and rec["mesh"] == ("pod2x16x16" if pods else "pod16x16")
    assert {k: v["count"] for k, v in rec["collectives"].items()} == want
    assert rec["hlo_flops"] / rec["model_flops"] == pytest.approx(ratio, rel=1e-6)
    by_op = {}
    for kinds in rec["collectives_by_op"].values():
        for kind, n in kinds.items():
            by_op[kind] = by_op.get(kind, 0) + n
    assert by_op == want
    lines = placements.read_text().splitlines()
    assert lines and all(" -> " in line for line in lines)
    if arch == "whisper-medium":
        assert rec["collectives_by_op"]["aten.select.int"] == {"all-gather": 24 * 128 * 3}
    if arch == "qwen2-0.5b":  # on the step mesh: the batch over pod_data, the vocabulary split
        assert lines[0].startswith("aten.index.Tensor (R,S0)151936x896 (S0,R)32x32768 -> "
                                   "(S0,P)32x32768x896")


@pytest.mark.parametrize("override,status", [((), "ok"), (("no_such_knob=1",), "failed")])
def test_all_traces_a_cell_a_process_and_records_a_refusal(tmp_path, monkeypatch, capsys,
                                                           override, status):
    """``--all`` traces each cell in a process of its own: a cell that
    traces is recorded ``ok``, one that raises (an unknown override) is
    recorded ``failed`` with its error, never skipped, and the command
    exits 1."""
    from repro_torch.launch import dryrun

    one = [c for c in tconfigs.cells() if (c[0].name, c[1].name) == ("qwen2-0.5b", "decode_32k")]
    monkeypatch.setattr(dryrun, "cells", lambda: one)
    out = tmp_path / "cells.json"
    args = argparse.Namespace(multi_pod=False, preset="", override=list(override),
                              placements="", out=str(out))
    assert dryrun._run_all(args) == (status != "ok")
    (rec,) = json.loads(out.read_text())
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["status"]) == \
        ("qwen2-0.5b", "decode_32k", "pod16x16", status)
    if status == "ok":
        assert {k: v["count"] for k, v in rec["collectives"].items()} == \
            {"all-gather": 96, "all-reduce": 73}
    else:
        assert "no_such_knob" in rec["error"]
    said = capsys.readouterr().out
    assert "[dryrun] qwen2-0.5b × decode_32k × pod16x16:" in said
    assert ("FAILED" in said) == (status == "failed")


def test_the_moe_all_to_all_is_traced_under_shard_map(tmp_path):
    rec = _cell(tmp_path, "--arch", "phi3.5-moe-42b-a6.6b", "--shape", "decode_32k",
                "--preset", "optimized")
    a2a = rec["collectives"]["all-to-all"]
    assert a2a["count"] == 2 * 32  # there and back, a layer
    assert a2a["bytes"] > 0


def test_shard_map_refuses_a_batch_the_batch_axes_do_not_divide(tmp_path):
    """jamba-1.5-large-398b at long_500k under ``--preset optimized``
    (``moe_impl="shard_map"``): a batch of 1 over the 16 devices of
    ``data``. The reference's ``shard_map`` refuses to split it; the port's
    all-to-all refuses too, where it would otherwise take each rank's
    shard for an even one and give the step a wrong global shape."""
    out = _run(tmp_path, "--arch", "jamba-1.5-large-398b", "--shape", "long_500k",
               "--preset", "optimized")
    assert out.returncode != 0
    assert "a batch of 1 does not divide the batch axes' 16 devices" in out.stderr
    assert not (tmp_path / "cell.json").exists()


def test_an_inapplicable_cell_is_skipped_with_the_reference_reason(tmp_path):
    rec = _cell(tmp_path, "--arch", "qwen2-0.5b", "--shape", "long_500k")
    assert rec["status"] == "skipped"
    assert rec["reason"] == "full-attention arch: 500k decode skipped per assignment"


_FORWARD_COUNTS = """
import dataclasses, sys, warnings
warnings.filterwarnings("ignore")
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import ShapeSpec, get
from repro_torch.launch import dryrun, steps
from repro_torch.models.model import Model
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
mesh = init_device_mesh("cpu", (4, 4), mesh_dim_names=("data", "model"))
for pure_dp in (0, 1):
    cfg = dataclasses.replace(get("qwen2-0.5b").reduced(), pure_dp=pure_dp)
    model = Model(cfg, device="meta")
    shape = ShapeSpec("t", "prefill", 16, 16)
    kind, args, _ = steps.abstract_cell_args(model, shape, mesh, None)
    with dryrun._Counter() as counter:
        steps.build_step_for(model, shape, None)(*args)
    print("pure_dp", pure_dp, sum(counter.stats.count_by_kind.values()), counter.flops)
"""


def test_collectives_vanish_under_pure_dp_on_the_forward():
    """A forward with every parameter replicated and the batch over every
    axis needs no collective; the default placements do."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _FORWARD_COUNTS], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = dict(line.split(" ", 2)[1:] for line in out.stdout.splitlines()
                 if line.startswith("pure_dp"))
    default, pure = (lines[k].split() for k in ("0", "1"))
    assert int(default[0]) > 0
    assert int(pure[0]) == 0
    assert int(pure[1]) > 0 and int(default[1]) > 0  # both forwards computed


# ------------------------------------------------------------ roofline terms


def test_roofline_terms_on_the_h100_constants():
    assert (PEAK_FLOPS, HBM_BW, NVLINK_BW, IB_BW) == (989.4e12, 3.35e12, 450e9, 50e9)
    assert link_bw(8) == NVLINK_BW and link_bw(16) == IB_BW and link_bw(2) == NVLINK_BW
    t = RooflineTerms("a", "s", "pod16x16", 256, hlo_flops=2 * 989.4e12 * 256,
                      hlo_bytes=3.35e12 * 256 * 0.5, coll_bytes=50e9 * 3,
                      model_flops=989.4e12 * 256, per_device_bytes=1.0)
    assert t.compute_s == pytest.approx(2.0)
    assert t.memory_s == pytest.approx(0.5)
    assert t.collective_s == pytest.approx(3.0)  # no per-link seconds: all over InfiniBand
    assert t.dominant == "collective" and t.step_time_s == pytest.approx(3.0)
    assert t.useful_flops_ratio == pytest.approx(0.5)
    assert t.roofline_fraction == pytest.approx(1.0 / 3.0)
    t2 = RooflineTerms("a", "s", "m", 1, 989.4e12, 0.0, 0.0, 989.4e12, 0.0, coll_s=0.25)
    assert t2.collective_s == 0.25 and t2.dominant == "compute" and t2.roofline_fraction == 1.0


def test_wire_bytes_and_collective_seconds():
    assert _wire_bytes("all-reduce", 1600, 16) == pytest.approx(2 * 1600 * 15 / 16)
    assert _wire_bytes("all-gather", 1600, 16) == pytest.approx(1500)
    assert _wire_bytes("reduce-scatter", 100, 16) == pytest.approx(1500)
    assert _wire_bytes("all-to-all", 1600, 16) == pytest.approx(1500)
    assert _wire_bytes("all-reduce", 1600, 1) == 0.0
    assert _wire_bytes("collective-permute", 7, 4) == 7.0
    s = CollectiveStats()
    s.add("all-gather", 1600, 16)
    s.add("all-gather", 800, 8)
    assert s.count_by_kind == {"all-gather": 2} and s.bytes_by_kind == {"all-gather": 2200}
    assert s.seconds == pytest.approx(1500 / IB_BW + 700 / NVLINK_BW)


# ------------------------------------------------- the wrappers' meta route


def test_sampling_wrappers_give_shapes_on_meta():
    logits = torch.empty((5, 300), dtype=torch.bfloat16, device="meta")
    for fn in (ops.sample_op, sampling.greedy_sample):
        ids = fn(logits)
        assert ids.device.type == "meta" and ids.shape == (5,) and ids.dtype == torch.int32
    for fn in (ops.top_k_op, sampling.top_k):
        vals, ids = fn(logits, 8)
        assert vals.device.type == "meta" and vals.shape == (5, 8)
        assert vals.dtype == torch.float32 and ids.dtype == torch.int32 and ids.shape == (5, 8)
    launches = (sampling.greedy_sample.launches, sampling.top_k.launches)
    ops.top_k_op(logits.float(), 2)
    ops.sample_op(logits.float())
    assert (sampling.greedy_sample.launches, sampling.top_k.launches) == launches
    with pytest.raises(ValueError):  # the argument checks still hold
        ops.top_k_op(logits, 0)


def test_sampling_wrappers_still_refuse_other_devices():
    """A tensor on a device that is neither CUDA, the CPU nor meta raises: a
    lazily-traced ``xla`` tensor stands in for one (a subclass whose device
    reads ``xla``)."""

    class OtherDevice(torch.Tensor):
        @property
        def device(self):
            return torch.device("xla")

    logits = torch.zeros((2, 16)).as_subclass(OtherDevice)
    assert logits.device.type == "xla"
    for call in (lambda: ops.sample_op(logits), lambda: sampling.greedy_sample(logits),
                 lambda: ops.top_k_op(logits, 2), lambda: sampling.top_k(logits, 2)):
        with pytest.raises(ValueError, match="runs on cuda, cpu or meta"):
            call()
