"""The port stands alone: it imports neither JAX nor the JAX package, and
serves on the CPU with both made unimportable, through the serving engine,
through ``python -m repro_torch.launch.serve`` in each of its modes (the
MoE and RWKV-6 families through both too; the encoder-decoder family through
the engine, each request over its own encoded window, and the driver refuses it as the
reference's does; the vision-language family through its prefixed forward and the engine;
the other dense configurations through the driver; the hybrid jamba through its forward, the
engine and the driver, and kimi-k2 through the driver), and through the closed-loop bridge into the
port's copy of the cluster model (its report's energy and roofline views
import their modules lazily, so the run calls them); it trains through
``python -m repro_torch.launch.train``, with and without checkpoints, and
takes a ``remat="full"`` train step, with ``ml_dtypes`` made unimportable
too; it serves an int8 cache and runs a chunked ``forward``; and its copy of the compiler evaluates
and ``python -m repro_torch.obs.doctor`` diagnoses traced bridge runs with
the same three unimportable."""

from __future__ import annotations

import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_SERVE_WITHOUT_JAX = """
import dataclasses, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
from repro_torch.configs import get
from repro_torch.models.model import Model
from repro_torch.serving import Request, ServingEngine
cfg = dataclasses.replace(get("qwen2-0.5b").reduced(), remat="none")
model = Model(cfg, device="cpu")
engine = ServingEngine(model, model.init(0), max_slots=2, max_len=32)
for i, p in enumerate([[5, 9, 2], [7, 1], [3, 3, 3, 3]]):
    engine.submit(Request(uid=i, prompt=p, max_new_tokens=4))
done = engine.run_until_done()
assert sorted(len(r.generated) for r in done) == [4, 4, 4], done
import torch
q8 = Model(dataclasses.replace(cfg, cache_quant="int8", attn_chunk=4), device="cpu")
q8_params = q8.init(0)
engine = ServingEngine(q8, q8_params, max_slots=2, max_len=32)
for i, p in enumerate([[5, 9, 2], [7, 1]]):
    engine.submit(Request(uid=i, prompt=p, max_new_tokens=4))
q8_done = engine.run_until_done()
assert sorted(len(r.generated) for r in q8_done) == [4, 4], q8_done
assert engine.cache["k"].dtype == torch.int8 and "k_scale" in engine.cache
chunked, _ = q8.forward(q8_params, {"tokens": torch.ones((1, 12), dtype=torch.int64)})
print("int8 served", len(q8_done), "chunked forward", tuple(chunked.shape))
import runpy
for mode in ("sequential", "concurrent", "fused"):  # python -m repro_torch.launch.serve
    sys.argv = ["serve", "--device", "cpu", "--reduced", "--steps", "6", "--mode", mode]
    runpy.run_module("repro_torch.launch.serve", run_name="__main__", alter_sys=True)
moe = Model(dataclasses.replace(get("phi3.5-moe-42b-a6.6b").reduced(), remat="none"),
            device="cpu")
engine = ServingEngine(moe, moe.init(0), max_slots=2, max_len=32)
for i, p in enumerate([[5, 9, 2], [7, 1], [4]]):
    engine.submit(Request(uid=i, prompt=p, max_new_tokens=3))
moe_done = engine.run_until_done()
assert sorted(len(r.generated) for r in moe_done) == [3, 3, 3], moe_done
sys.argv = ["serve", "--device", "cpu", "--reduced", "--arch", "phi3.5-moe-42b-a6.6b",
            "--steps", "6", "--fuse", "2", "--mode", "fused"]
runpy.run_module("repro_torch.launch.serve", run_name="__main__", alter_sys=True)
rwkv = Model(dataclasses.replace(get("rwkv6-7b").reduced(), remat="none"), device="cpu")
engine = ServingEngine(rwkv, rwkv.init(0), max_slots=2, max_len=32, prefill_chunk=2)
for i, p in enumerate([[5, 9, 2], [7, 1], [4]]):
    engine.submit(Request(uid=i, prompt=p, max_new_tokens=3))
rwkv_done = engine.run_until_done()
assert sorted(len(r.generated) for r in rwkv_done) == [3, 3, 3], rwkv_done
sys.argv = ["serve", "--device", "cpu", "--reduced", "--arch", "rwkv6-7b",
            "--steps", "6", "--fuse", "2", "--cache-len", "4", "--mode", "fused"]
runpy.run_module("repro_torch.launch.serve", run_name="__main__", alter_sys=True)
whisper = Model(dataclasses.replace(get("whisper-medium").reduced(), remat="none"),
                device="cpu")
wparams = whisper.init(0)
engine = ServingEngine(whisper, wparams, max_slots=2, max_len=32, prefill_chunk=2)
import torch
frames = torch.randn((3, whisper.cfg.encoder_seq_len, whisper.cfg.d_model),
                     generator=torch.Generator().manual_seed(0))
xk, xv = whisper.cross_kv(wparams, whisper.encode(wparams, frames))
for i, p in enumerate([[5, 9, 2], [7, 1], [4]]):
    engine.submit(Request(uid=i, prompt=p, max_new_tokens=3, cross_kv=(xk[:, i], xv[:, i])))
whisper_done = engine.run_until_done()
assert sorted(len(r.generated) for r in whisper_done) == [3, 3, 3], whisper_done
sys.argv = ["serve", "--device", "cpu", "--reduced", "--arch", "whisper-medium"]
try:
    runpy.run_module("repro_torch.launch.serve", run_name="__main__", alter_sys=True)
except SystemExit as e:
    print("refused:", e)
vlm = Model(dataclasses.replace(get("phi-3-vision-4.2b").reduced(), remat="none"), device="cpu")
vparams = vlm.init(0)
logits, _ = vlm.forward(vparams, {"tokens": torch.tensor([[5, 9, 2]]),
                                  "frontend_embeds": torch.randn((1, 8, vlm.cfg.d_model))})
assert logits.shape == (1, 3, vlm.cfg.vocab_size), logits.shape
engine = ServingEngine(vlm, vparams, max_slots=2, max_len=32, prefill_chunk=2)
for i, p in enumerate([[5, 9, 2], [7, 1], [4]]):
    engine.submit(Request(uid=i, prompt=p, max_new_tokens=3))
vlm_done = engine.run_until_done()
assert sorted(len(r.generated) for r in vlm_done) == [3, 3, 3], vlm_done
for arch in ("phi4-mini-3.8b", "minitron-4b", "qwen2.5-32b", "paper-lm-100m",
             "jamba-1.5-large-398b", "kimi-k2-1t-a32b"):
    sys.argv = ["serve", "--device", "cpu", "--reduced", "--arch", arch, "--steps", "6",
                "--fuse", "2", "--cache-len", "8", "--mode", "fused"]
    runpy.run_module("repro_torch.launch.serve", run_name="__main__", alter_sys=True)
jamba = Model(dataclasses.replace(get("jamba-1.5-large-398b").reduced(), remat="none"),
              device="cpu")
jparams = jamba.init(0)
logits, aux = jamba.forward(jparams, {"tokens": torch.tensor([[5, 9, 2]])})
assert logits.shape == (1, 3, jamba.cfg.vocab_size) and float(aux) > 0, (logits.shape, aux)
engine = ServingEngine(jamba, jparams, max_slots=2, max_len=32, prefill_chunk=2)
for i, p in enumerate([[5, 9, 2], [7, 1], [4]]):
    engine.submit(Request(uid=i, prompt=p, max_new_tokens=3))
jamba_done = engine.run_until_done()
assert sorted(len(r.generated) for r in jamba_done) == [3, 3, 3], jamba_done
from repro_torch.bridge import ClosedLoopDriver, TenantEngine
from repro_torch.cluster import Cluster
tenants = []
for i in range(2):
    e = ServingEngine(model, model.init(0), max_slots=4, max_len=32, prefill_chunk=2)
    for uid, p in enumerate([[3 + i, 5, 2], [7, 1 + i]]):
        e.submit(Request(uid=uid, prompt=p, max_new_tokens=3))
    tenants.append(TenantEngine(f"t{i}", e, accel="opengemm"))
rep = ClosedLoopDriver(tenants, Cluster.uniform(2, {"opengemm": 1}, policy="affinity",
                                                sticky=True, link="noc")).run()
assert rep.tokens == 12 and rep.tokens_per_kcycle > 0, rep.tokens
assert all(p["matched"] for p in rep.config_parity().values()), rep.config_parity()
assert rep.energy_report().check().total_energy > 0
assert [pt.name for pt in rep.serving_roofline()] == ["serve[t0]", "serve[t1]"]
assert len(rep.serving_energy_roofline()) == 2
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("served", len(done), "bridged", rep.tokens)
"""


def test_port_serves_with_jax_and_repro_unimportable():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _SERVE_WITHOUT_JAX], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 3 bridged 12" in out.stdout
    for mode, steps in (("sequential", 5), ("concurrent", 5), ("fused", 0)):
        assert f"[serve] arch=qwen2-0.5b mode={mode} batch=4 steps={steps}: " in out.stdout
    assert "[serve] arch=phi3.5-moe-42b-a6.6b mode=fused batch=4 steps=4: " in out.stdout
    assert "[serve] arch=rwkv6-7b mode=fused batch=4 steps=4: " in out.stdout
    for arch in ("phi4-mini-3.8b", "minitron-4b", "qwen2.5-32b", "paper-lm-100m",
                 "jamba-1.5-large-398b", "kimi-k2-1t-a32b"):
        assert f"[serve] arch={arch} mode=fused batch=4 steps=4: " in out.stdout
    assert "refused: serve driver targets decoder-only archs" in out.stdout
    assert "int8 served 2 chunked forward (1, 12, 256)" in out.stdout


_CALIBRATE_WITHOUT_JAX = """
import json, sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
from repro_torch.engine import calibrate, load_fits
out = sys.argv[1]
calibrate.main(["--device", "cpu", "--smoke", "--repeats", "1", "--out", out])
assert len(load_fits(out)) == 3
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("calibrated", json.load(open(out))["backend"])
"""


def test_port_calibrates_on_the_cpu_with_jax_and_repro_unimportable(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _CALIBRATE_WITHOUT_JAX, str(tmp_path / "f.json")],
                         env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "calibrated cpu" in out.stdout


_TRAIN_WITHOUT_JAX = """
import runpy, sys
for name in ("jax", "jaxlib", "repro", "ml_dtypes"):
    sys.modules[name] = None
ckpt = sys.argv[1]
for extra in ([], ["--ckpt-dir", ckpt, "--ckpt-every", "4"]):
    sys.argv = ["train", "--device", "cpu", "--reduced", "--steps", "10", *extra]
    runpy.run_module("repro_torch.launch.train", run_name="__main__", alter_sys=True)
from repro_torch.checkpoint import CheckpointStore
assert CheckpointStore(ckpt).steps() == [4, 8, 10], CheckpointStore(ckpt).steps()
import dataclasses, torch
from repro_torch.configs import get
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch.steps import build_train_step
from repro_torch.models.model import Model
from repro_torch.optim import AdamW
model = Model(dataclasses.replace(get("paper-lm-100m").reduced(), remat="full"), device="cpu")
params = model.init(0)
batch = {k: torch.from_numpy(v)
         for k, v in SyntheticLMDataset(model.cfg.vocab_size, 16, 2).batch(0).items()}
_, _, metrics = build_train_step(model, AdamW())(params, AdamW().init(params), batch)
assert torch.isfinite(metrics["loss"]), metrics
print("remat full step")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("trained")
"""


def test_port_trains_on_the_cpu_with_jax_repro_and_ml_dtypes_unimportable(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _TRAIN_WITHOUT_JAX, str(tmp_path / "ckpt")],
                         env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("[train] arch=paper-lm-100m params=0.1M batch=8 seq=256") == 2
    assert "[train] straggler events: " in out.stdout and "restarts: 0" in out.stdout
    assert "trained" in out.stdout and "remat full step" in out.stdout


_DOCTOR_WITHOUT_JAX = """
import json, runpy, sys
for name in ("jax", "jaxlib", "repro", "ml_dtypes"):
    sys.modules[name] = None
out = sys.argv[1]
import repro_torch.cluster.powercap, repro_torch.core.passes, repro_torch.fabric.migrate
import repro_torch.obs.doctor
from repro_torch.core import accelerators, evaluate_levels, matmul_driver, speedup
r = evaluate_levels(lambda: matmul_driver.opengemm_tiled_matmul(64),
                    {"opengemm": accelerators.opengemm_like()})
assert speedup(r, "both") > 1.5, speedup(r, "both")
import dataclasses
from repro_torch.bridge import ClosedLoopDriver, TenantEngine
from repro_torch.cluster import Cluster, Host
from repro_torch.configs import get
from repro_torch.fabric import ContextStore, capture_contexts
from repro_torch.models.model import Model
from repro_torch.obs import Tracer, attribute, write_trace
from repro_torch.sched import LaunchRequest
from repro_torch.serving import Request, ServingEngine
model = Model(dataclasses.replace(get("qwen2-0.5b").reduced(), remat="none"), device="cpu")
params = model.init(0)
paths = []
for overlap in ("serialized", "overlapped"):
    tenants = []
    for i in range(2):
        e = ServingEngine(model, params, max_slots=4, max_len=32, prefill_chunk=2)
        e.submit(Request(uid=0, prompt=[3 + i, 5, 2], max_new_tokens=3))
        tenants.append(TenantEngine(f"t{i}", e, accel="opengemm"))
    tracer = Tracer()
    rep = ClosedLoopDriver(tenants, Cluster.uniform(2, {"opengemm": 1}, policy="affinity",
                                                    sticky=True, link="noc", overlap=overlap,
                                                    tracer=tracer)).run()
    paths.append(f"{out}/{overlap}.json")
    write_trace(tracer, paths[-1], attribution=attribute(rep).check(), metrics=rep.metrics)
host = Host.from_registry("h0", {"gemmini": 1}, link="noc")
host.dispatch(LaunchRequest("t0", (8, 16, 16), {"A": 1, "B": 2}, accel="gemmini"))
ContextStore(f"{out}/ctx").save(1, capture_contexts(host))
assert list(ContextStore(f"{out}/ctx").restore()) == ["t0"]
sys.argv = ["doctor", paths[0], "--against", paths[1], "--json", f"{out}/doctor.json"]
try:
    runpy.run_module("repro_torch.obs.doctor", run_name="__main__", alter_sys=True)
except SystemExit as e:
    assert e.code == 0, e.code
payload = json.load(open(f"{out}/doctor.json"))
spans = [json.load(open(path))["attribution"]["makespan"] for path in paths]
assert payload["diff"]["makespan"]["delta"] == spans[0] - spans[1], payload["diff"]["makespan"]
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro", "ml_dtypes")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("diagnosed", payload["diagnosis"]["regime"]["label"])
"""


def test_the_compiler_and_the_doctor_run_with_jax_repro_and_ml_dtypes_unimportable(tmp_path):
    """The port's compiler evaluates, a traced closed-loop bridge run exports
    two traces, ``fabric.ContextStore`` persists through the port's store,
    and ``python -m repro_torch.obs.doctor`` diagnoses and diffs the traces,
    all with JAX, the JAX package and ``ml_dtypes`` unimportable."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _DOCTOR_WITHOUT_JAX, str(tmp_path)],
                         env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "config-wall doctor" in out.stdout and "trace diff" in out.stdout
    assert "diagnosed " in out.stdout


def test_no_source_imports_jax_or_repro():
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro|ml_dtypes)\b", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py",
                                                                     ROOT / "parity_sweep.py"]
    assert {"bridge/report.py", "bridge/descriptors.py", "cluster/router.py", "power/meter.py",
            "core/interp.py", "optim/adamw.py", "data/pipeline.py", "checkpoint/store.py",
            "runtime/supervisor.py", "launch/steps.py", "launch/train.py", "tree.py",
            "obs/doctor.py", "core/passes/overlap.py", "fabric/migrate.py",
            "cluster/powercap.py", "engine/autotune.py", "configs/jamba_1_5_large_398b.py",
            "configs/kimi_k2_1t_a32b.py"} <= {
        f.relative_to(ROOT / "src" / "repro_torch").as_posix() for f in files[:-2]}
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in banned.finditer(f.read_text())]
    assert not offenders, offenders
