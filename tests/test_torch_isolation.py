"""The port stands alone: it imports neither JAX nor the JAX package, and
serves on the CPU with both made unimportable."""

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
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro")
                and sys.modules[m] is not None)
assert not loaded, loaded
print("served", len(done))
"""


def test_port_serves_with_jax_and_repro_unimportable():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    out = subprocess.run([sys.executable, "-c", _SERVE_WITHOUT_JAX], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "served 3" in out.stdout


def test_no_source_imports_jax_or_repro():
    banned = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)\b", re.M)
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    offenders = [f"{f.relative_to(ROOT)}: {m.group(0).strip()}"
                 for f in files for m in banned.finditer(f.read_text())]
    assert not offenders, offenders
