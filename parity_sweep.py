#!/usr/bin/env python3
"""How often the weight-dependent parity checks of ``chip_smoke.py`` pass,
over seeded weight draws, on one NVIDIA GPU.

    python3 parity_sweep.py [--seeds 22] [--per-layer]

For each seed it draws phi3.5-moe-42b-a6.6b (16 of its 32 layers, at
drop-free capacity) and rwkv6-7b whole on the card, as ``chip_smoke.py``'s
``[moe]`` and ``[ssm]`` phases do at seed 0, runs their forward-vs-decode
checks (``_moe_parity``, ``_ssm_parity``) on them and prints ``pass`` or
the first line of the failure, then the pass counts. ``--per-layer`` draws
each stacked matrix a layer at a time, one ``torch.randn`` a layer (other
numbers from the same seed than ``layers._dense_init``'s stacked stream).
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import io
import math
import sys

import torch

import chip_smoke


def _per_layer(gen, shape, scale_axis=0, stack=0):
    """A stack drawn one ``torch.randn`` a layer."""
    if not stack:
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
        return x.mul_(1.0 / math.sqrt(shape[scale_axis])).to(torch.bfloat16)
    return torch.stack([_per_layer(gen, shape, scale_axis) for _ in range(stack)])


def _outcome(check, model, params) -> str:
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            check(model, params)
    except (AssertionError, SystemExit) as e:
        return "FAIL " + (str(e).strip().splitlines() or [""])[0][:120]
    return "pass"


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=22)
    p.add_argument("--per-layer", action="store_true")
    args = p.parse_args(argv)
    _, smi = chip_smoke.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 forward of _ssm_parity
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.phase_build()

    from repro_torch.configs import get
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model

    if args.per_layer:
        L._dense_init = _per_layer
    moe = dataclasses.replace(get(chip_smoke.MOE_ARCH), n_layers=chip_smoke.MOE_LAYERS)
    moe = dataclasses.replace(moe, capacity_factor=float(moe.n_experts))
    passed = {}
    for family, cfg, check in (("moe", moe, chip_smoke._moe_parity),
                               ("ssm", get(chip_smoke.SSM_ARCH), chip_smoke._ssm_parity)):
        for seed in range(args.seeds):
            model = Model(cfg, device="cuda")
            params = model.init(seed)
            outcome = _outcome(check, model, params)
            passed[family] = passed.get(family, 0) + (outcome == "pass")
            print(f"[sweep] {family} seed {seed}: {outcome}", flush=True)
            del model, params
            gc.collect()
            torch.cuda.empty_cache()
    draw = "one torch.randn a layer" if args.per_layer else "layers._dense_init"
    print(f"[sweep] draws by {draw}: passed of {args.seeds} seeds: {passed} ({smi})")


if __name__ == "__main__":
    sys.exit(main())
