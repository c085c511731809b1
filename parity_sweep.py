#!/usr/bin/env python3
"""How often the forward-vs-decode check of ``chip_smoke.py`` passes, over
seeded weight draws, on one NVIDIA GPU; and, with ``--mutate``, how often
it catches a decode made wrong on purpose.

    python3 parity_sweep.py [--seeds 22] [--families hybrid ...] [--per-layer] [--mutate]

For each seed it draws each family's configuration on the card, as
``chip_smoke.py`` does at seed 0: phi3.5-moe-42b-a6.6b (``moe``, 16 of its
32 layers), rwkv6-7b (``ssm``, whole), jamba-1.5-large-398b (``hybrid``,
one group of 4 layers) and kimi-k2-1t-a32b (``kimi-k2``, 1 of 61 layers),
every width as published. It runs ``chip_smoke._decode_parity`` on each and
prints ``pass`` or the first line of the failure, then the pass counts.
``--per-layer`` draws each stacked matrix a layer at a time, one
``torch.randn`` a layer (other numbers from the same seed than
``layers._dense_init``'s stacked stream). ``--mutate`` runs the check under
each fault the family's decode has a place for (``chip_smoke.faults_of``:
a KV cache read one row late, a recurrent state never written), in every
decode step and in the B-row steps alone (``rows``: the padded decode right,
so the B-row rules must catch it), and counts the seeds it catches, which
must be all of them. For the hybrid it also sums up, by layer kind
(attention, Mamba+MoE, Mamba+MLP), the same distance ratio for the
residual stream after each layer (``_decode_parity``'s ``by_kind``): which
kind spreads the logits' ratio. ``--families`` runs those alone. Exits
non-zero without a CUDA device, and when the check fails a correct model
or passes a wrong one on any seed.
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

FAMILIES = {"moe": ("phi3.5-moe-42b-a6.6b", {"n_layers": chip_smoke.MOE_LAYERS}),
            "ssm": (chip_smoke.SSM_ARCH, {}),
            **{tag.strip("[]"): (arch, cut) for arch, tag, cut, _ in chip_smoke.CUTS}}


def _per_layer(gen, shape, scale_axis=0, stack=0):
    """A stack drawn one ``torch.randn`` a layer."""
    if not stack:
        x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
        return x.mul_(1.0 / math.sqrt(shape[scale_axis])).to(torch.bfloat16)
    return torch.stack([_per_layer(gen, shape, scale_axis) for _ in range(stack)])


def _outcome(model, params, family: str, fault: str | None,
             most_rows: int | None) -> tuple[str, dict]:
    """``pass`` and the check's numbers, or ``FAIL`` and the first line of
    the failure; and the numbers (none on a failure)."""
    try:
        with contextlib.redirect_stdout(io.StringIO()), chip_smoke.fault(fault, most_rows):
            stats = chip_smoke._decode_parity(model, params, f"[{family}]")
    except (AssertionError, SystemExit) as e:
        return "FAIL " + (str(e).strip().splitlines() or [""])[0][:160], {}
    return f"pass {stats}", stats


def _by_kind(ratios: list[tuple[float, dict]]) -> str:
    """Each layer kind's ratios over the seeds (smallest, largest, and the
    largest of the seed with the largest logits' ratio) beside the logits'."""
    worst = max(ratios, key=lambda r: r[0])
    kinds = {kind for _, by in ratios for kind in by}
    parts = [f"logits {min(r for r, _ in ratios):.4f}-{worst[0]:.4f}"]
    for kind in sorted(kinds):
        got = [x for _, by in ratios for x in by.get(kind, [])]
        parts.append(f"{kind} {min(got):.4f}-{max(got):.4f} (at the worst logits' seed "
                     f"{max(worst[1].get(kind, [0.0])):.4f})")
    return "; ".join(parts)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", type=int, default=22)
    p.add_argument("--families", nargs="+", choices=list(FAMILIES), default=list(FAMILIES))
    p.add_argument("--per-layer", action="store_true")
    p.add_argument("--mutate", action="store_true")
    args = p.parse_args(argv)
    _, smi = chip_smoke.phase_device()
    torch.backends.cuda.matmul.allow_tf32 = False  # the f32 forward of _decode_parity
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.phase_build()

    from repro_torch.configs import get
    from repro_torch.models import layers as L
    from repro_torch.models.model import Model

    if args.per_layer:
        L._dense_init = _per_layer
    counts, wrong, ratios = {}, 0, {}
    for family in args.families:
        arch, cut = FAMILIES[family]
        cfg = dataclasses.replace(get(arch), **cut)
        faults = ([(f, rows) for f in chip_smoke.faults_of(cfg)
                   for rows in (None, chip_smoke.PARITY_ROWS)] if args.mutate else [(None, None)])
        for seed in range(args.seeds):
            model = Model(cfg, device="cuda")
            params = model.init(seed)
            for fault, most_rows in faults:
                outcome, stats = _outcome(model, params, family, fault, most_rows)
                if "by_kind" in stats:
                    ratios.setdefault(family, []).append((stats["ratio"], stats["by_kind"]))
                key = family if fault is None else f"{family} {fault}"
                if most_rows:
                    key += " rows"
                caught = outcome.startswith("FAIL") == (fault is not None)
                counts[key] = counts.get(key, 0) + caught
                wrong += not caught
                print(f"[sweep] {key} seed {seed}: {outcome}", flush=True)
            del model, params
            gc.collect()
            torch.cuda.empty_cache()
    draw = "one torch.randn a layer" if args.per_layer else "layers._dense_init"
    what = "faults caught" if args.mutate else "passed"
    print(f"[sweep] draws by {draw}: {what} of {args.seeds} seeds: {counts} ({smi})")
    for family, got in ratios.items():
        print(f"[sweep] {family} distance ratio to the f32 forward over {len(got)} seeds, by "
              f"layer kind (F32_RATIO {chip_smoke.F32_RATIO}): {_by_kind(got)}")
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
