"""The port's copy of the paper's compiler against the JAX package's.

The accfg IR built by either package's ``Builder`` and ``matmul_driver``
goes through each pass of the §5.2 pipeline, lowering, the per-level
evaluation and the ASCII timelines of both packages, compared as plain
data or text: the IR after every pass (SSA names read in order of first
appearance, since the name counter is per process), the lowered program of
``tests/test_lowering.py``'s cases, every level's cycles and invocation log
over ``tests/test_paper_claims.py``'s OpenGeMM and Gemmini sweeps, and the
rendered timelines. The port's geomeans lie in the paper's bands.
"""

from __future__ import annotations

import re
from functools import lru_cache

import pytest

import repro.core as jcore
import repro.core.lowering as jlowering
import repro.core.passes as jpasses
import repro.core.timeline as jtimeline
import repro_torch.core as tcore
import repro_torch.core.lowering as tlowering
import repro_torch.core.passes as tpasses
import repro_torch.core.timeline as ttimeline
from test_torch_cycle_model import plain

SIDES = {"jax": (jcore, jpasses, jlowering, jtimeline),
         "port": (tcore, tpasses, tlowering, ttimeline)}
SIZES = {"opengemm": [16, 32, 64, 128, 256], "gemmini": [16, 32, 64, 128, 256, 512]}
LEVELS = {"opengemm": ("baseline", "dedup", "overlap", "both"), "gemmini": ("baseline", "dedup")}


def _models(core, kind: str) -> dict:
    return {kind: getattr(core.accelerators, f"{kind}_like")()}


def _acc(core) -> dict:
    """``tests/test_accfg_passes.py``'s one-field-a-write concurrent model."""
    return {"acc": core.AcceleratorModel(
        name="acc", p_peak=64.0, concurrent=True, host_cpi=1.0, bytes_per_field=4,
        fields_per_write=1, instrs_per_write=2, dim_fields=("M", "K", "N"))}


# ---------------------------------------------------------------- programs


def _straightline(core):
    b = core.Builder()
    with b.function("main"):
        c1, c2 = b.const(8), b.const(16)
        s1 = b.setup("acc", {"M": c1, "K": c1, "N": c1})
        b.await_(b.launch(s1, "acc"))
        s2 = b.setup("acc", {"M": c1, "K": c1, "N": c2})
        b.await_(b.launch(s2, "acc"))
    return b.module


def _call(effects: str):
    def build(core):
        b = core.Builder()
        with b.function("main"):
            c1 = b.const(8)
            s1 = b.setup("acc", {"M": c1, "K": c1, "N": c1})
            b.await_(b.launch(s1, "acc"))
            b.call("printf", effects=effects)
            s2 = b.setup("acc", {"M": c1, "K": c1, "N": c1})
            b.await_(b.launch(s2, "acc"))
        return b.module
    return build


def _loop(core, n: int = 4):
    b = core.Builder()
    with b.function("main"):
        c8, base = b.const(8), b.const(4096)
        lb, ub, one = b.index(0), b.index(n), b.index(1)
        with b.for_(lb, ub, one) as (_loop_op, iv, _):
            ptr = b.add(base, b.mul(iv, c8))
            packed = b.pack((c8, 0), (b.const(3), 16))
            s = b.setup("acc", {"A": ptr, "M": c8, "K": c8, "N": c8, "P": packed})
            b.await_(b.launch(s, "acc"))
    return b.module


def _branch(cond_val: int):
    def build(core):
        b = core.Builder()
        with b.function("main"):
            c8, c16 = b.const(8), b.const(16)
            cond = b.cmp("slt", b.const(cond_val), b.const(10))
            s0 = b.setup("acc", {"M": c8, "K": c8, "N": c8})
            b.await_(b.launch(s0, "acc"))
            with b.if_(cond) as if_op:
                with b.then(if_op):
                    s1 = b.setup("acc", {"M": c16}, in_state=s0)
                    b.await_(b.launch(s1, "acc"))
                with b.else_(if_op):
                    pass
            s2 = b.setup("acc", {"K": c8, "N": c8})
            b.await_(b.launch(s2, "acc"))
        return b.module
    return build


def _matmul(kind: str, k: int):
    def build(core):
        return getattr(core.matmul_driver, f"{kind}_tiled_matmul")(k)
    return build


PROGRAMS = {
    "straightline": (_straightline, "acc"),
    "call-all": (_call("all"), "acc"),
    "call-none": (_call("none"), "acc"),
    "loop": (_loop, "acc"),
    "branch-taken": (_branch(5), "acc"),
    "branch-not-taken": (_branch(15), "acc"),
    "opengemm-16": (_matmul("opengemm", 16), "opengemm"),
    "opengemm-64": (_matmul("opengemm", 64), "opengemm"),
    "gemmini-64": (_matmul("gemmini", 64), "gemmini"),
    "gemmini-256": (_matmul("gemmini", 256), "gemmini"),
}


def _text(core, module) -> str:
    """The module's printed IR with SSA names numbered by first appearance."""
    names: dict[str, str] = {}

    def rename(m: re.Match) -> str:
        return names.setdefault(m.group(0), f"%{m.group(1)}{len(names)}")

    return re.sub(r"%([a-z_]+)(\d+)", rename, core.ir.print_module(module))


def _pass_steps(passes, accel: str) -> list:
    """The ``optimize`` pipeline's passes in its order, one step each, so a
    difference names the pass that made it."""
    concurrent = {accel} if accel in ("acc", "opengemm") else set()
    return [
        ("trace_states", passes.trace_states),
        ("canonicalize", passes.canonicalize),
        ("hoist_setups_into_branches", passes.hoist_setups_into_branches),
        ("hoist_invariant_setup_fields", passes.hoist_invariant_setup_fields),
        ("dedup", passes.dedup),
        ("canonicalize", passes.canonicalize),
        ("overlap", lambda m: passes.overlap(m, concurrent)),
        ("canonicalize", passes.canonicalize),
    ]


def _through_passes(side: str, program: str) -> list:
    core, passes, *_ = SIDES[side]
    build, accel = PROGRAMS[program]
    models = _acc(core) if accel == "acc" else _models(core, accel)
    out = []
    base = build(core)
    passes.baseline(base)
    out.append(("baseline", None, _text(core, base), core.run(base, models).log_signature()))
    module = build(core)
    for name, fn in _pass_steps(passes, accel):
        returned = fn(module)
        trace = core.run(module, models)
        out.append((name, returned, _text(core, module), trace.log_signature(),
                    trace.total_cycles, trace.config_bytes))
    return out


@pytest.mark.parametrize("program", sorted(PROGRAMS))
def test_each_pass_gives_the_references_ir(program):
    want, got = _through_passes("jax", program), _through_passes("port", program)
    assert [w[0] for w in want] == [g[0] for g in got]
    for w, g in zip(want, got):
        assert g == w, f"{program}: {w[0]} differs"
    # the pipeline changes the IR (except across a clobbering call, where
    # nothing is provable) and leaves what the accelerator sees unchanged
    assert (len({step[2] for step in want[1:]}) > 1) == (program != "call-all")
    assert all(step[3] == want[0][3] for step in want)


def test_the_ir_text_compares_up_to_ssa_numbering():
    """Two builds of one program in one package print different SSA numbers
    and equal normalised text; a changed constant still shows."""
    a, b = _straightline(tcore), _straightline(tcore)
    assert tcore.ir.print_module(a) != tcore.ir.print_module(b)
    assert _text(tcore, a) == _text(tcore, b)
    assert _text(tcore, a) != _text(tcore, _call("all")(tcore))


# ---------------------------------------------------------------- lowering


def _lowered(side: str, kind: str, k: int, level: str) -> dict:
    core, passes, lowering, _ = SIDES[side]
    models = _models(core, kind)
    module = getattr(core.matmul_driver, f"{kind}_tiled_matmul")(k)
    if level == "baseline":
        passes.baseline(module)
    else:
        passes.optimize(module, concurrent_accels={kind} if kind == "opengemm" else set())
    prog = lowering.lower(module, models)
    return {"text": prog.text(), "program": plain(prog), "total": prog.total_instrs}


LOWERED = [("opengemm", 16, "baseline"), ("gemmini", 64, "baseline"),
           ("opengemm", 64, "baseline"), ("opengemm", 64, "optimized"),
           ("gemmini", 32, "baseline"), ("gemmini", 256, "optimized")]


@pytest.mark.parametrize("kind,k,level", LOWERED)
def test_the_lowered_program_is_the_references(kind, k, level):
    want, got = _lowered("jax", kind, k, level), _lowered("port", kind, k, level)
    assert want["program"]["config_instrs"] > 0
    assert ("csrw  ptr_a" in want["text"]) == (kind == "opengemm")
    assert got == want


# -------------------------------------------------------------- evaluation


@lru_cache(maxsize=None)
def _evaluated(side: str, kind: str, k: int) -> dict:
    core = SIDES[side][0]
    return core.evaluate_levels(lambda: getattr(core.matmul_driver, f"{kind}_tiled_matmul")(k),
                                _models(core, kind), levels=LEVELS[kind])


CASES = [(kind, k) for kind, sizes in SIZES.items() for k in sizes]


@pytest.mark.parametrize("kind,k", CASES)
def test_every_levels_cycles_and_log_are_the_references(kind, k):
    want, got = _evaluated("jax", kind, k), _evaluated("port", kind, k)
    assert list(got) == list(want) == list(LEVELS[kind])
    for level in LEVELS[kind]:
        w, g = want[level], got[level]
        assert g.trace.total_cycles == w.trace.total_cycles, level
        assert g.trace.log_signature() == w.trace.log_signature(), level
        assert plain(g) == plain(w), level
    assert len(want["baseline"].trace.invocations) > 0


def _speedups(side: str, kind: str) -> list[float]:
    core = SIDES[side][0]
    level = "both" if kind == "opengemm" else "dedup"
    return [core.speedup(_evaluated(side, kind, k), level) for k in SIZES[kind]]


def test_the_ports_geomeans_lie_in_the_papers_bands():
    """``tests/test_paper_claims.py``'s bands, through the port's copies:
    OpenGeMM about 2x (1.7-2.6, up to at least 2.2), Gemmini about 10.5 %
    (1.04-1.20); each the reference's number exactly."""
    og, gem = _speedups("port", "opengemm"), _speedups("port", "gemmini")
    assert og == _speedups("jax", "opengemm") and gem == _speedups("jax", "gemmini")
    assert 1.7 <= tcore.geomean(og) <= 2.6 and max(og) >= 2.2
    assert 1.04 <= tcore.geomean(gem) <= 1.20
    assert tcore.geomean(og) == jcore.geomean(og)


# --------------------------------------------------------------- timelines


@pytest.mark.parametrize("kind,k", [("opengemm", 16), ("opengemm", 64), ("gemmini", 128)])
def test_timeline_strings_are_the_references(kind, k):
    out = {}
    for side in ("jax", "port"):
        timeline = SIDES[side][3]
        traces = {lvl: r.trace for lvl, r in _evaluated(side, kind, k).items()}
        out[side] = {
            "compare": timeline.compare(traces),
            "narrow": timeline.compare(traces, width=20),
            "render": [timeline.render(t, 48, label=lvl) for lvl, t in traces.items()],
            "gaps": [timeline.idle_gaps(t) for t in traces.values()],
            "utilization": [timeline.accel_utilization(t) for t in traces.values()],
        }
    assert out["port"] == out["jax"]
    assert "accel busy" in out["port"]["compare"]
