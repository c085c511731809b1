"""State tracing (§5.3): connect ``accfg.setup`` ops through control flow.

The port's own copy of ``repro/core/passes/state_tracing.py``: the code is the
reference's, unchanged.

Introduces a live state variable per accelerator, memory-SSA style: chains
straight-line setups, threads states through ``scf.for`` iter_args and
``scf.if`` results, and makes pessimistic assumptions about opaque calls
(``#accfg.effects<all>``). After this pass, every setup that has a statically
known predecessor carries it as its ``in_state`` operand — the substrate both
deduplication and overlap build on.

Where no predecessor state exists (e.g. the first setup lives inside a loop),
an *empty* setup is materialized in front of the region, exactly as in the
paper's Figure 9 (``%state = accfg.setup to ()``): it writes nothing and
represents the unknown-but-live register file.
"""

from __future__ import annotations

from .. import ir
from ..ir import Block, Module, Op, Value

# live-map entry sentinel: the accelerator's registers were clobbered by an
# opaque operation and no SSA value represents them.
_CLOBBERED = None


def accels_in(op: Op) -> set[str]:
    return {
        inner.attrs["accel"]
        for inner in op.walk()
        if inner.name in ("accfg.setup", "accfg.launch")
    }


def has_clobber(op: Op) -> bool:
    return any(
        inner.name == "func.call" and inner.attrs.get("effects", "all") == "all"
        for inner in op.walk()
    )


def trace_states(module: Module) -> None:
    for fn in module.ops:
        if fn.name == "func.func":
            _trace_block(fn.regions[0].block, {})


def _empty_setup_before(block: Block, anchor: Op, accel: str) -> Value:
    empty = ir.setup(accel, {}, None)
    block.insert_before(anchor, empty)
    return empty.result


def _empty_setup_before_terminator(block: Block, accel: str) -> Value:
    term = block.ops[-1]
    empty = ir.setup(accel, {}, None)
    block.insert_before(term, empty)
    return empty.result


def _trace_block(block: Block, live: dict[str, Value | None]) -> dict[str, Value | None]:
    for op in list(block.ops):
        if op.name == "accfg.setup":
            accel = op.attrs["accel"]
            if ir.setup_in_state(op) is None and live.get(accel) is not None:
                ir.set_setup_in_state(op, live[accel])
            live[accel] = op.result
        elif op.name == "func.call" and op.attrs.get("effects", "all") == "all":
            live = {k: _CLOBBERED for k in live}
        elif op.name == "scf.for":
            live = _trace_for(block, op, live)
        elif op.name == "scf.if":
            live = _trace_if(op, live)
    return live


def _trace_for(block: Block, loop: Op, live: dict[str, Value | None]) -> dict[str, Value | None]:
    body = loop.regions[0].block
    touched = accels_in(loop)
    threaded: dict[str, tuple[Value, Value, int]] = {}  # accel -> (arg, result, yield idx)
    for accel in sorted(touched):
        init = live.get(accel)
        if init is None:
            init = _empty_setup_before(block, loop, accel)
        arg, result = ir.add_iter_arg(loop, init, init)  # yield placeholder: fixed below
        threaded[accel] = (arg, result, len(ir.for_yield(loop).operands) - 1)

    inner_live: dict[str, Value | None] = dict(live)
    for accel, (arg, _, _) in threaded.items():
        inner_live[accel] = arg
    out = _trace_block(body, inner_live)

    yld = ir.for_yield(loop)
    for accel, (arg, result, idx) in threaded.items():
        final = out.get(accel)
        if final is None:  # clobbered inside the body: yield a fresh unknown state
            final = _empty_setup_before_terminator(body, accel)
        yld.operands[idx] = final
        live[accel] = result

    if has_clobber(loop):  # loop body may clobber non-threaded accelerators too
        for accel in list(live):
            if accel not in threaded:
                live[accel] = _CLOBBERED
    return live


def _trace_if(op: Op, live: dict[str, Value | None]) -> dict[str, Value | None]:
    then_blk, else_blk = op.regions[0].block, op.regions[1].block
    then_live = _trace_block(then_blk, dict(live))
    else_live = _trace_block(else_blk, dict(live))

    for accel in sorted(set(then_live) | set(else_live) | accels_in(op)):
        tv = then_live.get(accel, live.get(accel))
        ev = else_live.get(accel, live.get(accel))
        if tv is ev:  # untouched on both paths (or clobbered on both)
            live[accel] = tv
            continue
        if tv is None:
            tv = _empty_setup_before_terminator(then_blk, accel)
        if ev is None:
            ev = _empty_setup_before_terminator(else_blk, accel)
        live[accel] = ir.add_if_result(op, tv, ev)
    return live
