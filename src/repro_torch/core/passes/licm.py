"""Loop-invariant setup-field hoisting (§5.4.1).

The port's own copy of ``repro/core/passes/licm.py``: the code is the
reference's, unchanged.

Follows MLIR's LICM with the paper's additional constraint: a parameter may
only be hoisted if it stays constant throughout the *whole* loop body — i.e.
the loop contains exactly one setup for that accelerator, and the field's
operand is defined outside the loop. Hoisted fields are moved into a new
setup right in front of the loop (Figure 9, middle), chained into the loop's
threaded state.
"""

from __future__ import annotations

from .. import ir
from ..ir import Module, Op


def hoist_invariant_setup_fields(module: Module) -> int:
    hoisted = 0
    for loop in [op for op in module.walk() if op.name == "scf.for"]:
        hoisted += _hoist_from_loop(loop)
    return hoisted


def _hoist_from_loop(loop: Op) -> int:
    body = loop.regions[0].block
    parent = loop.parent
    if parent is None:
        return 0

    # group top-level setups of the body by accelerator
    by_accel: dict[str, list[Op]] = {}
    for op in body.ops:
        if op.name == "accfg.setup":
            by_accel.setdefault(op.attrs["accel"], []).append(op)

    hoisted = 0
    for accel, setups in by_accel.items():
        if len(setups) != 1:
            continue  # two launches with different parameters: not hoistable (§5.4.1)
        setup_op = setups[0]
        in_state = ir.setup_in_state(setup_op)
        # state tracing must have threaded the state through the loop
        if in_state is None or not (in_state.is_block_arg and in_state.block is body):
            continue
        arg_idx = body.args.index(in_state) - 1  # 0 is the induction variable
        init = ir.for_iter_inits(loop)[arg_idx]

        invariant = {
            name: value
            for name, value in ir.setup_fields(setup_op).items()
            if not ir.defined_in(value, loop)
        }
        if not invariant:
            continue

        pre = ir.setup(accel, invariant, init)
        parent.insert_before(loop, pre)
        loop.operands[3 + arg_idx] = pre.result

        remaining = {
            k: v for k, v in ir.setup_fields(setup_op).items() if k not in invariant
        }
        setup_op.attrs["fields"] = list(remaining.keys())
        setup_op.operands = list(remaining.values()) + [in_state]
        hoisted += len(invariant)
    return hoisted
