"""Canonicalization: constant folding, CSE, arith LICM, DCE, setup cleanups.

The port's own copy of ``repro/core/passes/canonicalize.py``: the code is the
reference's, unchanged.

These mirror "MLIR's already implemented optimizations ... more aggressive
constant folding, common-subexpression-elimination and loop-invariant code
motion" which the accfg dialect unlocks by declaring effects instead of hiding
behind volatile asm (§5.2), plus the two clean-up rewrites from §5.4.1:
removing empty setups and merging launch-free consecutive setups.
"""

from __future__ import annotations

from typing import Any

from .. import ir
from ..ir import Block, Module, Op, Value


# --------------------------------------------------------------------------
# Constant folding + CSE (scoped by dominance: nested blocks see outer defs)
# --------------------------------------------------------------------------


def constant_fold_and_cse(module: Module, cross_iteration: bool = False) -> None:
    """Fold arith on constants and deduplicate pure ops.

    ``cross_iteration=False`` models the baseline compiler: values are only
    reused within one straight-line stretch (loop bodies keep their own
    copies, as re-materialized around volatile asm). ``True`` is the accfg
    pipeline: full scoped CSE + LICM below.
    """
    for fn in module.ops:
        if fn.name == "func.func":
            _fold_cse_block(fn.regions[0].block, [{}], module, cross_iteration)


def _const_of(v: Value) -> int | None:
    if v.owner is not None and v.owner.name == "arith.constant":
        return v.owner.attrs["value"]
    return None


def _cse_key(op: Op) -> tuple[Any, ...]:
    return (op.name, tuple(id(o) for o in op.operands), tuple(sorted(op.attrs.items())))


def _fold_cse_block(
    block: Block, scopes: list[dict[tuple, Value]], module: Module, cross: bool
) -> None:
    seen = scopes[-1]
    for op in list(block.ops):
        for region in op.regions:
            _fold_cse_block(region.block, scopes + [{}], module, cross)
        if not ir.is_pure(op):
            continue
        # constant folding
        if op.name in ir._BINARY_FNS:
            a, b = (_const_of(o) for o in op.operands)
            if a is not None and b is not None:
                folded = ir.constant(ir._BINARY_FNS[op.name](a, b), op.result.type)
                block.insert_before(op, folded)
                _replace_uses_everywhere(module, op.result, folded.result)
                block.remove(op)
                op = folded
        elif op.name == "arith.cmpi":
            a, b = (_const_of(o) for o in op.operands)
            if a is not None and b is not None:
                folded = ir.constant(int(ir._CMP_FNS[op.attrs["pred"]](a, b)), ir.I1)
                block.insert_before(op, folded)
                _replace_uses_everywhere(module, op.result, folded.result)
                block.remove(op)
                op = folded
        # CSE
        key = _cse_key(op)
        existing = None
        lookup: list[dict[tuple, Value]] = scopes if cross else [seen]
        for scope in reversed(lookup):
            if key in scope:
                existing = scope[key]
                break
        if existing is not None and existing is not op.result:
            _replace_uses_everywhere(module, op.result, existing)
            block.remove(op)
        else:
            seen[key] = op.result


def _replace_uses_everywhere(module: Module, old: Value, new: Value) -> None:
    for op in module.walk():
        op.replace_operand(old, new)


# --------------------------------------------------------------------------
# LICM for pure arith (models MLIR's LICM, enabled by accfg's effect info)
# --------------------------------------------------------------------------


def licm_arith(module: Module) -> None:
    changed = True
    while changed:
        changed = False
        for loop in [op for op in module.walk() if op.name == "scf.for"]:
            body = loop.regions[0].block
            parent = loop.parent
            if parent is None:
                continue
            for op in list(body.ops):
                if not ir.is_pure(op):
                    continue
                if all(not ir.defined_in(o, loop) for o in op.operands):
                    body.remove(op)
                    parent.insert_before(loop, op)
                    changed = True


# --------------------------------------------------------------------------
# DCE
# --------------------------------------------------------------------------


def dce(module: Module) -> None:
    changed = True
    while changed:
        changed = False
        used: set[int] = set()
        for op in module.walk():
            for o in op.operands:
                used.add(id(o))
        for op in list(module.walk()):
            if op.parent is None:
                continue
            if ir.is_pure(op) and not any(id(r) in used for r in op.results):
                ir.erase(op)
                changed = True
            elif op.name == "accfg.setup" and not op.attrs["fields"]:
                # empty setup: forward its input state if it has one
                in_state = ir.setup_in_state(op)
                if in_state is not None:
                    _replace_uses_everywhere(module, op.result, in_state)
                    ir.erase(op)
                    changed = True
                elif id(op.result) not in used:
                    ir.erase(op)
                    changed = True


# --------------------------------------------------------------------------
# Setup merging (§5.4.1 clean-up: merge setups with no launch in between)
# --------------------------------------------------------------------------


def merge_consecutive_setups(module: Module) -> None:
    changed = True
    while changed:
        changed = False
        for op in list(module.walk()):
            if op.name != "accfg.setup" or op.parent is None:
                continue
            in_state = ir.setup_in_state(op)
            if in_state is None or in_state.owner is None:
                continue
            prev = in_state.owner
            if prev.name != "accfg.setup" or prev.parent is not op.parent:
                continue
            if prev.attrs["accel"] != op.attrs["accel"]:
                continue
            # the previous setup's state must feed only this setup
            if len(ir.uses(_root(module, op), in_state)) != 1:
                continue
            # no launch of this accel may sit between the two setups
            ops_between = _between(op.parent, prev, op)
            if any(o.name == "accfg.launch" for o in ops_between):
                continue
            merged = dict(ir.setup_fields(prev))
            merged.update(ir.setup_fields(op))  # later writes win
            new = ir.setup(op.attrs["accel"], merged, ir.setup_in_state(prev))
            # insert at the *later* op's position: all operands of both setups
            # dominate it, and nothing in between observes the register file
            # (no launch between — checked above).
            op.parent.insert_before(op, new)
            _replace_uses_everywhere(module, op.result, new.result)
            ir.erase(prev)
            ir.erase(op)
            changed = True
            break


def _root(module: Module, op: Op) -> Module:
    return module


def _between(block: Block, a: Op, b: Op) -> list[Op]:
    ia, ib = block.ops.index(a), block.ops.index(b)
    return block.ops[ia + 1 : ib]


# --------------------------------------------------------------------------
# The full canonicalization bundle used by the accfg pipeline
# --------------------------------------------------------------------------


def canonicalize(module: Module) -> None:
    constant_fold_and_cse(module, cross_iteration=True)
    licm_arith(module)
    constant_fold_and_cse(module, cross_iteration=True)
    merge_consecutive_setups(module)
    dce(module)
