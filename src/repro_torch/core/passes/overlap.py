"""Configuration–computation overlap (§5.5).

The port's own copy of ``repro/core/passes/overlap.py``: the code is the
reference's, unchanged.

For concurrent-configuration targets, reschedule setup sequences to run while
the accelerator is busy:

* **Loop pipelining** (Figure 9, right): for a loop body of the canonical
  ``setup → launch → await`` form, peel iteration-0's setup in front of the
  loop (induction variable replaced by the lower bound), launch from the
  loop-carried state, and stage iteration ``i+1``'s setup *between* launch and
  await. The setup sequence — the setup op plus the pure ops computing its
  fields — must be pure and depend only on the induction variable and
  loop-invariants.
* **Straight-line motion**: a setup whose operands all dominate an earlier
  ``await`` in the same block is moved up in front of that await.
"""

from __future__ import annotations

from .. import ir
from ..ir import Block, Module, Op, Value


def overlap(module: Module, concurrent_accels: set[str]) -> int:
    moved = 0
    for loop in [op for op in module.walk() if op.name == "scf.for"]:
        moved += _pipeline_loop(loop, concurrent_accels)
    for fn in module.ops:
        if fn.name == "func.func":
            for block in _all_blocks(fn):
                moved += _straight_line(block, concurrent_accels)
    return moved


def _all_blocks(op: Op) -> list[Block]:
    blocks = []
    for inner in op.walk():
        for region in inner.regions:
            blocks.append(region.block)
    return blocks


# --------------------------------------------------------------------------
# Loop pipelining
# --------------------------------------------------------------------------


def _pure_slice(setup_op: Op, body: Block, iv: Value) -> list[Op] | None:
    """Backward slice of the setup's field operands inside ``body``. Returns
    the slice in execution order, or None if it contains impure ops or leaves
    other than the induction variable / loop-external values."""
    loop = body.parent.parent
    slice_ops: list[Op] = []
    seen: set[int] = set()

    def visit(value: Value) -> bool:
        if value is iv or not ir.defined_in(value, loop):
            return True
        if value.is_block_arg:
            return False  # an iter_arg (e.g. the state): not movable
        owner = value.owner
        assert owner is not None
        if owner.parent is not body:
            return False
        if not ir.is_pure(owner):
            return False
        if id(owner) not in seen:
            seen.add(id(owner))
            for o in owner.operands:
                if not visit(o):
                    return False
            slice_ops.append(owner)
        return True

    for v in ir.setup_fields(setup_op).values():
        if not visit(v):
            return None
    return slice_ops


def _enclosing_function(op: Op) -> Op | None:
    node = op
    while node is not None:
        if node.name == "func.func":
            return node
        block = node.parent
        if block is None or block.parent is None:
            return None
        node = block.parent.parent
    return None


def _escape_is_safe(root: Op, state: Value, affected: frozenset, seen: set) -> bool:
    """Pipelining stages one extra setup whose writes (``affected`` fields)
    are observable through the loop's escaping state. That is only sound if
    every path from the escaping state to a later ``launch`` first rewrites
    all affected fields (or never reaches a launch)."""
    if (id(state), affected) in seen:
        return True
    seen.add((id(state), affected))
    for op in root.walk():
        for operand in op.operands:
            if operand is not state:
                continue
            if op.name == "accfg.launch":
                return False  # stale staged fields would be launched
            if op.name == "accfg.setup":
                remaining = affected - frozenset(op.attrs["fields"])
                if remaining and not _escape_is_safe(root, op.result, remaining, seen):
                    return False
            elif op.name == "scf.yield":
                parent_op = op.parent.parent.parent if op.parent.parent else None
                if parent_op is None:
                    continue
                idx = op.operands.index(operand)
                if parent_op.name == "scf.for":
                    arg = parent_op.regions[0].block.args[1 + idx]
                    if not _escape_is_safe(root, arg, affected, seen):
                        return False
                if idx < len(parent_op.results) and not _escape_is_safe(
                    root, parent_op.results[idx], affected, seen
                ):
                    return False
            elif op.name == "scf.for":
                # used as an iter init: flows into the block arg and result
                idx = op.operands.index(operand) - 3
                if idx >= 0:
                    arg = op.regions[0].block.args[1 + idx]
                    if not _escape_is_safe(root, arg, affected, seen):
                        return False
                    if not _escape_is_safe(root, op.results[idx], affected, seen):
                        return False
    return True


def _scan_successors(ops, accel: str, fields: frozenset) -> tuple[bool, frozenset]:
    """Walk ops in program order tracking which staged fields are still
    physically live in the register file. A same-accelerator launch while any
    staged field survives would observe the pipelined (future) configuration.
    Opaque calls do NOT sanitize — registers retain values across them."""
    for op in ops:
        if op.name == "accfg.setup" and op.attrs["accel"] == accel:
            fields = fields - frozenset(op.attrs["fields"])
        elif op.name == "accfg.launch" and op.attrs["accel"] == accel:
            if fields:
                return False, fields
        elif op.name == "scf.if":
            s1, f1 = _scan_successors(op.regions[0].block.ops, accel, fields)
            s2, f2 = _scan_successors(op.regions[1].block.ops, accel, fields)
            if not (s1 and s2):
                return False, fields
            fields = f1 | f2  # either branch may have executed
        elif op.name == "scf.for":
            s1, f1 = _scan_successors(op.regions[0].block.ops, accel, fields)
            if not s1:
                return False, fields
            fields = fields | f1  # 0-trip leaves fields; ≥1 trip leaves f1
    return True, fields


def _physically_safe(loop: Op, accel: str, affected: frozenset) -> bool:
    """The staged extra setup must never be observed by a later launch via
    the *physical* register file — including paths where opaque calls broke
    the SSA state chain (analysis barrier ≠ register reset)."""
    node: Op = loop
    fields = affected
    while True:
        block = node.parent
        if block is None:
            return True
        idx = block.ops.index(node)
        ok, fields = _scan_successors(block.ops[idx + 1 :], accel, fields)
        if not ok:
            return False
        if not fields:
            return True
        region = block.parent
        parent_op = region.parent if region is not None else None
        if parent_op is None or parent_op.name == "func.func":
            return True
        if parent_op.name == "scf.for":
            # next iteration of the enclosing loop re-executes its body
            ok, f1 = _scan_successors(block.ops, accel, fields)
            if not ok:
                return False
            fields = fields | f1
        node = parent_op


def _pipeline_loop(loop: Op, concurrent: set[str]) -> int:
    body = loop.regions[0].block
    parent = loop.parent
    if parent is None:
        return 0
    iv = body.args[0]
    lb, _ub, step = loop.operands[0], loop.operands[1], loop.operands[2]

    # find the canonical trio per concurrent accelerator
    trios: list[tuple[Op, Op, Op]] = []
    for accel in sorted(concurrent):
        setups = [o for o in body.ops if o.name == "accfg.setup" and o.attrs["accel"] == accel]
        launches = [o for o in body.ops if o.name == "accfg.launch" and o.attrs["accel"] == accel]
        if len(setups) != 1 or len(launches) != 1:
            continue
        s, l = setups[0], launches[0]
        if l.operands[0] is not s.result:
            continue
        awaits = [o for o in body.ops if o.name == "accfg.await" and o.operands[0] is l.result]
        if len(awaits) != 1:
            continue
        w = awaits[0]
        if not (body.ops.index(s) < body.ops.index(l) < body.ops.index(w)):
            continue
        trios.append((s, l, w))

    moved = 0
    for s, l, w in trios:
        in_state = ir.setup_in_state(s)
        if in_state is None or not (in_state.is_block_arg and in_state.block is body):
            continue
        arg_idx = body.args.index(in_state) - 1
        # the loop must yield this setup's state (state tracing guarantees it)
        yld = ir.for_yield(loop)
        if yld.operands[arg_idx] is not s.result:
            continue
        slice_ops = _pure_slice(s, body, iv)
        if slice_ops is None:
            continue

        # soundness: the staged extra setup escapes through the loop result
        # (SSA) AND through the physical register file (which opaque calls do
        # not reset) — no later launch may observe its fields un-rewritten
        fn = _enclosing_function(loop)
        affected = frozenset(s.attrs["fields"])
        if fn is not None and not _escape_is_safe(
            fn, loop.results[arg_idx], affected, set()
        ):
            continue
        if not _physically_safe(loop, s.attrs["accel"], affected):
            continue

        # 1. prologue: clone slice + setup before the loop with iv -> lb
        mapping: dict[Value, Value] = {iv: lb}
        for op in slice_ops:
            clone = ir.clone_op(op, mapping)
            parent.insert_before(loop, clone)
        init = ir.for_iter_inits(loop)[arg_idx]
        pre_setup = ir.setup(
            s.attrs["accel"],
            {k: mapping.get(v, v) for k, v in ir.setup_fields(s).items()},
            init,
        )
        parent.insert_before(loop, pre_setup)
        loop.operands[3 + arg_idx] = pre_setup.result

        # 2. launch from the loop-carried (staged-last-iteration) state
        l.replace_operand(s.result, in_state)

        # 3. stage iteration i+1 between launch and await
        iv_next_op = ir.binary("arith.addi", iv, step)
        body.insert_after(l, iv_next_op)
        next_mapping: dict[Value, Value] = {iv: iv_next_op.result}
        anchor = iv_next_op
        for op in slice_ops:
            clone = ir.clone_op(op, next_mapping)
            body.insert_after(anchor, clone)
            anchor = clone
        s_fields = {
            k: next_mapping.get(v, v) for k, v in ir.setup_fields(s).items()
        }
        new_setup = ir.setup(s.attrs["accel"], s_fields, in_state)
        body.insert_after(anchor, new_setup)
        # re-point every use of the old setup's state (yield, launches later)
        for use in loop.walk():
            if use is not new_setup:
                use.replace_operand(s.result, new_setup.result)
        ir.erase(s)
        moved += 1
    return moved


# --------------------------------------------------------------------------
# Straight-line motion
# --------------------------------------------------------------------------


def _straight_line(block: Block, concurrent: set[str]) -> int:
    moved = 0
    changed = True
    while changed:
        changed = False
        for idx, op in enumerate(block.ops):
            if op.name != "accfg.setup" or op.attrs["accel"] not in concurrent:
                continue
            target = _earliest_await(block, idx, op)
            if target is not None:
                block.remove(op)
                block.insert_before(target, op)
                moved += 1
                changed = True
                break
    return moved


def _earliest_await(block: Block, setup_idx: int, setup_op: Op) -> Op | None:
    """Earliest await (of a different accelerator invocation) the setup can
    move in front of: all of the setup's operands must be defined before it."""
    operands = set(map(id, setup_op.operands))
    best: Op | None = None
    for j in range(setup_idx - 1, -1, -1):
        op = block.ops[j]
        if any(id(r) in operands for r in op.results):
            break
        if op.name == "accfg.await":
            best = op
        elif op.name in ("accfg.launch", "accfg.setup") and op.attrs.get(
            "accel"
        ) == setup_op.attrs["accel"]:
            break  # don't cross same-accelerator configuration traffic
        elif op.name in ("scf.for", "scf.if", "func.call"):
            break
    return best
