"""Configuration deduplication (§5.4) + setup hoisting into branches (§5.4.1).

The port's own copy of ``repro/core/passes/dedup.py``: the code is the
reference's, unchanged.

The pass walks the use-def chain of ``!accfg.state`` values to reconstruct,
per state, a map of configuration fields whose contents are *known as SSA
values*. A field write is redundant — and removed — when the traced input
state provably already holds the same SSA value. SSA-value identity is the
equivalence proxy: an SSA value never changes, so equal values imply equal
runtime register contents (§5.4). Loop-carried values (e.g. addresses derived
from the induction variable) are naturally distinct SSA values per iteration
and are never deduplicated.

Control flow is handled by *intersection*: the known map of a loop-carried
state is ``known(init) ∩ known(yielded)`` (fixpoint, computed optimistically
with a TOP marker on the back-edge), and an ``scf.if`` state result meets the
two branch yields.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import ir
from ..ir import Module, Op, Value


@dataclass(frozen=True)
class Known:
    """Abstract register file: ``fields`` maps register → SSA value; ``rest``
    says what we know about unlisted registers ("top" = preserved through the
    back-edge being computed; "unknown" = anything)."""

    fields: dict[str, Value] = field(default_factory=dict)
    rest: str = "unknown"  # "top" | "unknown"

    def lookup(self, name: str) -> Value | None:
        return self.fields.get(name)

    def with_writes(self, writes: dict[str, Value]) -> "Known":
        merged = dict(self.fields)
        merged.update(writes)
        return Known(merged, self.rest)


TOP = Known({}, "top")
UNKNOWN = Known({}, "unknown")

_SENTINEL_CONFLICT = object()


def intersect(a: Known, b: Known) -> Known:
    if a.rest == "top" and not a.fields:
        return b
    if b.rest == "top" and not b.fields:
        return a
    out: dict[str, Value] = {}
    for key in set(a.fields) | set(b.fields):
        va = a.fields.get(key, _SENTINEL_CONFLICT if a.rest == "unknown" else None)
        vb = b.fields.get(key, _SENTINEL_CONFLICT if b.rest == "unknown" else None)
        if va is None:  # a preserves: take b's knowledge
            va = vb
        if vb is None:
            vb = va
        if va is vb and va is not _SENTINEL_CONFLICT and va is not None:
            out[key] = va
    rest = "top" if (a.rest == "top" and b.rest == "top") else "unknown"
    return Known(out, rest)


class KnownMaps:
    """Memoized known-map computation over state values."""

    def __init__(self) -> None:
        self._cache: dict[int, Known] = {}
        self._in_progress: set[int] = set()

    def of(self, state: Value) -> Known:
        key = id(state)
        if key in self._cache:
            return self._cache[key]
        if key in self._in_progress:
            return TOP  # optimistic back-edge: "preserved"; intersection fixes it
        self._in_progress.add(key)
        try:
            result = self._compute(state)
        finally:
            self._in_progress.discard(key)
        self._cache[key] = result
        return result

    def _compute(self, state: Value) -> Known:
        if state.is_block_arg:
            block = state.block
            loop = block.parent.parent if block.parent else None
            if loop is not None and loop.name == "scf.for":
                idx = block.args.index(state) - 1  # skip induction variable
                init = ir.for_iter_inits(loop)[idx]
                yielded = ir.for_yield(loop).operands[idx]
                return intersect(self.of(init), self.of(yielded))
            return UNKNOWN  # e.g. function argument
        owner = state.owner
        assert owner is not None
        if owner.name == "accfg.setup":
            in_state = ir.setup_in_state(owner)
            base = self.of(in_state) if in_state is not None else UNKNOWN
            return base.with_writes(ir.setup_fields(owner))
        if owner.name == "scf.for":
            idx = owner.results.index(state)
            init = ir.for_iter_inits(owner)[idx]
            yielded = ir.for_yield(owner).operands[idx]
            return intersect(self.of(init), self.of(yielded))
        if owner.name == "scf.if":
            idx = owner.results.index(state)
            then_term, else_term = ir.if_yields(owner)
            return intersect(self.of(then_term.operands[idx]), self.of(else_term.operands[idx]))
        return UNKNOWN


def _remove_fields(op: Op, names: set[str]) -> None:
    fields = ir.setup_fields(op)
    in_state = ir.setup_in_state(op)
    kept = {k: v for k, v in fields.items() if k not in names}
    op.attrs["fields"] = list(kept.keys())
    op.attrs["has_in_state"] = in_state is not None
    op.operands = list(kept.values()) + ([in_state] if in_state is not None else [])


def dedup(module: Module) -> int:
    """Remove provably redundant field writes. Returns #fields removed."""
    maps = KnownMaps()
    removed = 0
    # compute first, mutate after: removing a *redundant* write never changes
    # any state's contents, so the memoized maps stay valid.
    plan: list[tuple[Op, set[str]]] = []
    for op in module.walk():
        if op.name != "accfg.setup":
            continue
        in_state = ir.setup_in_state(op)
        if in_state is None:
            continue
        prior = maps.of(in_state)
        redundant = {f for f, v in ir.setup_fields(op).items() if prior.lookup(f) is v}
        if redundant:
            plan.append((op, redundant))
    for op, redundant in plan:
        _remove_fields(op, redundant)
        removed += len(redundant)
    return removed


# --------------------------------------------------------------------------
# Hoisting setups into branches (§5.4.1)
# --------------------------------------------------------------------------


def hoist_setups_into_branches(module: Module) -> int:
    """If a setup's input state comes out of an ``scf.if``, clone it into both
    branches so each side regains a linear setup chain for dedup."""
    hoisted = 0
    changed = True
    while changed:
        changed = False
        for op in list(module.walk()):
            if op.name != "accfg.setup" or op.parent is None:
                continue
            in_state = ir.setup_in_state(op)
            if in_state is None or in_state.owner is None:
                continue
            if_op = in_state.owner
            if if_op.name != "scf.if" or if_op.parent is not op.parent:
                continue
            # no other op may consume the if's state between the if and the setup
            block = op.parent
            between = block.ops[block.ops.index(if_op) + 1 : block.ops.index(op)]
            if any(in_state in o.operands for o in between):
                continue
            # all field operands must dominate the scf.if
            if any(ir.defined_in(v, if_op) for v in ir.setup_fields(op).values()):
                continue
            if any(
                v.owner is not None
                and v.owner.parent is block
                and block.ops.index(v.owner) > block.ops.index(if_op)
                for v in ir.setup_fields(op).values()
            ):
                continue
            idx = if_op.results.index(in_state)
            then_term, else_term = ir.if_yields(if_op)
            for term in (then_term, else_term):
                clone = ir.setup(
                    op.attrs["accel"], dict(ir.setup_fields(op)), term.operands[idx]
                )
                term.parent.insert_before(term, clone)
                term.operands[idx] = clone.result
            # the if's state result now carries the post-setup state
            for use in module.walk():
                if use is not op:
                    use.replace_operand(op.result, in_state)
            ir.erase(op)
            hoisted += 1
            changed = True
            break
    return hoisted
