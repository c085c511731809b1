"""A minimal SSA intermediate representation for the ``accfg`` abstraction.

The port's own copy of ``repro/core/ir.py``: the code is the
reference's, unchanged.

This is a faithful, self-contained re-implementation of the paper's MLIR/xDSL
dialect stack in pure Python. It models exactly the dialects the paper's passes
operate on:

* ``accfg``  — ``setup`` / ``launch`` / ``await`` plus ``!accfg.state`` and
  ``!accfg.token`` types (The Configuration Wall, §5.1).
* ``arith``  — integer constants and the bit-packing arithmetic that dominates
  effective configuration bandwidth (§4.4, Listing 1).
* ``scf``    — structured control flow (``for`` with iter_args, ``if``/``else``)
  that the state-tracing and overlap passes rewrite (§5.3-§5.5).
* ``func``   — functions and opaque external calls, which act as optimization
  barriers unless annotated with ``effects`` (§5.1's ``#accfg.effects<...>``).

The IR is deliberately small but structurally honest: ops hold operands (SSA
values), attributes (compile-time constants), results and regions; regions hold
a single block with block arguments. All passes mutate this structure in place,
as MLIR rewrites do.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator, Optional

# --------------------------------------------------------------------------
# Types
# --------------------------------------------------------------------------

I64 = "i64"
I1 = "i1"
INDEX = "index"
STATE = "!accfg.state"
TOKEN = "!accfg.token"

_counter = itertools.count()


def _fresh(prefix: str = "v") -> str:
    return f"%{prefix}{next(_counter)}"


# --------------------------------------------------------------------------
# Core structures
# --------------------------------------------------------------------------


@dataclass(eq=False)
class Value:
    """An SSA value. Identity (``is``) equality — the dedup pass relies on the
    SSA property that a value never changes after definition (§5.4)."""

    type: str
    name: str = field(default_factory=_fresh)
    owner: Optional["Op"] = None  # producing op; None for block arguments
    block: Optional["Block"] = None  # owning block if a block argument

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"{self.name}: {self.type}"

    @property
    def is_block_arg(self) -> bool:
        return self.owner is None and self.block is not None


@dataclass(eq=False)
class Block:
    args: list[Value] = field(default_factory=list)
    ops: list["Op"] = field(default_factory=list)
    parent: Optional["Region"] = None

    def add_arg(self, type: str, name: str | None = None) -> Value:
        v = Value(type=type, name=name or _fresh("arg"))
        v.block = self
        self.args.append(v)
        return v

    def insert_before(self, anchor: "Op", op: "Op") -> None:
        op.parent = self
        self.ops.insert(self.ops.index(anchor), op)

    def insert_after(self, anchor: "Op", op: "Op") -> None:
        op.parent = self
        self.ops.insert(self.ops.index(anchor) + 1, op)

    def append(self, op: "Op") -> None:
        op.parent = self
        self.ops.append(op)

    def remove(self, op: "Op") -> None:
        self.ops.remove(op)
        op.parent = None


@dataclass(eq=False)
class Region:
    block: Block = field(default_factory=Block)
    parent: Optional["Op"] = None

    def __post_init__(self) -> None:
        self.block.parent = self


@dataclass(eq=False)
class Op:
    """A generic operation. ``name`` is the fully-qualified op name such as
    ``accfg.setup``; semantics live in the passes/interpreter, like MLIR."""

    name: str
    operands: list[Value] = field(default_factory=list)
    attrs: dict[str, Any] = field(default_factory=dict)
    result_types: list[str] = field(default_factory=list)
    regions: list[Region] = field(default_factory=list)
    parent: Optional[Block] = None

    results: list[Value] = field(init=False)

    def __post_init__(self) -> None:
        self.results = [Value(type=t, owner=self) for t in self.result_types]
        for r in self.regions:
            r.parent = self

    # -- convenience -------------------------------------------------------

    @property
    def result(self) -> Value:
        assert len(self.results) == 1, f"{self.name} has {len(self.results)} results"
        return self.results[0]

    def walk(self) -> Iterator["Op"]:
        yield self
        for region in self.regions:
            for op in list(region.block.ops):
                yield from op.walk()

    def replace_operand(self, old: Value, new: Value) -> None:
        self.operands = [new if o is old else o for o in self.operands]

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return print_op(self)


@dataclass(eq=False)
class Module:
    ops: list[Op] = field(default_factory=list)

    def walk(self) -> Iterator[Op]:
        for op in list(self.ops):
            yield from op.walk()

    def func(self, name: str) -> Op:
        for op in self.ops:
            if op.name == "func.func" and op.attrs.get("sym_name") == name:
                return op
        raise KeyError(name)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "\n".join(print_op(op) for op in self.ops)


# --------------------------------------------------------------------------
# Op constructors (the "dialects")
# --------------------------------------------------------------------------


def constant(value: int, type: str = I64) -> Op:
    return Op("arith.constant", attrs={"value": value}, result_types=[type])


_BINARY_FNS: dict[str, Callable[[int, int], int]] = {
    "arith.addi": lambda a, b: a + b,
    "arith.subi": lambda a, b: a - b,
    "arith.muli": lambda a, b: a * b,
    "arith.ori": lambda a, b: a | b,
    "arith.andi": lambda a, b: a & b,
    "arith.xori": lambda a, b: a ^ b,
    "arith.shli": lambda a, b: a << b,
    "arith.shrui": lambda a, b: a >> b,
}

_CMP_FNS: dict[str, Callable[[int, int], bool]] = {
    "slt": lambda a, b: a < b,
    "sle": lambda a, b: a <= b,
    "sgt": lambda a, b: a > b,
    "sge": lambda a, b: a >= b,
    "eq": lambda a, b: a == b,
    "ne": lambda a, b: a != b,
}


def binary(name: str, lhs: Value, rhs: Value) -> Op:
    assert name in _BINARY_FNS, name
    return Op(name, operands=[lhs, rhs], result_types=[lhs.type])


def cmpi(pred: str, lhs: Value, rhs: Value) -> Op:
    assert pred in _CMP_FNS, pred
    return Op("arith.cmpi", operands=[lhs, rhs], attrs={"pred": pred}, result_types=[I1])


def setup(
    accel: str,
    fields: dict[str, Value],
    in_state: Value | None = None,
) -> Op:
    """``accfg.setup``: write configuration registers; yields the new
    ``!accfg.state`` (§5.1, Figure 6 (1)). ``in_state`` chains to the previous
    live state so the compiler can compute a setup delta."""
    names = list(fields.keys())
    operands = [fields[n] for n in names]
    if in_state is not None:
        assert in_state.type == STATE
        operands.append(in_state)
    return Op(
        "accfg.setup",
        operands=operands,
        attrs={"accel": accel, "fields": names, "has_in_state": in_state is not None},
        result_types=[STATE],
    )


def setup_fields(op: Op) -> dict[str, Value]:
    assert op.name == "accfg.setup"
    names = op.attrs["fields"]
    return dict(zip(names, op.operands[: len(names)]))


def setup_in_state(op: Op) -> Value | None:
    assert op.name == "accfg.setup"
    return op.operands[-1] if op.attrs["has_in_state"] else None


def set_setup_in_state(op: Op, state: Value | None) -> None:
    """Attach/detach the chained input state of an ``accfg.setup``."""
    assert op.name == "accfg.setup"
    n = len(op.attrs["fields"])
    op.operands = op.operands[:n] + ([state] if state is not None else [])
    op.attrs["has_in_state"] = state is not None


def launch(state: Value, accel: str) -> Op:
    assert state.type == STATE
    return Op("accfg.launch", operands=[state], attrs={"accel": accel}, result_types=[TOKEN])


def await_(token: Value) -> Op:
    assert token.type == TOKEN
    return Op("accfg.await", operands=[token])


def for_(
    lb: Value,
    ub: Value,
    step: Value,
    iter_inits: list[Value] | None = None,
) -> Op:
    """``scf.for`` with iter_args. The body block receives (iv, *iter_args)."""
    iter_inits = iter_inits or []
    region = Region()
    region.block.add_arg(INDEX, _fresh("iv"))
    for init in iter_inits:
        region.block.add_arg(init.type)
    return Op(
        "scf.for",
        operands=[lb, ub, step, *iter_inits],
        result_types=[v.type for v in iter_inits],
        regions=[region],
    )


def if_(cond: Value, result_types: list[str] | None = None) -> Op:
    assert cond.type == I1
    return Op(
        "scf.if",
        operands=[cond],
        result_types=result_types or [],
        regions=[Region(), Region()],
    )


def yield_(values: list[Value]) -> Op:
    return Op("scf.yield", operands=list(values))


def func(name: str) -> Op:
    return Op("func.func", attrs={"sym_name": name}, regions=[Region()])


def call(callee: str, args: list[Value], effects: str = "all") -> Op:
    """An opaque external call. ``effects`` mirrors ``#accfg.effects<...>``:
    ``"all"`` clobbers accelerator state (the pessimistic default), ``"none"``
    preserves it (§5.1)."""
    assert effects in ("all", "none")
    return Op("func.call", operands=list(args), attrs={"callee": callee, "effects": effects})


def return_(values: list[Value] | None = None) -> Op:
    return Op("func.return", operands=list(values or []))


# --------------------------------------------------------------------------
# Structural helpers shared by passes
# --------------------------------------------------------------------------


def replace_all_uses(root: Op | Module, old: Value, new: Value) -> None:
    """Replace every use of ``old`` with ``new`` underneath ``root``."""
    for op in root.walk() if isinstance(root, Module) else root.walk():
        op.replace_operand(old, new)


def uses(root: Op | Module, value: Value) -> list[Op]:
    return [op for op in root.walk() for o in op.operands if o is value]


def erase(op: Op) -> None:
    assert op.parent is not None, "op not attached"
    op.parent.remove(op)


def for_iter_args(op: Op) -> list[Value]:
    assert op.name == "scf.for"
    return op.regions[0].block.args[1:]


def for_iter_inits(op: Op) -> list[Value]:
    assert op.name == "scf.for"
    return op.operands[3:]


def for_yield(op: Op) -> Op:
    assert op.name == "scf.for"
    term = op.regions[0].block.ops[-1]
    assert term.name == "scf.yield"
    return term


def add_iter_arg(loop: Op, init: Value, yielded: Value) -> tuple[Value, Value]:
    """Grow an ``scf.for`` by one iter_arg. Returns (block_arg, loop_result)."""
    assert loop.name == "scf.for"
    loop.operands.append(init)
    block_arg = loop.regions[0].block.add_arg(init.type)
    for_yield(loop).operands.append(yielded)
    result = Value(type=init.type, owner=loop)
    loop.results.append(result)
    loop.result_types.append(init.type)
    return block_arg, result


def if_yields(op: Op) -> tuple[Op, Op]:
    assert op.name == "scf.if"
    then_term = op.regions[0].block.ops[-1]
    else_term = op.regions[1].block.ops[-1]
    assert then_term.name == "scf.yield" and else_term.name == "scf.yield"
    return then_term, else_term


def add_if_result(op: Op, then_val: Value, else_val: Value) -> Value:
    """Grow an ``scf.if`` by one result yielded from both branches."""
    assert then_val.type == else_val.type
    then_term, else_term = if_yields(op)
    then_term.operands.append(then_val)
    else_term.operands.append(else_val)
    result = Value(type=then_val.type, owner=op)
    op.results.append(result)
    op.result_types.append(then_val.type)
    return result


def clone_op(op: Op, mapping: dict[Value, Value]) -> Op:
    """Clone a region-free op, remapping operands through ``mapping``."""
    assert not op.regions, "clone_op only supports region-free ops"
    new = Op(
        op.name,
        operands=[mapping.get(o, o) for o in op.operands],
        attrs=dict(op.attrs),
        result_types=list(op.result_types),
    )
    for old_res, new_res in zip(op.results, new.results):
        mapping[old_res] = new_res
    return new


def defined_in(value: Value, op: Op) -> bool:
    """True if ``value`` is defined inside (any region of) ``op``."""
    node: Optional[Block] = value.block if value.is_block_arg else (
        value.owner.parent if value.owner is not None else None
    )
    while node is not None:
        parent_op = node.parent.parent if node.parent is not None else None
        if parent_op is op:
            return True
        node = parent_op.parent if parent_op is not None else None
    return False


def is_pure(op: Op) -> bool:
    """Pure ops can be duplicated/moved freely by the overlap pass (§5.5)."""
    return op.name.startswith("arith.")


# --------------------------------------------------------------------------
# Printing (textual IR, for debugging and golden tests)
# --------------------------------------------------------------------------


def print_op(op: Op, indent: int = 0) -> str:
    pad = "  " * indent
    parts: list[str] = []
    res = ", ".join(v.name for v in op.results)
    head = f"{res} = " if op.results else ""
    if op.name == "accfg.setup":
        fields = setup_fields(op)
        in_state = setup_in_state(op)
        frm = f" from {in_state.name}" if in_state is not None else ""
        body = ", ".join(f'"{k}" = {v.name}' for k, v in fields.items())
        parts.append(f'{pad}{head}accfg.setup on "{op.attrs["accel"]}"{frm} to ({body})')
    elif op.name == "arith.constant":
        parts.append(f"{pad}{head}arith.constant {op.attrs['value']}")
    else:
        args = ", ".join(v.name for v in op.operands)
        attrs = {k: v for k, v in op.attrs.items() if k not in ("fields", "has_in_state")}
        suffix = f" {attrs}" if attrs else ""
        parts.append(f"{pad}{head}{op.name}({args}){suffix}")
    for region in op.regions:
        args = ", ".join(f"{a.name}: {a.type}" for a in region.block.args)
        parts.append(f"{pad}{{ ({args})")
        for inner in region.block.ops:
            parts.append(print_op(inner, indent + 1))
        parts.append(f"{pad}}}")
    return "\n".join(parts)


def print_module(module: Module) -> str:
    return "\n".join(print_op(op) for op in module.ops)
