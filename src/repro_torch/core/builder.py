"""An imperative constructor for accfg IR programs from Python.

The port's own copy of ``repro/core/builder.py``: the code is the
reference's, unchanged.

Mirrors MLIR's ``OpBuilder`` and xDSL's equivalent: a cursor into a block,
context managers for structured control flow, and tiny helpers for the arith
ops that dominate configuration-parameter calculation (bit packing, address
arithmetic — §4.4 of the paper).
"""

from __future__ import annotations

from contextlib import contextmanager
from typing import Iterator

from . import ir
from .ir import Block, Module, Op, Value


class Builder:
    def __init__(self) -> None:
        self.module = Module()
        self._block_stack: list[Block] = []

    # -- insertion ----------------------------------------------------------

    @property
    def block(self) -> Block:
        return self._block_stack[-1]

    def insert(self, op: Op) -> Op:
        self.block.append(op)
        return op

    # -- functions ----------------------------------------------------------

    @contextmanager
    def function(self, name: str) -> Iterator[Op]:
        fn = ir.func(name)
        self.module.ops.append(fn)
        self._block_stack.append(fn.regions[0].block)
        try:
            yield fn
        finally:
            if not self.block.ops or self.block.ops[-1].name != "func.return":
                self.insert(ir.return_())
            self._block_stack.pop()

    # -- arith ---------------------------------------------------------------

    def const(self, value: int, type: str = ir.I64) -> Value:
        return self.insert(ir.constant(value, type)).result

    def index(self, value: int) -> Value:
        return self.insert(ir.constant(value, ir.INDEX)).result

    def add(self, a: Value, b: Value) -> Value:
        return self.insert(ir.binary("arith.addi", a, b)).result

    def sub(self, a: Value, b: Value) -> Value:
        return self.insert(ir.binary("arith.subi", a, b)).result

    def mul(self, a: Value, b: Value) -> Value:
        return self.insert(ir.binary("arith.muli", a, b)).result

    def or_(self, a: Value, b: Value) -> Value:
        return self.insert(ir.binary("arith.ori", a, b)).result

    def shl(self, a: Value, b: Value) -> Value:
        return self.insert(ir.binary("arith.shli", a, b)).result

    def cmp(self, pred: str, a: Value, b: Value) -> Value:
        return self.insert(ir.cmpi(pred, a, b)).result

    def pack(self, *parts: tuple[Value, int]) -> Value:
        """Bit-pack ``(value, shift)`` pairs with shl/or — the pattern from
        Gemmini's C API (Listing 1) whose host cycles degrade the *effective*
        configuration bandwidth (Eq. 4)."""
        acc: Value | None = None
        for value, shift in parts:
            shifted = self.shl(value, self.const(shift)) if shift else value
            acc = shifted if acc is None else self.or_(acc, shifted)
        assert acc is not None
        return acc

    # -- accfg ----------------------------------------------------------------

    def setup(
        self,
        accel: str,
        fields: dict[str, Value],
        in_state: Value | None = None,
    ) -> Value:
        return self.insert(ir.setup(accel, fields, in_state)).result

    def launch(self, state: Value, accel: str) -> Value:
        return self.insert(ir.launch(state, accel)).result

    def await_(self, token: Value) -> None:
        self.insert(ir.await_(token))

    def call(self, callee: str, args: list[Value] | None = None, effects: str = "all") -> None:
        self.insert(ir.call(callee, args or [], effects))

    # -- scf ------------------------------------------------------------------

    @contextmanager
    def for_(
        self,
        lb: Value,
        ub: Value,
        step: Value,
        iter_inits: list[Value] | None = None,
    ) -> Iterator[tuple[Op, Value, list[Value]]]:
        """``with b.for_(lb, ub, step, [init]) as (loop, iv, iters): ...``

        The body must end by calling :meth:`yield_` with one value per
        iter_arg (checked on exit)."""
        loop = ir.for_(lb, ub, step, iter_inits)
        self.insert(loop)
        body = loop.regions[0].block
        self._block_stack.append(body)
        try:
            yield loop, body.args[0], body.args[1:]
        finally:
            if not body.ops or body.ops[-1].name != "scf.yield":
                assert not loop.results, "loop with iter_args must yield"
                self.insert(ir.yield_([]))
            self._block_stack.pop()

    def yield_(self, values: list[Value] | None = None) -> None:
        self.insert(ir.yield_(values or []))

    @contextmanager
    def if_(self, cond: Value, result_types: list[str] | None = None) -> Iterator[Op]:
        op = ir.if_(cond, result_types)
        self.insert(op)
        yield op

    @contextmanager
    def then(self, if_op: Op) -> Iterator[Block]:
        self._block_stack.append(if_op.regions[0].block)
        try:
            yield self.block
        finally:
            if not self.block.ops or self.block.ops[-1].name != "scf.yield":
                self.insert(ir.yield_([]))
            self._block_stack.pop()

    @contextmanager
    def else_(self, if_op: Op) -> Iterator[Block]:
        self._block_stack.append(if_op.regions[1].block)
        try:
            yield self.block
        finally:
            if not self.block.ops or self.block.ops[-1].name != "scf.yield":
                self.insert(ir.yield_([]))
            self._block_stack.pop()
