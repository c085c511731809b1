"""Target lowering (Figure 8, step 5): accfg → accelerator setup sequences.

The port's own copy of ``repro/core/lowering.py``: the code is the
reference's, unchanged.

The only accelerator-specific stage of the pipeline. Each backend translates
``accfg.setup`` / ``launch`` / ``await`` into its native configuration
instructions — RoCC custom instructions for the Gemmini-class target (two
64-bit fields per instruction, Listing 1 style), CSR writes for the
OpenGeMM-class target — and leaves the surrounding scalar/loop code as a
portable pseudo-assembly. The emitted program is a faithful instruction-level
rendering of what the interpreter charges cycles for, so instruction counts
reconcile with the timing model (tested).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import ir
from .accelerators import AcceleratorModel
from .ir import Module, Op


@dataclass
class LoweredProgram:
    lines: list[str] = field(default_factory=list)
    config_instrs: int = 0  # setup-register writes (static sites)
    launch_instrs: int = 0
    calc_instrs: int = 0  # scalar parameter computation
    control_instrs: int = 0  # loops/branches
    # trip-weighted (dynamic) counts, for statically-bounded loops
    dyn_config_instrs: int = 0
    dyn_calc_instrs: int = 0

    @property
    def total_instrs(self) -> int:
        return (
            self.config_instrs + self.launch_instrs + self.calc_instrs
            + self.control_instrs
        )

    def text(self) -> str:
        return "\n".join(self.lines)


_CALC_MNEMONIC = {
    "arith.addi": "add", "arith.subi": "sub", "arith.muli": "mul",
    "arith.ori": "or", "arith.andi": "and", "arith.xori": "xor",
    "arith.shli": "slli", "arith.shrui": "srli", "arith.cmpi": "slt",
    "arith.constant": "li",
}


class Lowering:
    def __init__(self, models: dict[str, AcceleratorModel]):
        self.models = models
        self.prog = LoweredProgram()
        self._reg = 0
        self._regs: dict[int, str] = {}
        self._mult = 1  # trip-count multiplier of the enclosing loops

    def reg(self, value) -> str:
        key = id(value)
        if key not in self._regs:
            self._regs[key] = f"x{self._reg % 28 + 4}"
            self._reg += 1
        return self._regs[key]

    def emit(self, line: str, kind: str, n: int = 1, indent: int = 1) -> None:
        self.prog.lines.append("  " * indent + line)
        setattr(self.prog, f"{kind}_instrs", getattr(self.prog, f"{kind}_instrs") + n)
        if kind in ("config", "calc"):
            attr = f"dyn_{kind}_instrs"
            setattr(self.prog, attr, getattr(self.prog, attr) + n * self._mult)

    def lower(self, module: Module, fn: str = "main") -> LoweredProgram:
        func = module.func(fn)
        self.prog.lines.append(f"{fn}:")
        self._block(func.regions[0].block, 1)
        self.prog.lines.append("  ret")
        return self.prog

    def _block(self, block: ir.Block, indent: int) -> None:
        for op in block.ops:
            self._op(op, indent)

    def _op(self, op: Op, indent: int) -> None:
        name = op.name
        if name == "arith.constant":
            self.emit(f"li    {self.reg(op.result)}, {op.attrs['value']}",
                      "calc", 1, indent)
        elif name in _CALC_MNEMONIC and name != "arith.constant":
            args = ", ".join(self.reg(o) for o in op.operands)
            self.emit(f"{_CALC_MNEMONIC[name]:5s} {self.reg(op.results[0])}, {args}",
                      "calc", 1, indent)
        elif name == "accfg.setup":
            self._setup(op, indent)
        elif name == "accfg.launch":
            model = self.models[op.attrs["accel"]]
            mnem = "rocc.launch" if model.fields_per_write == 2 else "csrw  launch, 1"
            self.emit(f"{mnem:24s} # start {op.attrs['accel']}",
                      "launch", model.launch_instrs, indent)
        elif name == "accfg.await":
            self.emit("await                    # poll status register",
                      "launch", 1, indent)
        elif name == "scf.for":
            lb, ub, step = (self.reg(o) for o in op.operands[:3])
            iv = self.reg(op.regions[0].block.args[0])
            self.emit(f"loop  {iv} = {lb}..{ub} step {step}:", "control", 2, indent)
            trips = self._static_trips(op)
            outer = self._mult
            self._mult *= trips
            self._block(op.regions[0].block, indent + 1)
            self._mult = outer
        elif name == "scf.if":
            self.emit(f"bnez  {self.reg(op.operands[0])}, then:", "control", 1, indent)
            self._block(op.regions[0].block, indent + 1)
            self.prog.lines.append("  " * indent + "else:")
            self._block(op.regions[1].block, indent + 1)
        elif name == "func.call":
            self.emit(f"call  {op.attrs['callee']}", "control", 1, indent)
        elif name in ("scf.yield", "func.return"):
            pass
        else:  # pragma: no cover
            raise NotImplementedError(name)

    @staticmethod
    def _static_trips(op: Op) -> int:
        vals = []
        for o in op.operands[:3]:
            if o.owner is not None and o.owner.name == "arith.constant":
                vals.append(o.owner.attrs["value"])
            else:
                return 1  # dynamic bounds: count the body once
        lb, ub, step = vals
        return max((ub - lb + step - 1) // step, 0) if step else 1

    def _setup(self, op: Op, indent: int) -> None:
        model = self.models[op.attrs["accel"]]
        fields = ir.setup_fields(op)
        names = list(fields)
        if model.fields_per_write == 2:  # RoCC: rs1/rs2 pairs
            for i in range(0, len(names), 2):
                pair = names[i : i + 2]
                regs = ", ".join(self.reg(fields[p]) for p in pair)
                self.emit(
                    f"rocc.cfg {regs:14s} # {'+'.join(pair)}",
                    "config", model.instrs_per_write, indent,
                )
        else:  # CSR-mapped configuration registers
            for n in names:
                self.emit(
                    f"csrw  {n}, {self.reg(fields[n])}",
                    "config", model.instrs_per_write, indent,
                )


def lower(module: Module, models: dict[str, AcceleratorModel]) -> LoweredProgram:
    return Lowering(models).lower(module)
