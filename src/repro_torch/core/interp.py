"""Functional + cycle-approximate interpreter for accfg IR.

The port's own copy of ``repro/core/interp.py``: the code is the
reference's, unchanged.

Two jobs:

1. **Functional oracle.** Execute a program and record the *invocation log*:
   for every ``accfg.launch``, a snapshot of the accelerator's configuration
   registers at launch time. Two programs are observationally equivalent for
   the accelerator iff their invocation logs match — this is the correctness
   criterion all optimization passes are tested against (configuration
   registers retain values, §3.2, which is exactly what deduplication relies
   on).

2. **Timing model.** A two-clock model (host clock, per-accelerator busy-until
   clock) that distinguishes *sequential* configuration (host stalls at launch
   until the macro-op retires, §2.2) from *concurrent* configuration (launch
   returns; ``accfg.await`` synchronizes; setups in between write staging
   registers). Host instruction costs follow the paper: every arith op is one
   host instruction at CPI cycles; every setup field costs the model's
   config-write cycles; Eq. 4's ``T_calc`` emerges naturally from the arith
   ops left in the program.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from . import ir
from .accelerators import AcceleratorModel
from .ir import Module, Op, Value

LOOP_OVERHEAD_INSTRS = 2  # induction add + back-branch per iteration
BRANCH_INSTRS = 1
CALL_INSTRS = 10  # opaque external call (pessimistic)


@dataclass
class Invocation:
    accel: str
    regs: dict[str, int]
    start: float
    end: float


@dataclass
class Trace:
    """Everything the evaluation needs from one program execution."""

    invocations: list[Invocation] = field(default_factory=list)
    host_cycles: float = 0.0  # final host clock
    total_cycles: float = 0.0  # makespan incl. accelerator drain
    config_cycles: float = 0.0  # host cycles writing config registers
    calc_cycles: float = 0.0  # host cycles computing config params (T_calc)
    stall_cycles: float = 0.0  # host cycles stalled on launch/await
    total_ops: int = 0  # accelerator macro-op work
    accel_busy_cycles: float = 0.0

    @property
    def performance(self) -> float:
        """ops/cycle — the y-axis of the configuration roofline plots."""
        return self.total_ops / self.total_cycles if self.total_cycles else 0.0

    @property
    def config_bytes(self) -> int:
        return self._config_bytes

    _config_bytes: int = 0

    @property
    def i_oc(self) -> float:
        """Observed operation-to-configuration intensity (§4.2)."""
        return self.total_ops / self._config_bytes if self._config_bytes else float("inf")

    def log_signature(self) -> list[tuple[str, tuple[tuple[str, int], ...]]]:
        """Hashable form of the invocation log for equivalence checks."""
        return [(i.accel, tuple(sorted(i.regs.items()))) for i in self.invocations]


class Interpreter:
    def __init__(self, models: dict[str, AcceleratorModel]):
        self.models = models
        self.regs: dict[str, dict[str, int]] = {name: {} for name in models}
        self.accel_free: dict[str, float] = {name: 0.0 for name in models}
        self.trace = Trace()
        self.host = 0.0

    # -- cost helpers --------------------------------------------------------

    def _host_instrs(self, n: float, cpi: float, kind: str) -> None:
        cycles = n * cpi
        self.host += cycles
        if kind == "calc":
            self.trace.calc_cycles += cycles
        elif kind == "config":
            self.trace.config_cycles += cycles

    # -- execution -----------------------------------------------------------

    def run(self, module: Module, fn_name: str = "main") -> Trace:
        fn = module.func(fn_name)
        self._run_block(fn.regions[0].block, {})
        # drain: the program is only done once every accelerator retired
        drain = max([self.host, *self.accel_free.values()])
        self.trace.host_cycles = self.host
        self.trace.total_cycles = drain
        return self.trace

    def _run_block(self, block: ir.Block, env: dict[Value, int]) -> list[int]:
        """Execute a block; returns the operand values of its terminator."""
        default_cpi = max(m.host_cpi for m in self.models.values())
        for op in block.ops:
            name = op.name
            if name == "arith.constant":
                env[op.result] = op.attrs["value"]
                self._host_instrs(1, default_cpi, "calc")
            elif name in ir._BINARY_FNS:
                a, b = (env[o] for o in op.operands)
                env[op.result] = ir._BINARY_FNS[name](a, b)
                self._host_instrs(1, default_cpi, "calc")
            elif name == "arith.cmpi":
                a, b = (env[o] for o in op.operands)
                env[op.result] = int(ir._CMP_FNS[op.attrs["pred"]](a, b))
                self._host_instrs(1, default_cpi, "calc")
            elif name == "accfg.setup":
                self._exec_setup(op, env)
            elif name == "accfg.launch":
                self._exec_launch(op, env)
            elif name == "accfg.await":
                self._exec_await(op, env)
            elif name == "scf.for":
                self._exec_for(op, env, default_cpi)
            elif name == "scf.if":
                cond = env[op.operands[0]]
                self._host_instrs(BRANCH_INSTRS, default_cpi, "calc")
                branch = op.regions[0] if cond else op.regions[1]
                outs = self._run_block(branch.block, env)
                for res, val in zip(op.results, outs):
                    env[res] = val
            elif name == "func.call":
                self._host_instrs(CALL_INSTRS, default_cpi, "calc")
            elif name in ("scf.yield", "func.return"):
                return [env.get(o, 0) for o in op.operands]
            else:  # pragma: no cover
                raise NotImplementedError(name)
        return []

    def _exec_for(self, op: Op, env: dict[Value, int], cpi: float) -> None:
        lb, ub, step = (env[o] for o in op.operands[:3])
        body = op.regions[0].block
        iters = [env.get(o, 0) for o in op.operands[3:]]
        for i in range(lb, ub, step):
            env[body.args[0]] = i
            for arg, val in zip(body.args[1:], iters):
                env[arg] = val
            self._host_instrs(LOOP_OVERHEAD_INSTRS, cpi, "calc")
            iters = self._run_block(body, env)
        for res, val in zip(op.results, iters):
            env[res] = val

    def _exec_setup(self, op: Op, env: dict[Value, int]) -> None:
        accel = op.attrs["accel"]
        model = self.models[accel]
        fields = ir.setup_fields(op)
        for fname, value in fields.items():
            self.regs[accel][fname] = env.get(value, 0)
        n = len(fields)
        writes = -(-n // model.fields_per_write) if n else 0  # ceil
        self._host_instrs(writes * model.instrs_per_write, model.host_cpi, "config")
        self.trace._config_bytes += n * model.bytes_per_field
        env[op.result] = 0  # states carry no runtime payload

    def _exec_launch(self, op: Op, env: dict[Value, int]) -> None:
        accel = op.attrs["accel"]
        model = self.models[accel]
        regs = dict(self.regs[accel])
        self._host_instrs(model.launch_instrs, model.host_cpi, "config")
        self.trace._config_bytes += model.bytes_per_field

        duration = model.macro_cycles(regs)
        ops = model.macro_ops(regs)
        if model.concurrent:
            # staged configuration: host only stalls if the unit is still busy
            start = max(self.host, self.accel_free[accel])
            if self.accel_free[accel] > self.host:
                self.trace.stall_cycles += self.accel_free[accel] - self.host
                self.host = self.accel_free[accel]
        else:
            # sequential configuration: the host is stalled until retirement
            start = max(self.host, self.accel_free[accel])
        end = start + duration
        self.accel_free[accel] = end
        if not model.concurrent:
            self.trace.stall_cycles += end - self.host
            self.host = end

        self.trace.invocations.append(Invocation(accel, regs, start, end))
        self.trace.total_ops += ops
        self.trace.accel_busy_cycles += duration
        env[op.result] = len(self.trace.invocations) - 1  # token = invocation id

    def _exec_await(self, op: Op, env: dict[Value, int]) -> None:
        idx = env.get(op.operands[0])
        if idx is None or idx < 0 or idx >= len(self.trace.invocations):
            return
        inv = self.trace.invocations[idx]
        if self.models[inv.accel].concurrent and inv.end > self.host:
            self.trace.stall_cycles += inv.end - self.host
            self.host = inv.end
        # sequential targets already synchronized at launch (await is a no-op)


def run(module: Module, models: dict[str, AcceleratorModel], fn: str = "main") -> Trace:
    return Interpreter(models).run(module, fn)
