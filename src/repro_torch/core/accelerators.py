"""Cycle-approximate models of register-configured accelerators.

The port's own copy of ``repro/core/accelerators.py`` (plain Python, no
framework): the calibrated compute model prices launches against these.

The paper evaluates on two open-source RISC-V systems:

* **Gemmini** [19] — 16×16 systolic array behind a Rocket host. *Sequential*
  configuration: the host stalls while the accelerator runs (§2.2, §2.4).
  Config is conveyed by RoCC custom instructions carrying 16 bytes each; a
  load-store host needs ~2 register loads + 1 custom instruction per write, at
  ~3 cycles/instruction [17] ⇒ BW_config = 16/9 ≈ 1.77 B/cycle (§4.6).
* **OpenGeMM** [47] — 8×8×8 GeMM datapath (1024 ops/cycle) behind a tiny
  in-order Snitch core. *Concurrent* configuration: CSR writes can stage the
  next invocation while the accelerator runs (§6.2).

We reproduce those two points in the design space as parameterized
:class:`AcceleratorModel` instances. The models are deliberately simple —
everything the paper's roofline needs: a peak rate, a configuration-write cost,
a host CPI for parameter calculation (effective bandwidth, Eq. 4), and the
sequential/concurrent distinction.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class AcceleratorModel:
    name: str
    p_peak: float  # macro-op datapath throughput, ops/cycle
    concurrent: bool  # supports concurrent (staged) configuration?
    host_cpi: float  # host cycles per instruction (param calculation, Eq. 4)
    bytes_per_field: int  # config bytes conveyed per setup field
    fields_per_write: int  # fields per config-write instruction (RoCC: 2)
    instrs_per_write: int  # host instructions per config write
    launch_instrs: int = 1  # host instructions to issue the launch itself
    launch_latency: float = 0.0  # fixed pipeline-fill cycles per macro-op
    # register names used to derive the macro-op size: ops = 2 * M * K * N
    dim_fields: tuple[str, str, str] = ("M", "K", "N")
    # datapath tile (M, K, N): one grid step of the calibrated compute model
    # covers one tile, so ⌈M/tm⌉·⌈K/tk⌉·⌈N/tn⌉ issue cycles price the loop
    # control the flat macro_cycles model ignores (engine.costmodel)
    tile: tuple[int, int, int] = (8, 8, 8)

    # -- derived quantities (the roofline inputs) ---------------------------

    @property
    def config_write_cycles(self) -> float:
        """Host cycles to convey one setup field to the accelerator."""
        return self.instrs_per_write * self.host_cpi / self.fields_per_write

    @property
    def bw_config(self) -> float:
        """Theoretical configuration bandwidth, bytes/cycle (§4.2)."""
        return self.bytes_per_field / self.config_write_cycles

    def macro_ops(self, regs: dict[str, int]) -> int:
        m, k, n = (int(regs.get(f, 0)) for f in self.dim_fields)
        return 2 * m * k * n

    def macro_cycles(self, regs: dict[str, int]) -> float:
        return self.launch_latency + self.macro_ops(regs) / self.p_peak


def gemmini_like() -> AcceleratorModel:
    """Sequential-configuration point: Gemmini's weight-stationary flow.

    16×16 PEs × (mul+acc) = 512 ops/cycle; Rocket host at ~3 cycles/instr;
    RoCC writes convey two 8-byte fields in 3 instructions ⇒ 16 B / 9 cycles
    ≈ 1.77 B/cycle, exactly the paper's §4.6 estimate.
    """
    return AcceleratorModel(
        name="gemmini",
        p_peak=512.0,
        concurrent=False,
        host_cpi=3.0,
        bytes_per_field=8,
        fields_per_write=2,
        instrs_per_write=3,
        launch_instrs=1,
        launch_latency=16.0,  # systolic fill
        dim_fields=("I", "K", "J"),
        tile=(16, 16, 16),
    )


def opengemm_like() -> AcceleratorModel:
    """Concurrent-configuration point: OpenGeMM.

    8×8×8 MACs × 2 = 1024 ops/cycle; single-issue Snitch host (CPI ≈ 1);
    one 4-byte CSR per field at ~2 instructions (addi+csrw) per write.
    """
    return AcceleratorModel(
        name="opengemm",
        p_peak=1024.0,
        concurrent=True,
        host_cpi=1.0,
        bytes_per_field=4,
        fields_per_write=1,
        instrs_per_write=2,
        launch_instrs=1,
        launch_latency=8.0,
        dim_fields=("M", "K", "N"),
    )


REGISTRY: dict[str, AcceleratorModel] = {}


def register(model: AcceleratorModel) -> AcceleratorModel:
    REGISTRY[model.name] = model
    return model


register(gemmini_like())
register(opengemm_like())
