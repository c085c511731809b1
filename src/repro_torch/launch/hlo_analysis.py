"""Roofline terms of a dry-run cell, on the H100's constants.

The counterpart of ``repro/launch/hlo_analysis.py``. The reference reads
FLOPs and "bytes accessed" from ``compiled.cost_analysis()`` and parses
the collectives out of the post-SPMD HLO text; the port has no compiled
program to read, so ``launch.dryrun`` counts what the sharded step
dispatches (each device's local ops and each collective the DTensor
redistributions and the MoE all-to-all issue) and gives the totals to
:class:`RooflineTerms`. What is kept, copied: ``_wire_bytes`` (per-device
bytes on the wire under ring algorithms), :class:`CollectiveStats` and
:class:`RooflineTerms`' terms and properties. What has no torch twin and
is left out: the HLO text parser (``collective_bytes``,
``collective_bytes_weighted``, its regular expressions and loop
trip-count weighting: the port's layers run as a Python loop, so every
collective is seen once per execution) and "bytes accessed": the memory
term reads ``hlo_bytes`` as the bytes every device's arguments hold, read
once (a lower bound where the reference's counts every operand and
result of the compiled program).

Hardware constants, NVIDIA H100 SXM5 (data sheet), per GPU:
989.4 TFLOP/s dense bf16 tensor-core, 3.35 TB/s HBM3; NVLink 4 at
900 GB/s both directions together, 450 GB/s each way, within a node of 8
GPUs; between nodes one ConnectX-7 NDR InfiniBand port a GPU, 400 Gb/s =
50 GB/s each way (DGX H100). A ring over a mesh axis of at most 8 devices
stays on NVLink; a wider one (every axis of the production meshes: 16,
and the 2-pod axis) crosses nodes and runs at the InfiniBand rate.
"""

from __future__ import annotations

from dataclasses import dataclass, field

PEAK_FLOPS = 989.4e12  # bf16 dense, per GPU
HBM_BW = 3.35e12  # bytes/s per GPU
NVLINK_BW = 450e9  # bytes/s per GPU, each way, within a node of 8
IB_BW = 400e9 / 8  # bytes/s per GPU, each way: one NDR 400 Gb/s port
NODE_GPUS = 8


def link_bw(group_size: int) -> float:
    """Bytes/s a device's ring over ``group_size`` devices runs at: NVLink
    within a node, InfiniBand across nodes (ranks of one group laid out
    consecutively or strided, a group wider than a node spans nodes)."""
    return NVLINK_BW if group_size <= NODE_GPUS else IB_BW


def _wire_bytes(kind: str, result_bytes: int, s: int) -> float:
    """Per-device bytes on the interconnect under ring algorithms."""
    if kind == "collective-permute":  # point-to-point: no replica groups
        return float(result_bytes)
    if s <= 1:
        return 0.0
    frac = (s - 1) / s
    if kind == "all-reduce":
        return 2.0 * result_bytes * frac  # reduce-scatter + all-gather phases
    if kind == "all-gather":
        return result_bytes * frac  # result is the gathered (full) buffer
    if kind == "reduce-scatter":
        return result_bytes * (s - 1)  # operand = result × S; wire ≈ operand·frac
    if kind == "all-to-all":
        return result_bytes * frac
    return float(result_bytes)  # collective-permute


@dataclass
class CollectiveStats:
    bytes_by_kind: dict[str, int] = field(default_factory=dict)
    count_by_kind: dict[str, int] = field(default_factory=dict)
    seconds: float = 0.0  # each collective's wire bytes over its group's link

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def add(self, kind: str, result_bytes: int, group_size: int) -> None:
        wire = int(_wire_bytes(kind, result_bytes, group_size))
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + wire
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1
        self.seconds += wire / link_bw(group_size)


@dataclass
class RooflineTerms:
    """The three dry-run roofline terms, in seconds, plus provenance."""

    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float  # GLOBAL flops (per-device × chips)
    hlo_bytes: float  # GLOBAL bytes: every device's arguments, read once
    coll_bytes: float  # per-device collective bytes on the wire
    model_flops: float  # 6·N·D (or 6·N_active·D)
    per_device_bytes: float  # a device's arguments (params, optimizer state, inputs, cache)
    collectives: dict[str, int] = field(default_factory=dict)
    coll_s: float | None = None  # Σ wire bytes / link rate; None: coll_bytes at IB_BW

    @property
    def compute_s(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def collective_s(self) -> float:
        # per-device wire bytes over the links each collective's group crosses
        return self.coll_bytes / IB_BW if self.coll_s is None else self.coll_s

    @property
    def dominant(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step-time estimate: overlapped comms ⇒ max of terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """MODEL_FLOPS-based MFU bound implied by the three terms."""
        ideal = self.model_flops / (self.chips * PEAK_FLOPS)
        return ideal / self.step_time_s if self.step_time_s else 0.0

    def to_dict(self) -> dict:
        return {
            "arch": self.arch,
            "shape": self.shape,
            "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops,
            "hlo_bytes": self.hlo_bytes,
            "coll_bytes": self.coll_bytes,
            "model_flops": self.model_flops,
            "per_device_bytes": self.per_device_bytes,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "step_time_s": self.step_time_s,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "collectives": self.collectives,
        }
