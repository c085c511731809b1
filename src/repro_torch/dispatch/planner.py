"""Step-descriptor planner — the paper's configuration deduplication at the
dispatch layer.

The counterpart of ``repro/dispatch/planner.py``, copied with numpy alone.
Every device launch is configured by a *descriptor*: the host-produced
scalars and small arrays that parameterize the step (batch offsets, KV-cache
slots, RNG seeds, MoE capacity, temperature, ...). The planner traces
descriptors across steps and splits fields into:

* **static** — provably identical on every step: hoisted out of the
  per-launch traffic (kept in device-resident buffers, or captured once in
  a CUDA graph). These are the "redundant setup writes" of §5.4.
* **dynamic** — actually changing: the only bytes that must cross the
  host→device boundary per launch.

The observed ``I_OC`` (accelerator ops per configuration byte, §4.2) rises by
``total_bytes / dynamic_bytes`` — the dispatch-layer analogue of Figure 12's
rightward movement.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass(frozen=True)
class StepDescriptor:
    """One launch's configuration: a flat dict of scalars / small arrays."""

    fields: dict

    def nbytes(self, names=None) -> int:
        names = self.fields.keys() if names is None else names
        total = 0
        for n in names:
            v = self.fields[n]
            total += np.asarray(v).nbytes
        return total


@dataclass
class ConfigPlan:
    static: dict = field(default_factory=dict)
    dynamic: list = field(default_factory=list)
    total_fields: int = 0

    @classmethod
    def trace(cls, descriptors: list[StepDescriptor]) -> "ConfigPlan":
        """SSA-style equivalence across launches: a field is static iff its
        value is bit-identical in every traced descriptor (cf. §5.4's
        SSA-value equivalence proxy)."""
        assert descriptors, "need at least one traced descriptor"
        first = descriptors[0].fields
        static, dynamic = {}, []
        for name, value in first.items():
            v0 = np.asarray(value)
            same = all(
                np.array_equal(v0, np.asarray(d.fields[name])) for d in descriptors[1:]
            )
            if same:
                static[name] = value
            else:
                dynamic.append(name)
        plan = cls(static=static, dynamic=dynamic, total_fields=len(first))
        return plan

    def dynamic_descriptor(self, desc: StepDescriptor) -> dict:
        return {n: desc.fields[n] for n in self.dynamic}

    # -- roofline accounting -------------------------------------------------

    def bytes_baseline(self, desc: StepDescriptor) -> int:
        return desc.nbytes()

    def bytes_deduped(self, desc: StepDescriptor) -> int:
        return desc.nbytes(self.dynamic)

    def i_oc_gain(self, desc: StepDescriptor) -> float:
        dyn = self.bytes_deduped(desc)
        return self.bytes_baseline(desc) / dyn if dyn else float("inf")
