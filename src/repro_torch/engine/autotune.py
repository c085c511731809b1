"""Overlap autotuner — pick engine knobs from the predicted wire/compute ratio.

The port's own copy of ``repro/engine/autotune.py``: the code is the
reference's, unchanged.

The overlap engine has two knobs a caller previously hand-picked per
deployment: ``overlap`` (serialized vs double-buffered async staging) and
``staging_buffers`` (configuration banks). Both are pure functions of one
quantity the calibrated compute model (``engine.costmodel``) can now
predict instead of guess: the **wire/compute ratio** — cycles a launch's
config transfer occupies the wire over cycles its macro-op occupies the
datapath.

Decision table (:func:`tune`):

====================================  ============  ====================
predicted regime                      overlap       staging_buffers
====================================  ============  ====================
nothing can hide (sequential device,  serialized    2 (idle default)
zero wire time, or a captive
transport — plain MMIO)
wire ≤ compute (config-bound side     overlapped    2 — the shadow bank
of the launch roofline's ridge,                     fully hides transfer
compute long enough to hide behind)                 k+1 behind compute k
wire > compute (transfer outlives     overlapped    1 + ⌈wire/compute⌉,
each macro-op: banks must cover the                 capped at ``max_buffers``
backlog for the wire to stream
gap-free)
====================================  ============  ====================

In steady state a transfer may start only after launch ``k − buffers``
retires, so hiding a transfer of ``w`` cycles behind computes of ``c``
cycles needs ``(buffers − 1) · c ≥ w``, i.e. ``buffers ≥ 1 + w/c`` — the
table's third row; with ``w ≤ c`` two banks suffice, the classic double
buffer. More banks than needed never hurt makespan (staging-buffer
monotonicity, pinned in ``tests/test_engine.py``), so the autotuned pick
matches or beats the hand-picked default by construction; it *wins*
whenever the default left overlap off on a link that could hide.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..core.accelerators import AcceleratorModel
from .costmodel import ComputeModel, resolve_compute_model
from .overlap import ASYNC_XFER_MODES

DEFAULT_BUFFERS = 2
MAX_BUFFERS = 8


@dataclass(frozen=True)
class TunedKnobs:
    """One (device, link, workload) point's autotuned engine knobs."""

    overlap: str  # "serialized" | "overlapped"
    staging_buffers: int
    transport: str  # the transport spec to run with (usually "auto")
    xfer_mode: str  # discipline the transport layer picked at this point
    wire_cycles: float  # predicted config transfer time per launch
    compute_cycles: float  # predicted macro-op time per launch
    reason: str  # which decision-table row fired

    @property
    def ratio(self) -> float:
        """Predicted wire/compute ratio — the decision axis."""
        if self.compute_cycles <= 0.0:
            return math.inf if self.wire_cycles > 0.0 else 0.0
        return self.wire_cycles / self.compute_cycles

    def scheduler_kwargs(self) -> dict:
        """Keyword arguments for ``Scheduler``/``Cluster.uniform``."""
        return {"overlap": self.overlap,
                "staging_buffers": self.staging_buffers,
                "transport": self.transport}


def tune_from_ratio(wire_cycles: float, compute_cycles: float, *,
                    can_hide: bool, transport: str = "auto",
                    xfer_mode: str = "mmio",
                    max_buffers: int = MAX_BUFFERS) -> TunedKnobs:
    """Decision table over an already-known (wire, compute) pair —
    :func:`tune` predicts the pair, monitors can feed observed ones."""
    if not can_hide or wire_cycles <= 0.0:
        reason = ("no wire time to hide" if wire_cycles <= 0.0
                  else "transfer cannot stream behind compute")
        return TunedKnobs(overlap="serialized",
                          staging_buffers=DEFAULT_BUFFERS,
                          transport=transport, xfer_mode=xfer_mode,
                          wire_cycles=wire_cycles,
                          compute_cycles=compute_cycles, reason=reason)
    if compute_cycles <= 0.0 or wire_cycles <= compute_cycles:
        reason = "wire fits behind one macro-op: double buffer"
        buffers = DEFAULT_BUFFERS
    else:
        reason = "wire outlives each macro-op: deepen the staging ring"
        buffers = min(1 + math.ceil(wire_cycles / compute_cycles),
                      max_buffers)
    return TunedKnobs(overlap="overlapped", staging_buffers=buffers,
                      transport=transport, xfer_mode=xfer_mode,
                      wire_cycles=wire_cycles, compute_cycles=compute_cycles,
                      reason=reason)


def tune(model: AcceleratorModel, link, dims,
         n_fields: int, *, kernel: str = "matmul",
         compute_model: "ComputeModel | str | None" = None,
         transport: str = "auto", objective: str = "cycles",
         max_buffers: int = MAX_BUFFERS) -> TunedKnobs:
    """Autotune the overlap knobs for launches of ``kernel`` at ``dims``
    (logical M, K, N) writing ``n_fields`` registers per launch over
    ``link``.

    Wire cycles come from the transport layer's own plan (the discipline
    ``transport``/``objective`` would pick at dispatch); compute cycles
    from ``compute_model`` (a :class:`~repro.engine.costmodel.ComputeModel`,
    a mode string, or ``None`` for the flat constant). A transfer can only
    stream behind compute on a concurrent-configuration device via an
    async-capable discipline (:data:`~repro.engine.overlap.ASYNC_XFER_MODES`)
    — otherwise the table's serialized row fires."""
    # deferred: fabric.link's LinkPort builds on engine.resources, so a
    # module-level import here would make repro.engine ↔ repro.fabric
    # circular
    from ..fabric.link import resolve_link
    from ..fabric.transport import plan_fields

    link = resolve_link(link)
    cm = resolve_compute_model(compute_model) or ComputeModel.flat()
    xfer = plan_fields(n_fields, model, link, mode=transport,
                       objective=objective)
    compute = cm.predict(kernel, dims, model)
    can_hide = (model.concurrent and xfer.mode in ASYNC_XFER_MODES
                and xfer.link_cycles > 0.0)
    return tune_from_ratio(xfer.link_cycles, compute, can_hide=can_hide,
                           transport=transport, xfer_mode=xfer.mode,
                           max_buffers=max_buffers)
