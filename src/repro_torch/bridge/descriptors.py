"""Launch-descriptor → register-field translation.

The counterpart of ``repro/bridge/descriptors.py``, with the same functions
and the same field names, digests and byte counts.

The serving engine's launch descriptor is a dict of numpy leaves —
``{positions, live_mask}`` plus token overrides or tokens and invariant
sampling/shape scalars (``serving.engine``). The cluster scheduler speaks
register files: flat ``{field name: int}`` maps whose per-field bytes are
the accelerator model's ``bytes_per_field`` and whose redundancy a
per-device :class:`~repro_torch.sched.state_cache.ConfigStateCache` elides.

This module is the adapter between the two vocabularies, built so the two
caches — the engine executor's leaf-granular descriptor cache and the
cluster device's field-granular register cache — make **identical elision
decisions** on the same stream:

* each leaf becomes ``ceil(nbytes / bytes_per_field)`` register fields
  (``"['tokens']#0"``, ``"['tokens']#1"``, ...), so the device-side byte
  accounting prices the leaf at its true wire size (exactly, whenever the
  leaf's size divides the field width — e.g. int32 leaves on a 4-byte-field
  device);
* every field of a leaf carries the **same value**: a digest of the leaf's
  raw bytes. A leaf therefore changes *atomically* — all of its fields
  re-send together or elide together, mirroring the executor cache's
  whole-leaf comparison (`ScheduledExecutor` elides a leaf only when it is
  bit-identical to the previous launch's).

The digest is CRC-32 over the leaf's contiguous bytes — deterministic
across runs and platforms. A collision would under-count one leaf's resend
in the *cost model* (the real launch always carries the full descriptor),
which is an acceptable 2^-32 accounting hazard, not a correctness one.

Leaves come from the executor's own
:func:`~repro_torch.dispatch.executor.flatten_with_path`, which orders and
spells them as ``jax.tree_util`` does (dict keys sorted,
``"['positions']"``), so a bridged launch's register names line up with
the executor cache's keys and with the JAX bridge's — one vocabulary end
to end. A leaf must be on the host: digesting a CUDA tensor would
synchronise the launch stream the bridge only observes, so it raises.
"""

from __future__ import annotations

import zlib

import numpy as np
import torch

from ..core.accelerators import AcceleratorModel
from ..dispatch.executor import flatten_with_path
from ..sched.scheduler import LaunchRequest


def leaf_digest(value) -> int:
    """CRC-32 of a descriptor leaf's raw bytes (bit-exact comparison by
    proxy: equal leaves always digest equal)."""
    arr = np.ascontiguousarray(np.asarray(value))
    return zlib.crc32(arr.tobytes())


def _host_leaf(name: str, value) -> np.ndarray:
    if isinstance(value, torch.Tensor) and value.is_cuda:
        raise TypeError(
            f"descriptor leaf {name} is a CUDA tensor: the bridge digests host "
            f"leaves only, since reading a device leaf would synchronise the launch")
    return np.asarray(value)


def descriptor_leaves(desc) -> list[tuple[str, np.ndarray]]:
    """``(keystr, host array)`` pairs of a launch descriptor, in the same
    flatten order the engine executor's cache sees."""
    return [(name, _host_leaf(name, v)) for name, v in flatten_with_path(desc)]


def descriptor_nbytes(desc) -> int:
    """Wire bytes of the full descriptor (the engine cache's pricing)."""
    return sum(v.nbytes for _, v in descriptor_leaves(desc))


def padded_nbytes(desc, model: AcceleratorModel) -> int:
    """Wire bytes of the full descriptor as the cluster device prices it:
    each leaf rounded up to whole ``bytes_per_field`` registers. Equal to
    :func:`descriptor_nbytes` when every leaf divides the field width."""
    bpf = model.bytes_per_field
    return sum(-(-v.nbytes // bpf) * bpf for _, v in descriptor_leaves(desc))


def descriptor_fields(desc, model: AcceleratorModel) -> dict[str, int]:
    """Flatten a launch descriptor into the register-field map a cluster
    device caches: per-leaf word fields, all carrying the leaf's digest so
    the leaf elides or re-sends atomically."""
    bpf = model.bytes_per_field
    fields: dict[str, int] = {}
    for name, arr in descriptor_leaves(desc):
        digest = leaf_digest(arr)
        for word in range(max(1, -(-arr.nbytes // bpf))):
            fields[f"{name}#{word}"] = digest
    return fields


def descriptor_request(
    tenant: str,
    desc,
    model: AcceleratorModel,
    dims: tuple[int, int, int],
    *,
    arrival_time: float = 0.0,
    priority: int = 0,
    deadline: float | None = None,
    kernel: str = "matmul",
) -> LaunchRequest:
    """One engine launch as a cluster :class:`LaunchRequest`: the config
    payload is the *real* descriptor (as digest fields), ``dims`` sizes the
    decode macro-op (the tenant's per-step GEMM tile), ``accel`` pins the
    request to the device kind modelling the engine's accelerator, and
    ``kernel`` names the analytical cost-model shape class
    (``engine.costmodel``) — ``"decode"``/``"prefill"`` price GEMM-shaped
    launches, a calibrated scheduler ignores unknown names and falls back
    to the flat per-launch constant."""
    return LaunchRequest(
        tenant=tenant,
        dims=dims,
        extra=descriptor_fields(desc, model),
        accel=model.name,
        arrival_time=arrival_time,
        priority=priority,
        deadline=deadline,
        kernel=kernel,
    )
