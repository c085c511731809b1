"""Production mesh construction.

The counterpart of ``repro/launch/mesh.py``. Functions, not module-level
constants: a ``DeviceMesh`` needs a process group of its size, which the
caller starts (``torch.distributed.init_process_group``; the dry run's
``fake`` backend, ``gloo`` on the CPU, ``nccl`` on cards).

Single pod: 256 devices as (data=16, model=16).
Multi-pod:  2 pods × 256 devices as (pod=2, data=16, model=16); the pod axis
is pure data parallelism across the cross-pod links.
"""

from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cuda"):
    """A one-device (data=1, model=1) mesh, over a process group of one rank."""
    return init_device_mesh(device_type, (1, 1), mesh_dim_names=("data", "model"))
