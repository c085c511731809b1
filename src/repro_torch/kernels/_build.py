"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface, ``build/lib<name>.so`` beside this file (the directory is
git-ignored), and loaded with ``ctypes``; pointers and the stream cross as
``c_void_p``. A process builds each source once. Building without
PyTorch's headers takes seconds, where ``torch.utils.cpp_extension`` takes
minutes.

There is no fallback: a missing ``nvcc`` or a failed build raises, and so
does a launch whose C entry point returns a CUDA error (:func:`check`).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Build:
    name: str
    path: Path
    seconds: float  # wall time of the nvcc run
    log: str  # nvcc's output: the -Xptxas -v register and shared-memory report


_builds: dict[str, Build] = {}
_libs: dict[str, ctypes.CDLL] = {}


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` unless this process already has."""
    if name in _builds:
        return _builds[name]
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found on PATH: the CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"lib{name}.so"
    # written aside and renamed, so a process that loads the library while
    # another builds it never maps a half-written file
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, target)
    _builds[name] = Build(name, target, seconds, proc.stdout)
    return _builds[name]


def build_all(names: list[str]) -> list[Build]:
    """Build the named kernels, one ``nvcc`` per source, all started
    together; raises if any build fails."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        futures = [pool.submit(build, name) for name in names]
        return [f.result() for f in futures]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build(name).path))
    return _libs[name]


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error: a refused launch never
    runs, and no later synchronisation would report it."""
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")
