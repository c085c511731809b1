"""Build the port's CUDA kernels with ``nvcc`` at first use and load them.

Each ``csrc/<name>.cu`` is compiled on its own into a shared library with a
plain C interface, ``build/lib<name>.so`` beside this file (the directory is
git-ignored), and loaded with ``ctypes``; pointers and the stream cross as
``c_void_p``. A process builds each source once. Building without
PyTorch's headers takes seconds, where ``torch.utils.cpp_extension`` takes
minutes.

:func:`build_in_background` starts a build in a thread of its own, so it
overlaps the caller's other set-up; a :func:`build` or :func:`load` of a
name that is building waits for that build rather than start another
``nvcc``. There is no fallback: a missing ``nvcc`` or a failed build raises,
a background one at the first build or load of its name after it failed,
and so does a launch whose C entry point returns a CUDA error
(:func:`check`).
:func:`sm_count` gives the card's SM count, by which the wrappers' plans
size their grids. :func:`builds` gives what this process built and loaded,
each ``nvcc`` run and ``ctypes`` load stamped by ``time.perf_counter_ns`` and
placed on ``torch.profiler``'s clock (Unix ns) as the serve driver's spans.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass
from functools import cache
from pathlib import Path

import torch

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "build"
H100_SMS = 132  # the plans' default card
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Build:
    name: str
    path: Path
    nvcc_ns: tuple[int, int]  # the nvcc run's start and end, on the profiler's clock
    log: str  # nvcc's output: the -Xptxas -v register and shared-memory report
    load_ns: tuple[int, int] | None = None  # the ctypes.CDLL load, once loaded

    @property
    def seconds(self) -> float:
        """Wall time of the nvcc run."""
        return (self.nvcc_ns[1] - self.nvcc_ns[0]) / 1e9


_builds: dict[str, Build] = {}
_libs: dict[str, ctypes.CDLL] = {}
_building: dict[str, Future] = {}  # each build under way, or failed in the background
_lock = threading.Lock()


def _offset_ns() -> int:
    """What places a ``time.perf_counter_ns`` stamp on the profiler's clock."""
    return time.time_ns() - time.perf_counter_ns()


def kernel_names() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build(name: str) -> Build:
    """Compile ``csrc/<name>.cu`` unless this process already has; where
    another thread is building it, wait for that build."""
    return _build(name, keep_failure=False)


def build_in_background(name: str) -> None:
    """Start building ``name`` in a thread of its own, unless it is built or
    building; its first :func:`build` or :func:`load` waits for it and
    raises if it failed."""
    with _lock:
        if name in _builds or name in _building:
            return
    threading.Thread(target=_build_quietly, args=(name,), name=f"build {name}",
                     daemon=True).start()


def _build_quietly(name: str) -> None:
    try:
        _build(name, keep_failure=True)
    except Exception:  # kept in _building: the name's next build or load raises it
        pass


def _build(name: str, keep_failure: bool) -> Build:
    with _lock:
        if name in _builds:
            return _builds[name]
        running = _building.get(name)
        mine = running is None
        if mine:
            running = _building[name] = Future()
    if not mine:
        try:
            return running.result()
        except BaseException:
            with _lock:  # a failure reaches its waiters once; the next build tries anew
                if _building.get(name) is running:
                    del _building[name]
            raise
    try:
        made = _nvcc(name)
    except BaseException as e:
        running.set_exception(e)
        if not keep_failure:
            with _lock:
                del _building[name]
        raise
    with _lock:
        _builds[name] = made
        del _building[name]
    running.set_result(made)
    return made


def _nvcc(name: str) -> Build:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        raise RuntimeError("nvcc not found on PATH: the CUDA kernels cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    target = BUILD_DIR / f"lib{name}.so"
    # written aside and renamed, so a process that loads the library while
    # another builds it never maps a half-written file
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    offset, t0 = _offset_ns(), time.perf_counter_ns()
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t1 = time.perf_counter_ns()
    if proc.returncode != 0:
        raise RuntimeError(f"kernel build failed: {name}: nvcc exited "
                           f"{proc.returncode}\n{proc.stdout}")
    os.replace(tmp, target)
    return Build(name, target, (t0 + offset, t1 + offset), proc.stdout)


def build_all(names: list[str]) -> list[Build]:
    """Build the named kernels, one ``nvcc`` per source, all started
    together; raises if any build fails."""
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        futures = [pool.submit(build, name) for name in names]
        return [f.result() for f in futures]


def builds() -> list[Build]:
    """Each kernel this process built, in build order: its ``nvcc`` run and,
    once loaded, its load. A process compiles each source it uses once and
    takes nothing from another process's build, so every kernel listed was
    compiled anew here."""
    return list(_builds.values())


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if need be."""
    if name not in _libs:
        path = build(name).path
        with _lock:
            if name not in _libs:
                offset, t0 = _offset_ns(), time.perf_counter_ns()
                _libs[name] = ctypes.CDLL(str(path))
                t1 = time.perf_counter_ns()
                _builds[name] = dataclasses.replace(_builds[name],
                                                    load_ns=(t0 + offset, t1 + offset))
    return _libs[name]


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point returned a CUDA error: a refused launch never
    runs, and no later synchronisation would report it."""
    if err:
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error {err}")


@cache
def sm_count(index: int) -> int:
    """The number of SMs of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count
