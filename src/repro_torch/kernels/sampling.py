"""Greedy sampling and top-k: the decode launch's fused epilogue.

:func:`greedy_sample` is the port of the Pallas kernel
``repro/kernels/sampling.py::greedy_sample``: argmax over the last axis of
``(B, V)`` logits → ``(B,)`` int32 ids, the lowest index winning ties and
the first NaN winning over every number (``jnp.argmax``'s contract). On a
CUDA tensor it launches the hand-written Hopper kernel
``csrc/greedy_sample.cu``, each row split across a thread-block cluster of
``plan_greedy_sample(...).cluster`` blocks (up to 16, past the portable 8
only where the card holds every row's cluster at once); on a CPU tensor it runs the
plain version ``ref.greedy_sample_ref``. There is no other route: a CUDA
tensor either runs the kernel or raises, also where the card cannot place
the cluster.

:func:`top_k` is the port of ``repro/kernels/sampling.py::top_k``: the k
best of each row in ``lax.top_k`` order (descending, NaN first, ties by the
lowest index), in one launch of ``csrc/top_k.cu`` where the Pallas version
takes k greedy passes. The launch splits each row across
``plan_top_k(...).splits`` blocks and merges their candidates in the block
of the row that finishes last. Its plain version is ``ref.top_k_ref``, a
stable descending sort. ``k`` is at most :data:`K_MAX`, the kernels'
compile-time bound on their candidate lists.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from . import _build
from .ref import greedy_sample_ref, top_k_ref

K_MAX = 64  # top_k.cu's kKMax: the most its candidate lists and scratch hold
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


@functools.cache
def _launcher():
    fn = _build.load("greedy_sample").greedy_sample_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


GREEDY_CLUSTERS = (1, 2, 4, 8, 16)  # what the kernel launches; 16 needs the non-portable opt-in
GREEDY_PORTABLE_CLUSTER = 8
GREEDY_MIN_CHUNK = 8192  # elements: a block's chunk is at least this, so short rows stay whole
GREEDY_ALIGN = 8  # elements: a chunk of a 16-byte aligned row starts 16-byte aligned
H100_WIDE_CLUSTERS = 7  # clusters of 16 of the kernel an H100 SXM holds at once


@dataclass(frozen=True)
class GreedyPlan:
    cluster: int  # blocks per row, one thread-block cluster
    chunk: int  # elements of the row per block; the last block takes the rest

    def bounds(self, v: int) -> list[tuple[int, int]]:
        """Each block's ``[start, stop)`` of a row of ``v`` elements."""
        return [(min(v, r * self.chunk), min(v, (r + 1) * self.chunk))
                for r in range(self.cluster)]


def plan_greedy_sample(b: int, v: int, sms: int = _build.H100_SMS,
                       wide: int = H100_WIDE_CLUSTERS) -> GreedyPlan:
    """How ``greedy_sample`` splits each of ``b`` rows of ``v`` logits
    across one cluster of blocks, on a card of ``sms`` SMs that holds
    ``wide`` clusters of 16 at once. A pure function, so the rule is tested
    on the CPU. The cluster doubles from 1 while the grid stays within one
    block per SM and every chunk at least ``GREEDY_MIN_CHUNK`` elements;
    past the portable 8 only while all ``b`` clusters of 16 fit at once.
    The chunk is a multiple of ``GREEDY_ALIGN``, and every chunk is
    non-empty."""
    cluster = 1
    while (2 * cluster <= max(GREEDY_CLUSTERS) and 2 * cluster * b <= sms
           and v >= 2 * cluster * GREEDY_MIN_CHUNK
           and (2 * cluster <= GREEDY_PORTABLE_CLUSTER or b <= wide)):
        cluster *= 2
    chunk = -(-v // cluster)
    return GreedyPlan(cluster, -(-chunk // GREEDY_ALIGN) * GREEDY_ALIGN)


def _check_plan(plan: GreedyPlan, v: int) -> None:
    if (plan.cluster not in GREEDY_CLUSTERS or plan.chunk <= 0 or plan.chunk % GREEDY_ALIGN
            or not (plan.cluster - 1) * plan.chunk < v <= plan.cluster * plan.chunk):
        raise ValueError(f"greedy_sample cannot launch {plan} on rows of {v}: the cluster is one "
                         f"of {GREEDY_CLUSTERS} and its non-empty chunks, multiples of "
                         f"{GREEDY_ALIGN}, cover the row")


@functools.cache
def max_active_clusters(cluster: int, dtype: torch.dtype = torch.bfloat16,
                        index: int = 0) -> int:
    """How many clusters of ``cluster`` blocks of the greedy kernel CUDA
    device ``index`` holds at once; 0 if it cannot place one."""
    if cluster not in GREEDY_CLUSTERS or dtype not in _DTYPE_CODES:
        raise ValueError(f"no greedy kernel for a cluster of {cluster} and {dtype}")
    count = ctypes.c_int(0)
    fn = _build.load("greedy_sample").greedy_sample_max_active_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(index):
        _build.check(fn(cluster, _DTYPE_CODES[dtype], ctypes.byref(count)),
                     "greedy_sample occupancy")
    return count.value


def _check_logits(name: str, logits: torch.Tensor) -> None:
    if logits.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} takes float32, bfloat16 or float16 "
                        f"logits, not {logits.dtype}")
    if logits.dim() != 2:
        raise ValueError(f"{name} takes (B, V) logits, not shape "
                         f"{tuple(logits.shape)}")
    if not logits.is_contiguous():
        raise ValueError(f"{name} takes contiguous logits")
    if not 0 < logits.shape[1] < 2**31:
        raise ValueError(f"{name} needs 0 < V < 2**31, got V={logits.shape[1]}")


def greedy_sample(logits: torch.Tensor, plan: GreedyPlan | None = None) -> torch.Tensor:
    """Argmax over the last axis of contiguous ``(B, V)`` float32, bfloat16
    or float16 logits → ``(B,)`` int32 ids, each row split as ``plan`` says
    (default :func:`plan_greedy_sample`'s; another is for probes).
    ``greedy_sample.launches`` counts the kernel's launches and
    ``greedy_sample.launches_by_cluster`` the launches at each cluster
    size."""
    _check_logits("greedy_sample", logits)
    b, v = logits.shape
    if plan is not None:
        _check_plan(plan, v)
    if logits.device.type == "cpu":
        return greedy_sample_ref(logits)
    if logits.device.type != "cuda":
        raise ValueError(f"greedy_sample runs on cuda or cpu, not {logits.device}")
    if logits.get_device() != torch.cuda.current_device():
        # the runtime launches on the current device's streams only
        with torch.cuda.device(logits.device):
            return greedy_sample(logits, plan)
    out = torch.empty((b,), dtype=torch.int32, device=logits.device)
    if b == 0:
        return out
    if plan is None:
        index = logits.get_device()
        plan = plan_greedy_sample(b, v, _build.sm_count(index),
                                  max_active_clusters(max(GREEDY_CLUSTERS), logits.dtype, index))
    err = _launcher()(logits.data_ptr(), out.data_ptr(), b, v, _DTYPE_CODES[logits.dtype],
                      plan.cluster, plan.chunk,
                      torch.cuda.current_stream(logits.device).cuda_stream)
    _build.check(err, f"greedy_sample (cluster of {plan.cluster})")
    greedy_sample.launches += 1
    greedy_sample.launches_by_cluster[plan.cluster] += 1
    return out


greedy_sample.launches = 0
greedy_sample.launches_by_cluster = dict.fromkeys(GREEDY_CLUSTERS, 0)


@functools.cache
def _top_k_launcher():
    lib = _build.load("top_k")
    if lib.top_k_max_k() != K_MAX:
        raise RuntimeError(f"top_k.cu's kKMax is {lib.top_k_max_k()}, not K_MAX={K_MAX}")
    fn = lib.top_k_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


TOP_K_BLOCKS_PER_SM = 2
TOP_K_MAX_SPLITS = 256  # the merging block's threads: each takes one block's list
TOP_K_MIN_CHUNK = 1024  # elements, and at least 32·k: a block's k candidates stay small beside it
TOP_K_ALIGN = 8  # elements: a chunk of a 16-byte aligned row starts 16-byte aligned
TOP_K_REGISTER_K = 8  # top_k.cu's kRegisterKMax: larger k take its radix-select kernel
TOP_K_PIECE = 4096  # top_k.cu's kPiece: the radix-select kernel's keys in shared memory


@dataclass(frozen=True)
class TopKPlan:
    splits: int  # blocks per row
    chunk: int  # elements of the row per block; the last block takes the rest

    def bounds(self, v: int) -> list[tuple[int, int]]:
        """Each block's ``[start, stop)`` of a row of ``v`` elements."""
        return [(s * self.chunk, min(v, (s + 1) * self.chunk)) for s in range(self.splits)]


def plan_top_k(b: int, v: int, k: int, sms: int = _build.H100_SMS) -> TopKPlan:
    """How ``top_k`` splits each of ``b`` rows of ``v`` logits across blocks,
    on a card of ``sms`` SMs. A pure function, so the rule is tested on the
    CPU. About ``TOP_K_BLOCKS_PER_SM`` blocks per SM over the grid, at
    most ``TOP_K_MAX_SPLITS`` per row, each chunk at least
    ``max(TOP_K_MIN_CHUNK, 32·k)`` elements and a multiple of
    ``TOP_K_ALIGN``; every chunk is non-empty. A short row or a large ``b``
    gives one block per row when ``k <= TOP_K_REGISTER_K``. A larger k
    takes the radix-select kernel, whose block selects from
    ``TOP_K_PIECE`` elements at a time: there chunks are also cut to one
    piece where ``TOP_K_MAX_SPLITS`` allows, so the pieces of a row run in
    parallel rather than one after another."""
    min_chunk = max(TOP_K_MIN_CHUNK, 32 * k)
    splits = max(1, min(TOP_K_BLOCKS_PER_SM * sms // max(b, 1), v // min_chunk))
    if k > TOP_K_REGISTER_K:
        splits = max(splits, -(-v // TOP_K_PIECE))
    splits = min(splits, TOP_K_MAX_SPLITS)
    chunk = -(-v // splits)
    chunk = -(-chunk // TOP_K_ALIGN) * TOP_K_ALIGN
    return TopKPlan(-(-v // chunk), chunk)


def top_k(logits: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` best of each row of contiguous ``(B, V)`` float32, bfloat16
    or float16 logits → ``((B, k)`` float32 values, ``(B, k)`` int32 ids),
    in ``lax.top_k`` order, for ``1 <= k <= min(V, K_MAX)``, split across
    blocks as :func:`plan_top_k` says. ``top_k.launches`` counts the
    kernel's launches."""
    _check_logits("top_k", logits)
    b, v = logits.shape
    if isinstance(k, bool) or not isinstance(k, int) or not 1 <= k <= min(v, K_MAX):
        raise ValueError(f"top_k takes an int 1 <= k <= min(V={v}, K_MAX={K_MAX}), not {k!r}")
    if logits.device.type == "cpu":
        return top_k_ref(logits, k)
    if logits.device.type != "cuda":
        raise ValueError(f"top_k runs on cuda or cpu, not {logits.device}")
    if logits.get_device() != torch.cuda.current_device():
        with torch.cuda.device(logits.device):
            return top_k(logits, k)
    vals = torch.empty((b, k), dtype=torch.float32, device=logits.device)
    ids = torch.empty((b, k), dtype=torch.int32, device=logits.device)
    if b == 0:
        return vals, ids
    plan = plan_top_k(b, v, k, _build.sm_count(logits.get_device()))
    scratch = (0, 0)
    if plan.splits > 1:  # the blocks' candidates as 64-bit keys, and each row's blocks done
        parts = torch.empty((b, plan.splits, k), dtype=torch.int64, device=logits.device)
        arrived = torch.zeros((b,), dtype=torch.int32, device=logits.device)
        scratch = (parts.data_ptr(), arrived.data_ptr())
    _build.check(_top_k_launcher()(logits.data_ptr(), vals.data_ptr(), ids.data_ptr(), *scratch,
                                   b, v, k, plan.splits, plan.chunk, _DTYPE_CODES[logits.dtype],
                                   torch.cuda.current_stream(logits.device).cuda_stream),
                 "top_k")
    top_k.launches += 1
    return vals, ids


top_k.launches = 0
