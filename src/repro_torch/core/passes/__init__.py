"""Optimization passes over accfg IR — the paper's §5.2 pipeline.

The port's own copy of ``repro/core/passes/__init__.py``: the code is the
reference's, unchanged.

Pipelines:

* :func:`baseline` — what a C compiler can do around ``volatile`` inline
  assembly (§3.1): constant folding and per-iteration CSE of the pure arith,
  but *no* transformation may touch, reorder, or eliminate the (volatile)
  setup sequences, and packing chains feeding them cannot be hoisted.
* :func:`optimize` — the accfg pipeline (Figure 8, steps 2–4): state tracing,
  branch hoisting + loop-invariant setup hoisting + configuration
  deduplication, then configuration–computation overlap for concurrent
  targets, with canonicalization (CSE / LICM / const-fold / DCE) in between —
  all legal now because setups declare their effects (§5.2).
"""

from __future__ import annotations

from ..ir import Module
from .canonicalize import canonicalize, constant_fold_and_cse
from .dedup import dedup, hoist_setups_into_branches
from .licm import hoist_invariant_setup_fields
from .overlap import overlap
from .state_tracing import trace_states

__all__ = [
    "baseline",
    "optimize",
    "trace_states",
    "canonicalize",
    "dedup",
    "hoist_setups_into_branches",
    "hoist_invariant_setup_fields",
    "overlap",
]


def baseline(module: Module) -> Module:
    """GCC-around-volatile-asm model: fold + CSE only (no cross-loop motion of
    the operand chains feeding volatile setups, no setup rewrites)."""
    constant_fold_and_cse(module)
    return module


def optimize(
    module: Module,
    concurrent_accels: set[str] | frozenset[str] = frozenset(),
    do_dedup: bool = True,
    do_overlap: bool = True,
) -> Module:
    trace_states(module)  # step 2: connect setup clusters
    canonicalize(module)
    if do_dedup:  # step 3: redundant setup elimination
        hoist_setups_into_branches(module)
        hoist_invariant_setup_fields(module)
        dedup(module)
        canonicalize(module)
    if do_overlap and concurrent_accels:  # step 4: configuration overlap
        overlap(module, set(concurrent_accels))
        canonicalize(module)
    return module
