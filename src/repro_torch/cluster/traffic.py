"""Deterministic open-loop traffic generation for cluster serving runs.

The port's own copy of ``repro/cluster/traffic.py``: the code is the
reference's, unchanged.

Closed-loop benchmarks (``multi_tenant_sched``) replay a fixed batch
of launches and report makespan; production serving is *open-loop* — work
arrives on its own clock whether or not the pool is ready, and what matters
is the tail of the queueing delay, not the mean. This module synthesizes
such arrival streams:

* **Arrival processes** — ``poisson`` (memoryless, the M/G/k baseline),
  ``bursty`` (a two-state Markov-modulated Poisson process: quiet vs. burst
  episodes, same mean rate), and ``diurnal`` (sinusoidally-modulated rate
  via Lewis-Shedler thinning — the daily peak/trough of user traffic).
  All are driven by one ``random.Random(seed)``, so a given
  ``(profiles, process, rate, horizon, seed)`` tuple always produces the
  identical request list — runs are replayable and A/B router comparisons
  see byte-identical traffic.

* **Tenant-mix profiles** — each :class:`TenantProfile` names a tenant, its
  GEMM tile (derivable from the ``configs/`` model zoo via
  :meth:`TenantProfile.from_arch`: decode-step tiles of ``d_model``/``d_ff``),
  a traffic ``weight``, a ``priority`` class and an SLO target. Per-launch
  operand addresses cycle through ``n_bufs`` buffers, so a warm
  ``ConfigStateCache`` context elides the static dims/strides but still
  pays for the advancing pointers — the realistic partial-delta regime.

Times are in host cycles, the unit every layer below already speaks.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass
from typing import Callable, Iterable, Iterator

from ..configs import get as get_arch
from ..sched.scheduler import LaunchRequest


def _pow2_tile(x: int, lo: int = 8, hi: int = 64) -> int:
    """Largest power-of-two tile ≤ x, clamped to the accelerator-friendly
    [lo, hi] range (systolic arrays want multiples of the PE grid)."""
    if x <= lo:
        return lo
    return min(hi, 1 << int(math.log2(x)))


@dataclass(frozen=True)
class TenantProfile:
    """One tenant's contribution to the cluster mix."""

    tenant: str
    dims: tuple[int, int, int]  # per-launch GEMM tile (M, K, N)
    accel: str | None = None  # restrict to one device kind, None = any
    weight: float = 1.0  # share of arrivals
    priority: int = 0  # preemption class (sched.queue)
    slo_cycles: float | None = None  # per-launch latency target
    n_bufs: int = 4  # operand buffers the stream cycles through
    base_addr: int = 0x1000  # first operand address (kept distinct per tenant)

    @classmethod
    def from_arch(
        cls,
        tenant: str,
        arch: str,
        *,
        batch_tile: int = 16,
        **kwargs,
    ) -> "TenantProfile":
        """Derive a decode-step GEMM tile from a model-zoo architecture:
        M = decode batch tile, K = tile of ``d_model``, N = tile of
        ``d_ff`` — the dominant MLP GEMM of one decode launch."""
        cfg = get_arch(arch)
        dims = (
            _pow2_tile(batch_tile),
            _pow2_tile(cfg.d_model),
            _pow2_tile(cfg.d_ff),
        )
        return cls(tenant=tenant, dims=dims, **kwargs)

    def regs_extra(self, index: int) -> dict[str, int]:
        """Register fields beyond the dims for the ``index``-th launch:
        operand/result pointers advancing through the buffer ring."""
        slot = index % self.n_bufs
        stride = 64 * max(self.dims[0], 8)
        return {
            "A": self.base_addr + slot * stride,
            "B": self.base_addr + 0x100000 + slot * stride,
            "C": self.base_addr + 0x200000 + slot * stride,
            "zp": 0,
        }


# -- arrival processes ------------------------------------------------------
#
# Each generator yields strictly increasing arrival times in [0, horizon),
# consuming randomness only from the passed Random instance.


def poisson_arrivals(rate: float, horizon: float,
                     rng: random.Random) -> Iterator[float]:
    """Homogeneous Poisson process: i.i.d. exponential inter-arrivals."""
    assert rate > 0.0
    t = rng.expovariate(rate)
    while t < horizon:
        yield t
        t += rng.expovariate(rate)


def bursty_arrivals(rate: float, horizon: float, rng: random.Random, *,
                    burst_factor: float = 4.0,
                    burst_fraction: float = 0.1,
                    episode: float = 2_000.0) -> Iterator[float]:
    """Two-state MMPP with the same *mean* rate as ``poisson_arrivals``:
    the process alternates exponential episodes of quiet traffic and
    ``burst_factor``-times-hotter bursts (``burst_fraction`` of the time
    spent bursting). Mean-rate preservation needs the quiet state to carry
    the leftover rate, so ``burst_fraction * burst_factor < 1`` is required
    — an infeasible pair is rejected rather than silently re-rated."""
    assert rate > 0.0 and burst_factor > 1.0 and 0.0 < burst_fraction < 1.0
    assert burst_fraction * burst_factor < 1.0, (
        "burst state alone exceeds the requested mean rate")
    quiet_rate = rate * (1.0 - burst_fraction * burst_factor) / (1.0 - burst_fraction)
    burst_rate = rate * burst_factor
    t = 0.0
    bursting = False
    while t < horizon:
        mean_stay = episode * (burst_fraction if bursting else 1.0 - burst_fraction)
        t_switch = t + rng.expovariate(1.0 / mean_stay)
        lam = burst_rate if bursting else quiet_rate
        t += rng.expovariate(lam)
        while t < min(t_switch, horizon):
            yield t
            t += rng.expovariate(lam)
        t = min(t_switch, horizon)
        bursting = not bursting


def diurnal_arrivals(rate: float, horizon: float, rng: random.Random, *,
                     period: float | None = None,
                     depth: float = 0.8) -> Iterator[float]:
    """Sinusoidally-modulated Poisson process (Lewis-Shedler thinning):
    instantaneous rate ``rate * (1 + depth * sin(2πt/period))`` — the daily
    swell and trough of user traffic, mean rate preserved."""
    assert rate > 0.0 and 0.0 <= depth < 1.0
    if period is None:
        period = horizon  # one "day" per run by default
    peak = rate * (1.0 + depth)
    t = rng.expovariate(peak)
    while t < horizon:
        lam_t = rate * (1.0 + depth * math.sin(2.0 * math.pi * t / period))
        if rng.random() < lam_t / peak:
            yield t
        t += rng.expovariate(peak)


ARRIVALS: dict[str, Callable[..., Iterator[float]]] = {
    "poisson": poisson_arrivals,
    "bursty": bursty_arrivals,
    "diurnal": diurnal_arrivals,
}


# -- workload synthesis -----------------------------------------------------


def generate(
    profiles: Iterable[TenantProfile],
    *,
    rate: float,
    horizon: float,
    process: str = "poisson",
    seed: int = 0,
    **process_kwargs,
) -> list[LaunchRequest]:
    """Synthesize one open-loop request stream over the tenant mix.

    Every arrival of the aggregate process is assigned to a tenant by
    weighted choice; the tenant's per-launch register stream (advancing
    buffer pointers over static dims) becomes the request's fields, and the
    arrival time is stamped onto :class:`LaunchRequest.arrival_time`.
    Deterministic: one ``random.Random(seed)`` drives arrivals and tenant
    assignment alike.
    """
    profiles = list(profiles)
    assert profiles, "need at least one tenant profile"
    assert process in ARRIVALS, f"unknown process {process!r} (have {sorted(ARRIVALS)})"
    rng = random.Random(seed)
    # distinct per-tenant address spaces even if callers reuse base_addr:
    # any profile whose base collides with an earlier one is shifted to a
    # fresh 4 MiB-spaced region
    spaced: list[TenantProfile] = []
    seen_bases: set[int] = set()
    for i, p in enumerate(profiles):
        if p.base_addr in seen_bases:
            p = TenantProfile(**{**p.__dict__,
                                 "base_addr": 0x1000 + i * 0x400000})
        seen_bases.add(p.base_addr)
        spaced.append(p)
    weights = [p.weight for p in spaced]
    counters = {p.tenant: 0 for p in spaced}
    requests: list[LaunchRequest] = []
    for t in ARRIVALS[process](rate, horizon, rng, **process_kwargs):
        prof = rng.choices(spaced, weights=weights)[0]
        idx = counters[prof.tenant]
        counters[prof.tenant] = idx + 1
        requests.append(LaunchRequest(
            tenant=prof.tenant,
            dims=prof.dims,
            extra=prof.regs_extra(idx),
            accel=prof.accel,
            arrival_time=t,
            priority=prof.priority,
        ))
    return requests


def slo_targets(profiles: Iterable[TenantProfile]) -> dict[str, float]:
    """The per-tenant latency targets the mix declares (tenants without an
    explicit ``slo_cycles`` are omitted — the report treats them as best
    effort)."""
    return {p.tenant: p.slo_cycles for p in profiles if p.slo_cycles is not None}
