"""ClosedLoopDriver — N serving engines against the cluster, with feedback.

The port's own copy of ``repro/bridge/driver.py``: the code is the
reference's, unchanged.

``Cluster.run`` / ``Scheduler.run_open_loop`` are *open-loop*: the request
stream is fixed up front and arrives on its own clock no matter how far
the pool falls behind. Production decode is not like that — a tenant
cannot ask for token *t+1* until token *t* exists. ``ClosedLoopDriver`` closes the
loop: each tenant's next step is released only at the completion cycle of
its previous step's launches, so queueing delay does not just show up in
a percentile — it **throttles token throughput** (the cluster's
tokens/kcycle falls as ports congest, which no open-loop replay can show).

The event loop is a single min-heap over tenant ready-times (ties broken
by tenant name, so runs are deterministic): pop the earliest-ready tenant,
advance its engine one continuous-batching step (real JAX compute — the
engine's own launch path, not a synthetic proxy), mirror the step's
captured descriptors into launch requests arriving back-to-back (each
launch's arrival is its predecessor's completion — prefill chains
serialize the same way the engine's staging ring issues them), route and
dispatch them, and push the tenant back at the last launch's retirement.

On a tenant's first dispatch the chosen host adopts its slot context
(``Host.adopt_context``): under a sticky router every later launch of
that tenant is bound to this home (KV-cache residency), while non-sticky
baselines (round-robin) keep shuffling it — the A/B the benchmark runs.

Runtime config overlap (``repro.engine``) threads straight through this
loop: on an ``overlap="overlapped"`` cluster each descriptor's burst DMA
streams behind the previous launch's compute, so the launch retires
earlier, the feedback edge (``rec.end``) moves earlier, and the tenant's
next step is released sooner — hidden T_set lands directly on
``tokens_per_kcycle``, which no open-loop replay can show. Each
:class:`StepRecord` carries the step's exposed-vs-hidden config cycles so
the bridge report can say how much of the win was overlap.

The feedback edge also prices the **device→host sync** the engine blocks
on before it can schedule its next step (``TenantEngine.sync_bytes``):
under host-side sampling that is the full ``(B, vocab)`` logits tensor
crossing the boundary every decode step just to be argmaxed; under the
fused sampling kernel it is ``B`` int32 token ids. The readback crosses
the home host's link (burst DMA when the link supports it, an ordered
write otherwise; a core-local ``csr`` link prices it to ~0), so the
fused-sampling win lands where the paper says it must — on the closed
loop's tokens/kcycle, not just on descriptor byte counts."""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Mapping, Sequence

from ..cluster.router import Cluster
from ..obs.monitor import feed_step
from .report import BridgeReport, build_bridge_report
from .tenant import TenantEngine


@dataclass(frozen=True)
class StepRecord:
    """One engine step's closed-loop life on the cluster."""

    tenant: str
    step: int  # this tenant's step index
    arrival: float  # cycle the step's first launch entered the cluster
    completion: float  # cycle its last launch retired
    tokens: int  # tokens the step produced
    launches: int  # launches the step issued (prefill chains > 1)
    prefill_launches: int = 0  # ... of which were chunked-prefill launches
    bytes_sent: int = 0  # config bytes that crossed the boundary
    bytes_elided: int = 0  # config bytes resident state kept off the wire
    config_cycles: float = 0.0  # T_set of the step's descriptors
    exposed_config: float = 0.0  # ... the part the engine failed to hide
    readback_cycles: float = 0.0  # device→host sampling sync on the link
    compute_cycles: float = 0.0  # device cycles the step's macro-ops ran

    @property
    def latency(self) -> float:
        """Step latency — what a decode-latency SLO is written against."""
        return self.completion - self.arrival

    @property
    def hidden_config(self) -> float:
        """Descriptor config cycles the overlapped engine streamed behind
        compute — cycles that no longer delay this tenant's next token."""
        return self.config_cycles - self.exposed_config


class ClosedLoopDriver:
    """Drives bridged tenant engines to completion against one cluster."""

    def __init__(self, tenants: Sequence[TenantEngine], cluster: Cluster,
                 *, start_offsets: Mapping[str, float] | None = None,
                 tracer=None, monitor=None):
        assert tenants, "need at least one tenant engine"
        names = [t.tenant for t in tenants]
        assert len(set(names)) == len(names), f"duplicate tenants in {names}"
        self.tenants = {t.tenant: t for t in tenants}
        self.cluster = cluster
        self.steps: list[StepRecord] = []
        self._offsets = dict(start_offsets or {})
        # reuse the cluster's tracer by default so step spans and the
        # launch spans the hosts already emit land in one trace
        self.tracer = tracer if tracer is not None \
            else getattr(cluster, "tracer", None)
        # streaming observer (obs.monitor.StreamMonitor): fed one sample
        # batch per step under the canonical ``bridge.*`` names, so
        # windowed signals (SLO burn rate, exposed-config ratio, token
        # rate) are live *during* the run. Observation-only: feeding it
        # never moves a clock.
        self.monitor = monitor

    def _dispatch(self, te: TenantEngine, desc: dict, now: float):
        """Route + dispatch one mirrored launch; returns its
        :class:`~repro.sched.telemetry.LaunchRecord` — its ``end`` is the
        feedback edge of the closed loop. The record is matched by
        (tenant, arrival), not taken as ``launch_log[-1]``: a
        priority-carrying tenant's dispatch can preempt a staged launch,
        whose victim is re-dispatched *after* the preemptor and would
        otherwise be misread as this launch's record. A tenant never has
        two launches with one arrival time — the closed loop serializes
        its stream."""
        req = te.request(desc, arrival_time=now)
        router = self.cluster.router
        host = router.route(req, now=now)
        dev = host.dispatch(req)
        if dev is None:
            # the tenant's config-bandwidth quota window was exhausted and
            # the launch parked (``Host.dispatch`` deferred it). The closed
            # loop must observe its completion before releasing the next
            # step, so force it through at its window release edge — the
            # deferral still lands in this tenant's own step latency
            host.flush_deferred()
            devices = host.devices
        else:
            devices = [dev]
        if router.home(te.tenant) is None:
            # first launch anywhere: the KV cache materializes here
            host.adopt_context(te.tenant)
        for d in devices:
            for rec in reversed(d.telemetry.launch_log):
                if rec.tenant == req.tenant and rec.arrival == req.arrival_time:
                    return rec, host
        raise AssertionError(
            f"dispatched launch for {req.tenant!r} left no record on {host.id}")

    @staticmethod
    def _readback_cycles(te: TenantEngine, link) -> float:
        """Cycles the step's device→host sampling sync occupies on the
        serving host's link — the payload the engine *blocks on* before it
        can schedule the next step, so it lands on the feedback edge."""
        nbytes = te.sync_bytes
        if not nbytes or link is None:
            return 0.0
        if link.supports_dma:
            return link.burst_cycles(nbytes)
        return link.write_cycles(nbytes)

    def run(self, max_steps: int = 100_000) -> BridgeReport:
        """Drain every tenant engine; returns the bridged report."""
        ready = [(self._offsets.get(name, 0.0), name)
                 for name in sorted(self.tenants)]
        heapq.heapify(ready)
        total = 0
        while ready:
            now, name = heapq.heappop(ready)
            te = self.tenants[name]
            if te.done:
                continue
            produced, descs = te.step()
            total += 1
            assert total <= max_steps, f"closed loop exceeded {max_steps} steps"
            if not descs:
                # a step that launched nothing means the engine drained
                # (live slots and queue both empty) — retire the tenant
                assert te.done, f"{name} stepped without launching or draining"
                continue
            t = now
            sent = elided = 0
            cfg = exposed = comp = 0.0
            host = None
            for desc in descs:
                rec, host = self._dispatch(te, desc, t)
                t = rec.end
                sent += rec.bytes_sent
                elided += rec.bytes_elided
                cfg += rec.config_cycles
                exposed += rec.exposed_config
                comp += rec.end - rec.start
            # feedback edge: the host blocks on the step's sampling sync
            # before it can release this tenant's next step
            rb = self._readback_cycles(te, host.link if host else None)
            t += rb
            prefills = sum(1 for d in descs if "prefill_tokens" in d)
            self.steps.append(StepRecord(
                tenant=name,
                step=te.steps,
                arrival=now,
                completion=t,
                tokens=produced,
                launches=len(descs),
                prefill_launches=prefills,
                bytes_sent=sent,
                bytes_elided=elided,
                config_cycles=cfg,
                exposed_config=exposed,
                readback_cycles=rb,
                compute_cycles=comp,
            ))
            if self.monitor is not None:
                feed_step(self.monitor, tenant=name, completion=t,
                          tokens=produced, latency=t - now,
                          config_cycles=cfg, exposed_config=exposed,
                          slo_cycles=te.slo_cycles)
            if self.tracer is not None:
                self.tracer.span("step", "step", now, t,
                                 lane=f"step[{name}]", tenant=name,
                                 step=te.steps, tokens=produced,
                                 launches=len(descs),
                                 prefill_launches=prefills,
                                 bytes_sent=sent)
                self.tracer.counter("tokens", t, float(te.tokens),
                                    lane=f"tokens[{name}]", tenant=name)
            heapq.heappush(ready, (t, name))
        for te in self.tenants.values():
            te.drain()
        return build_bridge_report(self.cluster, self.steps,
                                   list(self.tenants.values()))
