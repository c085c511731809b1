"""BridgeReport — the closed-loop run folded into the repo's vocabulary.

The port's own copy of ``repro/bridge/report.py``: the code is the
reference's, unchanged.

Three views of one run, mutually checkable:

* the **cluster view** — the ordinary :class:`~repro.cluster.slo.ClusterReport`
  (per-launch percentiles, per-host roofline points, link telemetry), with
  token-level :class:`~repro.cluster.slo.TenantServing` stats attached;
* the **step view** — per-tenant decode-step latencies and descriptor-byte
  timelines built from the closed loop's :class:`StepRecord` log;
* the **accounting parity** — :meth:`BridgeReport.config_parity` compares,
  per tenant, the bytes the cluster devices report against the engine's own
  ``config_traffic()`` plus the two documented launch-path terms
  (launch-command writes, tile registers). The two caches are independent
  implementations fed the same stream; the identity holding is evidence
  that slot-residency routing preserved warmth end to end, and its failure
  is the first observable of residency loss (eviction, a spilled launch).

Serving roofline: :meth:`serving_roofline` places each tenant on the
configuration roofline with **token work over descriptor bytes** as I_OC
(``core.roofline.decode_roofline_point``) — the multi-host serving points
the paper's Eq. 4 analysis was built to answer for, now produced by the
actual decode launch path instead of a GEMM proxy.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Sequence

from ..cluster.slo import ClusterReport, TenantServing, build_report
from ..core.roofline import RooflinePoint, decode_roofline_point
from .tenant import TenantEngine

if TYPE_CHECKING:  # bridge.driver imports this module; avoid the cycle
    from .driver import StepRecord


@dataclass
class BridgeReport:
    """Everything observed about one closed-loop bridged run."""

    cluster: ClusterReport
    steps: list["StepRecord"]
    engine_traffic: dict[str, dict[str, float]]  # tenant -> config_traffic()
    expected: dict[str, dict[str, float]]  # tenant -> expected cluster bytes
    ops_per_token: dict[str, float]  # tenant -> decode-tile ops per token
    p_peak: dict[str, float]  # tenant -> its device kind's peak ops/cycle

    # -- tokens --------------------------------------------------------------

    @property
    def metrics(self):
        """The run's unified :class:`~repro.obs.metrics.MetricsRegistry`:
        the cluster registry (every host's ``sched.*`` series under a
        ``host=`` label) with the ``bridge.*`` step-level series folded in
        by :func:`build_bridge_report`."""
        return self.cluster.metrics

    @property
    def serving(self) -> dict[str, TenantServing]:
        return self.cluster.serving

    @property
    def tokens(self) -> int:
        return self.cluster.tokens

    @property
    def tokens_per_kcycle(self) -> float:
        return self.cluster.tokens_per_kcycle

    def decode_latencies(self, tenant: str) -> list[float]:
        return [s.latency for s in self.steps if s.tenant == tenant]

    def ttft_cycles(self) -> dict[str, float]:
        """Mean admission-step latency per tenant — the closed-loop
        time-to-first-token proxy: an admission step's latency spans its
        prefill chain plus the first decode launch, so this is exactly the
        quantity chunked prefill shortens vs. token-at-a-time (prompts of
        one token admit with no prefill launch and are excluded)."""
        out: dict[str, float] = {}
        for tenant in sorted({s.tenant for s in self.steps}):
            lats = [s.latency for s in self.steps
                    if s.tenant == tenant and s.prefill_launches > 0]
            if lats:
                out[tenant] = sum(lats) / len(lats)
        return out

    # -- descriptor traffic --------------------------------------------------

    def step_timeline(self, tenant: str) -> list[tuple[float, int, int]]:
        """Per-step ``(arrival, bytes_sent, bytes_elided)`` for one tenant —
        the decode-step descriptor-byte timeline (launches of one step are
        folded; ``cluster.descriptor_timeline`` keeps them separate)."""
        return [(s.arrival, s.bytes_sent, s.bytes_elided)
                for s in self.steps if s.tenant == tenant]

    def overlap_summary(self) -> dict[str, float]:
        """How much of the run's descriptor T_set the engine hid behind
        compute (0.0 everywhere on a serialized cluster) — the bridge-level
        view of the §5.5 runtime win that shortened every feedback edge."""
        m = self.metrics
        if m is not None and m.has("bridge.config_cycles"):
            cfg = m.total("bridge.config_cycles")
            hidden = cfg - m.total("bridge.exposed_config_cycles")
        else:
            cfg = sum(s.config_cycles for s in self.steps)
            hidden = sum(s.hidden_config for s in self.steps)
        return {
            "config_cycles": cfg,
            "exposed_config_cycles": cfg - hidden,
            "hidden_config_cycles": hidden,
            "hidden_fraction": hidden / cfg if cfg else 0.0,
        }

    def tenant_bytes(self, tenant: str) -> dict[str, float]:
        """Cluster-side config bytes for one tenant, summed over hosts."""
        recs = [r for r in self.cluster.records if r.tenant == tenant]
        return {
            "bytes_sent": float(sum(r.bytes_sent for r in recs)),
            "bytes_elided": float(sum(r.bytes_elided for r in recs)),
        }

    def config_parity(self) -> dict[str, dict[str, float | bool]]:
        """Per tenant: the engine's expected accounting vs. what the
        cluster devices actually reported. ``matched`` means both the sent
        and the elided bytes agree exactly — the bridged launch path sent
        precisely the descriptor deltas the engine's own cache says it
        should have (plus the documented launch/tile terms folded into
        ``expected`` by ``TenantEngine.expected_cluster_bytes``)."""
        out: dict[str, dict[str, float | bool]] = {}
        for tenant, want in self.expected.items():
            got = self.tenant_bytes(tenant)
            out[tenant] = {
                "engine_bytes_sent": self.engine_traffic[tenant]["bytes_sent"],
                "engine_bytes_elided": self.engine_traffic[tenant]["bytes_elided"],
                "expected_bytes_sent": want["bytes_sent"],
                "expected_bytes_elided": want["bytes_elided"],
                "cluster_bytes_sent": got["bytes_sent"],
                "cluster_bytes_elided": got["bytes_elided"],
                "matched": (got["bytes_sent"] == want["bytes_sent"]
                            and got["bytes_elided"] == want["bytes_elided"]),
            }
        return out

    # -- energy --------------------------------------------------------------

    def energy_report(self):
        """Joule attribution of the whole bridged run — an
        :class:`~repro.power.meter.EnergyReport` over every host's lanes
        (empty-model lanes price to zero; the conservation invariant still
        holds). Lazy import: the bridge stays importable without the power
        stack loaded."""
        from ..power.meter import attribute_energy
        return attribute_energy(self)

    def tokens_per_joule(self) -> float:
        """The serving-efficiency figure of merit (tokens per pJ): the
        energy-roofline twin of :attr:`tokens_per_kcycle`, and what the
        power-capped bench trades against SLO attainment."""
        return self.energy_report().tokens_per_joule(self.tokens)

    def serving_energy_roofline(self) -> list:
        """One *energy*-roofline point per bridged tenant
        (:func:`~repro.core.roofline.energy_roofline_point`): ops per
        joule attained vs. operational configuration intensity, ridge in
        ops/J. The run's configuration energy is split across tenants in
        proportion to descriptor bytes sent — energy attribution is
        per-lane, not per-tenant, so the split is the documented
        approximation (exact when one tenant dominates a lane)."""
        from ..core.roofline import energy_roofline_point
        er = self.energy_report()
        config_energy = er.summary.get("config_energy", 0.0)
        total_bytes = sum(r.bytes_sent for r in self.cluster.records)
        kind_power = {}  # device kind -> compute active power (pJ/cycle)
        for host in sorted(self.cluster.hosts):
            rep = self.cluster.hosts[host]
            for name, tel in rep.resources.items():
                model = getattr(tel, "energy", None)
                if tel.kind == "compute" and model is not None:
                    # lane names are "compute[<kind>:<i>]"
                    kind = name.split("[", 1)[1].split(":", 1)[0]
                    kind_power.setdefault(kind, model.active_power)
        points = []
        for tenant, stats in sorted(self.cluster.serving.items()):
            recs = [r for r in self.cluster.records if r.tenant == tenant]
            if not recs:
                continue
            nbytes = sum(r.bytes_sent for r in recs)
            share = nbytes / total_bytes if total_bytes else 0.0
            kind = recs[0].device.rsplit(":", 1)[0]
            points.append(energy_roofline_point(
                f"serve[{tenant}]",
                total_ops=stats.tokens * self.ops_per_token[tenant],
                config_bytes=max(nbytes, 1),
                config_energy=max(config_energy * share, 1e-12),
                total_energy=max(er.total_energy * share, 1e-12),
                compute_power=kind_power.get(kind, 1e-12),
                p_peak=self.p_peak[tenant],
            ))
        return points

    # -- roofline ------------------------------------------------------------

    def serving_roofline(self) -> list[RooflinePoint]:
        """One configuration-roofline point per bridged tenant: I_OC is
        token work over the descriptor bytes actually sent for it, BW_cfg
        the effective bandwidth those bytes saw on the config port."""
        points = []
        for tenant, stats in sorted(self.cluster.serving.items()):
            recs = [r for r in self.cluster.records if r.tenant == tenant]
            if not recs:
                continue
            points.append(decode_roofline_point(
                f"serve[{tenant}]",
                tokens=stats.tokens,
                ops_per_token=self.ops_per_token[tenant],
                descriptor_bytes=max(sum(r.bytes_sent for r in recs), 1),
                config_cycles=sum(r.config_cycles for r in recs),
                makespan=self.cluster.makespan,
                p_peak=self.p_peak[tenant],
            ))
        return points


def build_bridge_report(cluster, steps: Sequence["StepRecord"],
                        tenants: Sequence[TenantEngine]) -> BridgeReport:
    """Fold the closed loop's step log and the cluster state into one report."""
    slo = {te.tenant: te.slo_cycles for te in tenants
           if te.slo_cycles is not None}
    report = build_report(cluster.hosts, slo=slo)
    serving = {
        te.tenant: TenantServing.from_steps(
            te.tenant,
            [s.latency for s in steps if s.tenant == te.tenant],
            te.tokens,
            report.makespan,
        )
        for te in tenants
    }
    report.attach_serving(serving)
    if report.metrics is not None:
        # step-level series beside the cluster's launch-level ones, so one
        # registry answers both "how many tokens" and "how congested"
        m = report.metrics
        for s in steps:
            m.counter("bridge.tokens", tenant=s.tenant).add(s.tokens)
            m.counter("bridge.steps", tenant=s.tenant).add(1)
            m.counter("bridge.config_cycles",
                      tenant=s.tenant).add(s.config_cycles)
            m.counter("bridge.exposed_config_cycles",
                      tenant=s.tenant).add(s.exposed_config)
            m.histogram("bridge.decode_latency",
                        tenant=s.tenant).observe(s.latency)
    return BridgeReport(
        cluster=report,
        steps=list(steps),
        engine_traffic={te.tenant: te.config_traffic() for te in tenants},
        expected={te.tenant: te.expected_cluster_bytes() for te in tenants},
        ops_per_token={
            te.tenant: 2.0 * te.dims[0] * te.dims[1] * te.dims[2]
            / max(te.engine.max_slots, 1)
            for te in tenants
        },
        p_peak={te.tenant: te.model.p_peak for te in tenants},
    )
