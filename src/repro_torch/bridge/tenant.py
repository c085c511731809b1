"""TenantEngine — a serving engine adapted as a cluster tenant.

The counterpart of ``repro/bridge/tenant.py``, over the port's
:class:`~repro_torch.serving.engine.ServingEngine`; the code is the
reference's.

One serving engine is one tenant of the cluster: its KV cache is the slot
context that pins decode launches to a home host, and every launch its
executor stages — prefill steps and batch decode steps alike — is
mirrored, descriptor-for-descriptor, into a
:class:`~repro_torch.sched.scheduler.LaunchRequest` whose register fields
*are* the engine's real ``{positions, live-mask, ...}`` descriptor
(``bridge.descriptors``). The engine's compute is never touched: the
adapter observes the launch stream through ``ServingEngine.on_launch``,
so bridged token output is bit-identical to the standalone engine
(the parity test's contract).

Two caches now see the same stream — the engine executor's leaf-granular
descriptor cache (``engine.config_traffic()``) and the home device's
field-granular :class:`~repro_torch.sched.state_cache.ConfigStateCache` —
and :meth:`TenantEngine.expected_cluster_bytes` states the exact
accounting identity between them, which ``chip_smoke.py``'s ``[bridge]``
phase asserts on the card.
"""

from __future__ import annotations

from ..cluster.traffic import _pow2_tile
from ..core.accelerators import REGISTRY, AcceleratorModel
from ..sched.scheduler import LaunchRequest
from ..serving.engine import ServingEngine
from .descriptors import descriptor_request


def decode_tile(engine: ServingEngine) -> tuple[int, int, int]:
    """The per-step GEMM tile a decode launch of this engine amounts to:
    M = the slot batch, K/N = accelerator-friendly tiles of the model's
    ``d_model``/``d_ff`` — the dominant MLP GEMM of one decode step (the
    same derivation as ``cluster.traffic.TenantProfile.from_arch``)."""
    cfg = engine.model.cfg
    return (
        _pow2_tile(engine.max_slots),
        _pow2_tile(cfg.d_model),
        _pow2_tile(cfg.d_ff),
    )


class TenantEngine:
    """One bridged tenant: a serving engine plus its cluster identity.

    ``accel`` names the :data:`~repro.core.accelerators.REGISTRY` model
    standing in for the engine's device; ``dims`` overrides the decode
    GEMM tile (default: derived from the engine's model config)."""

    def __init__(
        self,
        tenant: str,
        engine: ServingEngine,
        *,
        accel: str | AcceleratorModel = "opengemm",
        dims: tuple[int, int, int] | None = None,
        priority: int = 0,
        slo_cycles: float | None = None,
    ):
        self.tenant = tenant
        self.engine = engine
        self.model = accel if isinstance(accel, AcceleratorModel) else REGISTRY[accel]
        self.dims = tuple(dims) if dims is not None else decode_tile(engine)
        self.priority = priority
        self.slo_cycles = slo_cycles
        self.tokens = 0
        self.steps = 0
        self.launches = 0
        # per-dim-field send count for the accounting identity: a dim
        # register crosses the boundary whenever its value differs from the
        # previous launch's (prefill launches scale M by the chunk length,
        # so entering/leaving prefill re-sends M while K/N stay resident)
        self._dim_sends = [0] * len(self.dims)
        self._last_dims: tuple[int, ...] | None = None
        self._pending: list[dict] = []
        assert engine.on_launch is None, (
            "engine already has a launch observer — one bridge per engine")
        engine.on_launch = self._pending.append

    @property
    def done(self) -> bool:
        """No queued requests and no live slots — the engine has drained."""
        return not (self.engine.queue or self.engine.live_slots)

    def step(self) -> tuple[int, list[dict]]:
        """Advance the engine one continuous-batching step and hand back
        the launch descriptors it actually issued (possibly several: an
        admission's prefill launches ride ahead of the decode launch)."""
        produced = self.engine.step()
        # drain in place: the engine's observer holds this very list
        descs = list(self._pending)
        self._pending.clear()
        self.tokens += produced
        self.steps += 1 if descs else 0
        self.launches += len(descs)
        return produced, descs

    def launch_dims(self, desc: dict) -> tuple[int, ...]:
        """The GEMM dims one captured launch amounts to. A chunked prefill
        launch runs ``prefill_len`` masked decode steps, so its macro-op is
        the decode tile with M scaled by the valid chunk length — the
        cluster then prices its compute honestly (``2·M·K·N``) instead of
        as a single decode step."""
        if "prefill_tokens" in desc:
            n = max(int(desc["prefill_len"]), 1)
            return (self.dims[0] * n, *self.dims[1:])
        return self.dims

    def request(self, desc: dict, arrival_time: float) -> LaunchRequest:
        """Mirror one captured descriptor into a cluster launch request.
        Calls must follow the engine's launch order — the per-dim-field
        accounting mirrors the device cache's value comparison."""
        dims = self.launch_dims(desc)
        for i, d in enumerate(dims):
            if self._last_dims is None or self._last_dims[i] != d:
                self._dim_sends[i] += 1
        self._last_dims = dims
        # tag the cost-model shape class: a calibrated scheduler prices
        # chunked prefill (M scaled by the chunk) and single-step decode
        # through the same fitted GEMM model but as distinct streams
        kernel = "prefill" if "prefill_tokens" in desc else "decode"
        return descriptor_request(
            self.tenant, desc, self.model, dims,
            arrival_time=arrival_time, priority=self.priority,
            kernel=kernel,
        )

    @property
    def sync_bytes(self) -> int:
        """The engine's per-decode-step device→host sync payload (sampled
        ids under fused sampling; full logits under host sampling)."""
        return getattr(self.engine, "sync_bytes", 0)

    def config_traffic(self) -> dict[str, float]:
        """The engine executor's own sent/elided split (leaf-granular)."""
        return self.engine.config_traffic()

    def expected_cluster_bytes(self) -> dict[str, float]:
        """What the home device's cache must report for this tenant when
        slot-residency routing held (no eviction, every launch on one
        device), stated from the engine's own accounting:

        * ``bytes_sent``  = engine bytes sent
                            + one launch-command write per launch
                            + one tile-register write per dim-field *value
                              change* (``_dim_sends`` — the first launch,
                              plus every prefill↔decode M transition);
        * ``bytes_elided`` = engine bytes elided
                             + the tile registers on every launch whose
                               value the device already held.

        With constant dims this reduces to the classic form (tile sent
        once, elided ever after). Exact whenever each descriptor leaf's
        size divides the device's ``bytes_per_field`` (int32 leaves on a
        4-byte-field device); any divergence means the cluster path dropped
        residency the engine kept — the accounting-parity failure the
        benchmark must catch."""
        t = self.engine.config_traffic()
        bpf = self.model.bytes_per_field
        tile_sends = sum(self._dim_sends)
        tile_slots = len(self.dims) * self.launches
        return {
            "bytes_sent": t["bytes_sent"] + self.launches * bpf
            + tile_sends * bpf,
            "bytes_elided": t["bytes_elided"]
            + (tile_slots - tile_sends) * bpf,
        }

    def drain(self) -> None:
        """Retire the engine's still-staged launches (end of run)."""
        self.engine.executor.drain()
