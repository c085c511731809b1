"""repro_torch.bridge against the JAX package's bridge.

The reference's bridge tests (``tests/test_bridge.py``) on the port: bridged
vs standalone token parity, descriptor→field translation, closed-loop
feedback, slot-residency routing and the engine↔cluster config-byte
identity. Then the two packages side by side on the reduced qwen2-0.5b,
on the same parameters (the JAX ``Model.init`` tree carried across): the
same descriptor gives the same fields and bytes, and a bridged run gives
the same report, step for step. Under fused sampling no descriptor
carries a generated id, so the reports are equal whatever bf16 rounding
does to the ids; under host sampling the ``tokens`` leaf carries them, so
that comparison asserts JAX's top-two logit margin at every live row of
every decode launch (ROADMAP.md, Queue 3).

The run on the card is marked ``gpu`` and skips here; JAX and the JAX
package are imported inside the CPU tests, so it also collects on a
machine without them.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.bridge import (
    ClosedLoopDriver,
    TenantEngine,
    descriptor_fields,
    descriptor_nbytes,
    descriptor_request,
    padded_nbytes,
)
from repro_torch.cluster import Cluster
from repro_torch.configs import get as torch_get
from repro_torch.core.accelerators import REGISTRY
from repro_torch.models.model import Model as TorchModel
from repro_torch.serving import Request, ServingEngine

OPENGEMM = REGISTRY["opengemm"]
GEMMINI = REGISTRY["gemmini"]
SEED = 119  # parameters whose host-sampled bridged run below stays clear of bf16 ties
MARGIN = 0.06  # twice the 0.03 cross-framework logit gap (ROADMAP.md, Queue 3)


@pytest.fixture(scope="module")
def pair():
    from _torch_port import reduced_pair

    return reduced_pair(SEED)


@pytest.fixture(scope="module")
def small_model(pair):
    *_, model, params = pair
    return model, params, ServingEngine.compile_decode(model)


PROMPTS = [[5, 9, 2], [7, 1], [3, 3, 3, 3]]


def _engine(small_model, **kw):
    model, params, decode_fn = small_model
    kw.setdefault("max_slots", 4)
    kw.setdefault("max_len", 64)
    eng = ServingEngine(model, params, decode_fn=decode_fn, **kw)
    for uid, prompt in enumerate(PROMPTS):
        eng.submit(Request(uid=uid, prompt=list(prompt), max_new_tokens=5))
    return eng


def _tokens(finished):
    return {r.uid: list(r.generated) for r in finished}


# -------------------------------------------------------- descriptor fields


def _desc(max_slots=4):
    return {
        "tokens": np.arange(max_slots, dtype=np.int32).reshape(max_slots, 1),
        "positions": np.zeros((max_slots,), np.int32),
        "live_mask": np.array([True] * (max_slots - 1) + [False]),
        "max_len": np.int32(64),
    }


def test_descriptor_fields_price_each_leaf_at_wire_size():
    desc = _desc()
    fields = descriptor_fields(desc, OPENGEMM)
    # int32 leaves on a 4-byte-field device: one field per element; the
    # 4-slot bool mask packs into exactly one field
    assert len(fields) == 4 + 4 + 1 + 1
    assert padded_nbytes(desc, OPENGEMM) == descriptor_nbytes(desc) == 4 * 10
    # 8-byte fields (gemmini) pad the 4-byte leaves
    assert padded_nbytes(desc, GEMMINI) > descriptor_nbytes(desc)


def test_leaf_changes_atomically():
    """All words of a leaf share its digest: any element change re-sends
    the whole leaf (matching the engine executor's whole-leaf comparison),
    and an identical leaf elides entirely."""
    from repro_torch.sched import ConfigStateCache

    cache = ConfigStateCache(bytes_of=lambda n, v: OPENGEMM.bytes_per_field)
    cache.dispatch("t", descriptor_fields(_desc(), OPENGEMM))
    changed = _desc()
    changed["tokens"][2, 0] = 99  # one element of one leaf
    plan = cache.dispatch("t", descriptor_fields(changed, OPENGEMM))
    assert {n.split("#")[0] for n in plan.sent} == {"['tokens']"}
    assert len(plan.sent) == 4  # the whole tokens leaf, not one word
    again = cache.dispatch("t", descriptor_fields(changed, OPENGEMM))
    assert not again.sent


def test_descriptor_request_carries_real_fields():
    req = descriptor_request("t0", _desc(), OPENGEMM, dims=(8, 16, 64),
                             arrival_time=42.0)
    assert req.accel == "opengemm" and req.arrival_time == 42.0
    regs = req.regs_for(OPENGEMM)
    assert (regs["M"], regs["K"], regs["N"]) == (8, 16, 64)
    assert any(name.startswith("['tokens']") for name in regs)


class _OnCard(torch.Tensor):
    """A host tensor that reports itself on the card: the bridge's refusal
    is decided by ``is_cuda`` alone, so it is tested here without one."""

    @property
    def is_cuda(self):
        return True


def test_a_cuda_tensor_leaf_raises_instead_of_synchronising():
    desc = {**_desc(), "positions": torch.zeros(4, dtype=torch.int32).as_subclass(_OnCard)}
    with pytest.raises(TypeError, match=r"\['positions'\] is a CUDA tensor"):
        descriptor_fields(desc, OPENGEMM)
    with pytest.raises(TypeError, match="CUDA tensor"):
        descriptor_nbytes(desc)
    # a host tensor is a host leaf: digested as the numpy array it views
    host = {**_desc(), "positions": torch.zeros(4, dtype=torch.int32)}
    assert descriptor_fields(host, OPENGEMM) == descriptor_fields(_desc(), OPENGEMM)


@pytest.mark.parametrize("sampling", ["fused", "host"])
def test_the_engine_builds_every_descriptor_leaf_on_the_host(pair, sampling):
    """Every leaf the port's engine hands the bridge is numpy: the bridge
    never meets a device tensor, so it never synchronises on the stream it
    observes."""
    *_, model, params = pair
    descs = []
    eng = ServingEngine(model, params, max_slots=4, max_len=64, sampling=sampling,
                        prefill_chunk=2, on_launch=descs.append)
    for uid, prompt in enumerate(PROMPTS):
        eng.submit(Request(uid=uid, prompt=list(prompt), max_new_tokens=3))
    eng.run_until_done()
    from repro_torch.dispatch.executor import flatten_with_path

    kinds = {"prefill_tokens" in d for d in descs}
    assert kinds == {True, False}
    leaves = [v for d in descs for _, v in flatten_with_path(d)]
    assert leaves and all(isinstance(v, (np.ndarray, np.generic)) for v in leaves)


# ------------------------------------------------------------- token parity


def test_bridged_tokens_bit_identical_to_standalone(small_model):
    """The bridge may never perturb model output — a cluster-bridged engine
    generates exactly the tokens the same engine produces standalone, for
    the same seeds and submission order."""
    standalone = _engine(small_model)
    want = _tokens(standalone.run_until_done())

    bridged = _engine(small_model)
    tenant = TenantEngine("t0", bridged, accel="opengemm")
    cluster = Cluster.uniform(2, {"opengemm": 1}, policy="affinity",
                              sticky=True, link="noc")
    ClosedLoopDriver([tenant], cluster).run()
    got = _tokens(bridged.finished)
    assert got == want

    # and the routing policy is irrelevant to output: round-robin too
    rr = _engine(small_model)
    ClosedLoopDriver(
        [TenantEngine("t0", rr, accel="opengemm")],
        Cluster.uniform(2, {"opengemm": 1}, policy="round_robin"),
    ).run()
    assert _tokens(rr.finished) == want


# -------------------------------------------------------------- closed loop


def test_closed_loop_feedback_serializes_a_tenants_steps(small_model):
    """A tenant's next step arrives exactly when its previous step
    completed: queueing delay throttles the token clock (closed loop),
    instead of piling into a percentile (open loop)."""
    eng = _engine(small_model)
    tenant = TenantEngine("t0", eng, accel="opengemm")
    cluster = Cluster.uniform(1, {"opengemm": 1}, policy="affinity",
                              sticky=True, link="noc")
    rep = ClosedLoopDriver([tenant], cluster).run()
    steps = [s for s in rep.steps if s.tenant == "t0"]
    assert len(steps) >= 5
    for prev, nxt in zip(steps, steps[1:]):
        assert nxt.arrival == prev.completion
        assert nxt.completion > nxt.arrival
    # token goodput is finite and accounted on the cluster clock
    assert rep.tokens == sum(s.tokens for s in steps) > 0
    assert rep.tokens_per_kcycle > 0.0
    assert rep.serving["t0"].p99_decode >= rep.serving["t0"].p50_decode > 0.0


def test_sticky_router_binds_decode_to_the_kv_home(small_model):
    """Slot residency is binding: every launch of a bridged tenant lands
    on the host that adopted its KV context, even with other hosts idle."""
    eng = _engine(small_model)
    tenant = TenantEngine("t0", eng, accel="opengemm")
    cluster = Cluster.uniform(3, {"opengemm": 1}, policy="affinity",
                              sticky=True)
    rep = ClosedLoopDriver([tenant], cluster).run()
    placements = rep.cluster.placements()["t0"]
    assert len(placements) == 1  # one home host, all launches
    home = next(iter(placements))
    assert cluster.router.home("t0").id == home


def test_round_robin_without_sticky_shuffles_the_tenant(small_model):
    eng = _engine(small_model)
    tenant = TenantEngine("t0", eng, accel="opengemm")
    cluster = Cluster.uniform(3, {"opengemm": 1}, policy="round_robin",
                              sticky=False)
    rep = ClosedLoopDriver([tenant], cluster).run()
    assert len(rep.cluster.placements()["t0"]) == 3  # thrashes every host


# ------------------------------------------------------- accounting parity


def test_config_bytes_match_engine_accounting(small_model):
    """The cluster device's field-granular cache and the engine executor's
    leaf-granular cache are independent implementations fed one stream:
    under sticky routing their byte accounting must agree exactly (modulo
    the documented launch-command and tile-register terms)."""
    engines = [_engine(small_model) for _ in range(2)]
    tenants = [TenantEngine(f"t{i}", e, accel="opengemm")
               for i, e in enumerate(engines)]
    cluster = Cluster.uniform(2, {"opengemm": 1}, policy="affinity",
                              sticky=True, link="noc")
    rep = ClosedLoopDriver(tenants, cluster).run()
    parity = rep.config_parity()
    assert set(parity) == {"t0", "t1"}
    for tenant, p in parity.items():
        assert p["matched"], (tenant, p)
        # elision is real: resident state kept most descriptor bytes off
        # the wire after the first step
        assert p["cluster_bytes_elided"] > 0


def test_step_timeline_shows_first_step_full_send(small_model):
    eng = _engine(small_model)
    tenant = TenantEngine("t0", eng, accel="opengemm")
    cluster = Cluster.uniform(1, {"opengemm": 1}, policy="affinity",
                              sticky=True)
    rep = ClosedLoopDriver([tenant], cluster).run()
    timeline = rep.step_timeline("t0")
    assert len(timeline) == rep.serving["t0"].steps
    (_, first_sent, _), (_, later_sent, later_elided) = timeline[0], timeline[-1]
    assert first_sent > later_sent  # cold full send vs steady-state delta
    assert later_elided > 0  # invariant config rode device-resident state
    # the cluster-wide launch timeline carries the same traffic, unfolded
    launches = rep.cluster.descriptor_timeline("t0")
    assert sum(b for _, b, _ in launches) == sum(b for _, b, _ in timeline)


def test_serving_roofline_points_are_config_bound_here(small_model):
    """Tiny decode tiles against per-step descriptor traffic sit left of
    the knee: the bridged serving points land configuration-bound, on the
    same axes as every other roofline point in the repo."""
    eng = _engine(small_model)
    tenant = TenantEngine("t0", eng, accel="opengemm")
    cluster = Cluster.uniform(1, {"opengemm": 1}, policy="affinity",
                              sticky=True, link="noc")
    rep = ClosedLoopDriver([tenant], cluster).run()
    (pt,) = rep.serving_roofline()
    assert pt.name == "serve[t0]"
    assert pt.i_oc > 0 and pt.performance > 0
    assert pt.bound == "configuration"


def test_overlapped_cluster_raises_token_goodput_bit_identically(small_model):
    """Runtime config overlap threads through closed-loop decode — on an
    overlapped PCIe cluster each descriptor's burst DMA streams behind the
    previous launch's compute, shortening the feedback edge, so
    tokens/kcycle rises while the generated tokens (and the engine↔cluster
    byte-accounting parity) stay exactly the same."""
    def run(overlap):
        engines = [_engine(small_model) for _ in range(2)]
        tenants = [TenantEngine(f"t{i}", e, accel="opengemm")
                   for i, e in enumerate(engines)]
        cluster = Cluster.uniform(1, {"opengemm": 1}, policy="affinity",
                                  sticky=True, link="pcie", overlap=overlap)
        rep = ClosedLoopDriver(tenants, cluster).run()
        tokens = {t.tenant: _tokens(t.engine.finished) for t in tenants}
        return rep, tokens

    ser, ser_tokens = run("serialized")
    ov, ov_tokens = run("overlapped")
    assert ov_tokens == ser_tokens  # timing moved, semantics did not
    assert ov.cluster.makespan < ser.cluster.makespan
    assert ov.tokens_per_kcycle > ser.tokens_per_kcycle
    # the win is exactly the hidden T_set: cycles streamed behind compute
    assert ser.overlap_summary()["hidden_config_cycles"] == 0.0
    assert ov.overlap_summary()["hidden_config_cycles"] > 0.0
    # byte accounting is untouched by overlap — parity still exact
    assert all(p["matched"] for p in ov.config_parity().values())
    assert ov.cluster.bytes_sent == ser.cluster.bytes_sent


# ------------------------------------------------- against the JAX bridge


def test_descriptor_fields_and_bytes_equal_the_references():
    from repro.bridge import descriptors as jdesc
    from repro.core.accelerators import REGISTRY as JREGISTRY

    descs = [_desc(), _desc(3), {"prefill_tokens": np.arange(8, dtype=np.int32),
                                 "prefill_len": np.int32(5), "slot_mask": np.eye(4, dtype=bool)[1],
                                 "nested": {"b": np.float32(1.5), "a": [np.int8(3), np.int64(7)]}}]
    for desc in descs:
        assert descriptor_nbytes(desc) == jdesc.descriptor_nbytes(desc)
        for kind in ("opengemm", "gemmini"):
            model, jmodel = REGISTRY[kind], JREGISTRY[kind]
            assert padded_nbytes(desc, model) == jdesc.padded_nbytes(desc, jmodel)
            fields = descriptor_fields(desc, model)
            assert list(fields.items()) == list(jdesc.descriptor_fields(desc, jmodel).items())


PREFILL_CHUNK = 2


def _bridge_prompts(i: int) -> list[list[int]]:
    return [[3 + i, 5, 2 + (i % 3), 8], [7, 1 + i], [11, 2, 4, 1 + i, 6]]


def _torch_tenants(pair, sampling: str, n_tenants: int = 3, max_new: int = 5):
    *_, model, params = pair
    decode = ServingEngine.compile_decode(model, sampling=sampling)
    tenants = []
    for i in range(n_tenants):
        eng = ServingEngine(model, params, max_slots=4, max_len=64, decode_fn=decode,
                            sampling=sampling, prefill_chunk=PREFILL_CHUNK)
        for uid, prompt in enumerate(_bridge_prompts(i)):
            eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=max_new))
        tenants.append(TenantEngine(f"t{i}", eng, accel="opengemm", slo_cycles=2_000.0))
    return tenants


def _jax_tenants(pair, sampling: str, margins: list, n_tenants: int = 3, max_new: int = 5):
    """The same tenants on the JAX package. Under host sampling the decode
    step records JAX's top-two logit margin of every live row."""
    import jax.numpy as jnp
    from repro.bridge import TenantEngine as JaxTenantEngine
    from repro.serving import Request as JaxRequest
    from repro.serving import ServingEngine as JaxServingEngine

    _, model, params, *_ = pair
    compiled = JaxServingEngine.compile_decode(model, sampling=sampling)

    def host_decode(params, cache, tokens, positions, live):
        logits, cache = compiled(params, cache, tokens, positions, live)
        top = jnp.sort(logits[:, -1].astype(jnp.float32), axis=-1)
        margins.extend(np.asarray(top[:, -1] - top[:, -2])[np.asarray(live)].tolist())
        return logits, cache

    decode = host_decode if sampling == "host" else compiled
    prefill = JaxServingEngine.compile_prefill(model)
    tenants = []
    for i in range(n_tenants):
        eng = JaxServingEngine(model, params, max_slots=4, max_len=64, decode_fn=decode,
                               prefill_fn=prefill, sampling=sampling,
                               prefill_chunk=PREFILL_CHUNK)
        for uid, prompt in enumerate(_bridge_prompts(i)):
            eng.submit(JaxRequest(uid=uid, prompt=prompt, max_new_tokens=max_new))
        tenants.append(JaxTenantEngine(f"t{i}", eng, accel="opengemm", slo_cycles=2_000.0))
    return tenants


def _bridged(cluster_cls, driver_cls, tenants, policy: str, sticky: bool):
    cluster = cluster_cls.uniform(2, {"opengemm": 1}, policy=policy, sticky=sticky,
                                  link="noc", max_contexts=2)
    rep = driver_cls(tenants, cluster).run()
    streams = {te.tenant: _tokens(te.engine.finished) for te in tenants}
    numbers = {
        "makespan": rep.cluster.makespan,
        "tokens": rep.tokens,
        "tokens_per_kcycle": rep.tokens_per_kcycle,
        "launches": rep.cluster.launches,
        "bytes_sent": rep.cluster.bytes_sent,
        "bytes_elided": rep.cluster.bytes_elided,
        "steps": [dataclasses.asdict(s) for s in rep.steps],
        "parity": rep.config_parity(),
        "serving": {t: dataclasses.asdict(s) for t, s in rep.serving.items()},
        "ttft": rep.ttft_cycles(),
        "overlap": rep.overlap_summary(),
        "roofline": [dataclasses.asdict(p) for p in rep.serving_roofline()],
        "energy": rep.energy_report().total_energy,
        "placements": rep.cluster.placements(),
        "sync_bytes": [te.sync_bytes for te in tenants],
    }
    return numbers, streams


def _jax_bridged(pair, sampling: str, policy: str, sticky: bool, margins: list, **kw):
    from repro.bridge import ClosedLoopDriver as JaxDriver
    from repro.cluster import Cluster as JaxCluster

    return _bridged(JaxCluster, JaxDriver, _jax_tenants(pair, sampling, margins, **kw), policy,
                    sticky)


@pytest.mark.parametrize("policy,sticky", [("affinity", True), ("round_robin", False)])
def test_fused_bridged_report_equals_the_references(pair, policy, sticky):
    want, _ = _jax_bridged(pair, "fused", policy, sticky, [])
    got, streams = _bridged(Cluster, ClosedLoopDriver, _torch_tenants(pair, "fused"),
                            policy, sticky)
    assert want["tokens"] == 3 * 3 * 5 and len(want["steps"]) > 10
    assert all(p["matched"] for p in want["parity"].values()) == sticky
    assert got == want
    assert all(len(g) == 5 for s in streams.values() for g in s.values())


HOST_RUN = {"n_tenants": 2, "max_new": 3}  # 18 sampled ids, each clear of a bf16 tie


def test_host_sampled_bridged_report_and_tokens_equal_the_references(pair):
    margins = []
    want, want_streams = _jax_bridged(pair, "host", "affinity", True, margins, **HOST_RUN)
    assert len(margins) == 2 * 3 * 3 and min(margins) > MARGIN, min(margins)
    got, streams = _bridged(Cluster, ClosedLoopDriver, _torch_tenants(pair, "host", **HOST_RUN),
                            "affinity", True)
    assert streams == want_streams
    assert got == want
    assert want["sync_bytes"][0] == 4 * pair[0].vocab_size * 2  # (B, vocab) bf16 logits
    # fused sampling gives the same ids on the port, and a faster closed loop
    fused, fused_streams = _bridged(Cluster, ClosedLoopDriver,
                                    _torch_tenants(pair, "fused", **HOST_RUN), "affinity", True)
    assert fused_streams == streams
    assert fused["tokens_per_kcycle"] > got["tokens_per_kcycle"]


# ------------------------------------------------------------- on the card


@pytest.mark.gpu
def test_cuda_bridged_tokens_equal_the_standalone_engines():
    """On the card: two bridged tenants generate the tokens the same
    engines generate standalone, with one greedy_sample launch per fused
    decode launch, and the bridge refuses a device leaf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the sampling kernel has no CPU mode")
    from repro_torch.kernels.sampling import greedy_sample

    cfg = dataclasses.replace(torch_get("qwen2-0.5b").reduced(), remat="none")
    model = TorchModel(cfg, device="cuda")
    params = model.init(0)
    small = (model, params, ServingEngine.compile_decode(model))
    want = [_tokens(_engine(small).run_until_done()) for _ in range(2)]
    engines = [_engine(small) for _ in range(2)]
    tenants = [TenantEngine(f"t{i}", e, accel="opengemm") for i, e in enumerate(engines)]
    greedy_sample.launches = 0
    rep = ClosedLoopDriver(tenants, Cluster.uniform(2, {"opengemm": 1}, policy="affinity",
                                                    sticky=True, link="noc")).run()
    assert [_tokens(e.finished) for e in engines] == want
    decodes = sum(s.launches - s.prefill_launches for s in rep.steps)
    assert greedy_sample.launches == decodes > 0
    assert all(p["matched"] for p in rep.config_parity().values())
    with pytest.raises(TypeError, match="CUDA tensor"):
        descriptor_fields({"positions": torch.zeros(4, device="cuda")}, OPENGEMM)
