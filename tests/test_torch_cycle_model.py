"""The port's copies of the cycle model stay copies of the JAX package's.

Each copied module has the reference's code (its AST, docstrings aside,
with an absolute ``repro.`` import read as ``repro_torch.``), and the same
deterministic scenarios run through both packages give equal results,
compared exactly as plain data: a scheduler pool fed open-loop traffic,
the cluster under each router policy, the joule attribution of a run,
link and transport cycles, a roofline point and an interpreted IR module.
"""

from __future__ import annotations

import ast
import dataclasses
import math
from pathlib import Path

import pytest

import repro.cluster as jcluster
import repro.core.interp as jinterp
import repro.core.ir as jir
import repro.core.roofline as jroofline
import repro.fabric.link as jlink
import repro.fabric.transport as jtransport
import repro.power.meter as jmeter
import repro.power.model as jpower
import repro.sched as jsched
import repro_torch.cluster as tcluster
import repro_torch.core.interp as tinterp
import repro_torch.core.ir as tir
import repro_torch.core.roofline as troofline
import repro_torch.fabric.link as tlink
import repro_torch.fabric.transport as ttransport
import repro_torch.power.meter as tmeter
import repro_torch.power.model as tpower
import repro_torch.sched as tsched
from repro.core.accelerators import REGISTRY as JREGISTRY
from repro_torch.core.accelerators import REGISTRY as TREGISTRY

SRC = Path(__file__).resolve().parents[1] / "src"

COPIED = [
    "core/stats", "core/ir", "core/interp", "core/roofline",
    "engine/resources", "engine/overlap",
    "fabric/link", "fabric/transport",
    "obs/metrics", "obs/attribution", "obs/monitor",
    "power/model", "power/meter",
    "sched/queue", "sched/telemetry", "sched/scheduler",
    "cluster/traffic", "cluster/slo", "cluster/host", "cluster/router",
    "bridge/driver", "bridge/report", "bridge/tenant",
    "core/builder", "core/passes/canonicalize", "core/passes/state_tracing",
    "core/passes/licm", "core/passes/dedup", "core/passes/overlap", "core/passes/__init__",
    "core/lowering", "core/matmul_driver", "core/evaluate", "core/timeline",
    "obs/trace", "obs/export", "obs/whatif", "obs/diagnose", "obs/diff", "obs/doctor",
    "engine/autotune", "fabric/snapshot", "fabric/migrate", "cluster/shed", "cluster/powercap",
]

# The packages whose ``__init__`` re-exports every name of the reference's.
PACKAGES = ["core", "core/passes", "obs", "engine", "fabric", "cluster"]


# ------------------------------------------------------------ the copies


class _Normalise(ast.NodeTransformer):
    """Drops docstrings, reads an absolute ``repro`` import as
    ``repro_torch``, and reads ``python -m repro.`` as ``python -m
    repro_torch.`` in a string constant (a command line a module prints
    names its own package)."""

    COMMAND = "python -m repro."

    @staticmethod
    def _rename(name: str | None) -> str | None:
        if name == "repro" or (name or "").startswith("repro."):
            return "repro_torch" + name[len("repro"):]
        return name

    def visit_Constant(self, node):
        if isinstance(node.value, str):
            node.value = node.value.replace(self.COMMAND, "python -m repro_torch.")
        return node

    def _strip(self, node):
        self.generic_visit(node)
        body = node.body
        if (body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:] or [ast.Pass()]
        return node

    visit_Module = visit_ClassDef = visit_FunctionDef = visit_AsyncFunctionDef = _strip

    def visit_ImportFrom(self, node):
        if node.level == 0:
            node.module = self._rename(node.module)
        return node

    def visit_Import(self, node):
        for alias in node.names:
            alias.name = self._rename(alias.name)
        return node


def _code(path: Path) -> str:
    return ast.dump(_Normalise().visit(ast.parse(path.read_text())))


@pytest.mark.parametrize("module", COPIED)
def test_copy_has_the_reference_code(module):
    assert _code(SRC / "repro_torch" / f"{module}.py") == _code(SRC / "repro" / f"{module}.py")


def test_the_normaliser_reads_only_the_command_line_rule():
    """Two modules that differ only in the package a printed command names
    normalise equal; any other difference in a string constant, or a
    command naming a third package, still tells them apart."""
    def code(src: str) -> str:
        return ast.dump(_Normalise().visit(ast.parse(src)))

    ref = 'def main():\n    """python -m repro.x"""\n    return f(prog="python -m repro.obs.doctor")\n'
    assert code(ref) == code(ref.replace('"python -m repro.obs', '"python -m repro_torch.obs'))
    assert code(ref) != code(ref.replace('"python -m repro.obs', '"python -m other.obs'))
    assert code(ref) != code(ref.replace("obs.doctor", "obs.diff"))
    assert code("x = 'repro.obs.doctor'") != code("x = 'repro_torch.obs.doctor'")


def _exported(package: str, root: str) -> list[str]:
    """The names ``package``'s ``__init__`` lists in ``__all__``, read from
    its source."""
    tree = ast.parse((SRC / root / package / "__init__.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(getattr(t, "id", "") == "__all__"
                                                 for t in node.targets):
            return ast.literal_eval(node.value)
    return []


@pytest.mark.parametrize("package", PACKAGES)
def test_the_port_exports_every_name_the_reference_exports(package):
    import importlib

    want = _exported(package, "repro")
    assert want
    assert set(want) <= set(_exported(package, "repro_torch"))
    module = importlib.import_module("repro_torch." + package.replace("/", "."))
    assert all(hasattr(module, name) for name in want)


def _relative_imports(module: str) -> set[str]:
    """Modules a reference module imports relatively, as ``pkg/mod`` paths,
    lazy imports inside functions included."""
    pkg = module.split("/")[:-1]
    out = set()
    for node in ast.walk(ast.parse((SRC / "repro" / f"{module}.py").read_text())):
        if not isinstance(node, ast.ImportFrom) or node.level == 0:
            continue
        base = pkg[:len(pkg) - node.level + 1]
        target = base + (node.module.split(".") if node.module else [])
        names = [a.name for a in node.names]
        for name in names if not node.module else [None]:
            path = "/".join(target + ([name] if name else []))
            if (SRC / "repro" / f"{path}.py").exists():
                out.add(path)
        if node.module:
            path = "/".join(target)
            out.add(path if (SRC / "repro" / f"{path}.py").exists() else f"{path}/__init__")
    return out


def test_every_module_the_copies_reach_is_in_the_port():
    """Following the copies' relative imports, lazy ones included, reaches
    only modules the port has: a copy cannot fail at the first call of a
    line that imports what the port lacks."""
    seen, todo = set(), list(COPIED)
    while todo:
        mod = todo.pop()
        if mod in seen:
            continue
        seen.add(mod)
        if not mod.endswith("__init__"):
            todo.extend(_relative_imports(mod))
    missing = sorted(m for m in seen if not (SRC / "repro_torch" / f"{m}.py").exists())
    assert not missing, missing
    assert {"core/accelerators", "engine/costmodel", "sched/state_cache",
            "power/meter", "core/roofline", "checkpoint/store", "obs/attribution",
            "fabric/link"} <= seen


# ------------------------------------------------------------- plain data


def plain(x, depth: int = 0):
    """A value from either package as plain data: dataclasses and objects
    become dicts of their fields under their class name, containers their
    plain elements, callables their qualified name."""
    assert depth < 40, "cycle"
    if x is None or isinstance(x, (bool, int, float, str)):
        return x
    if isinstance(x, tuple):
        return tuple(plain(v, depth + 1) for v in x)
    if isinstance(x, list):
        return [plain(v, depth + 1) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(plain(v, depth + 1) for v in x)
    if isinstance(x, dict):
        return {plain(k, depth + 1): plain(v, depth + 1) for k, v in x.items()}
    if dataclasses.is_dataclass(x):
        fields = {f.name: plain(getattr(x, f.name), depth + 1) for f in dataclasses.fields(x)}
        return {"__class__": type(x).__name__, **fields}
    if callable(x):
        return getattr(x, "__qualname__", type(x).__name__)
    if hasattr(x, "__dict__"):
        return {"__class__": type(x).__name__, **plain(vars(x), depth + 1)}
    return repr(x)


def test_plain_data_tells_a_changed_field_apart():
    a = jsched.LaunchRequest("t", (8, 8, 8), {"A": 1})
    b = tsched.LaunchRequest("t", (8, 8, 8), {"A": 1})
    assert a != b  # dataclasses of two packages never compare equal
    assert plain(a) == plain(b)
    assert plain(a) != plain(dataclasses.replace(b, extra={"A": 2}))


# ------------------------------------------------------------- scenarios


def _profiles(pkg):
    return [pkg.TenantProfile(f"og{i}", dims=(8, 16, 16), accel="opengemm", slo_cycles=2_000.0,
                              priority=i % 2)
            for i in range(3)] + [
        pkg.TenantProfile(f"gem{i}", dims=(16, 16, 32), accel="gemmini", slo_cycles=3_000.0)
        for i in range(2)]


def _traffic(pkg, process: str):
    return pkg.generate(_profiles(pkg), rate=0.02, horizon=15_000, process=process, seed=7)


@pytest.mark.parametrize("process", ["poisson", "bursty", "diurnal"])
def test_traffic_is_the_references(process):
    j, t = _traffic(jcluster, process), _traffic(tcluster, process)
    assert len(j) > 20
    assert plain(j) == plain(t)


def _pool_report(sched, cluster, process):
    pool = sched.Scheduler.from_registry({"opengemm": 2, "gemmini": 1}, link="noc")
    rep = pool.run_open_loop(_traffic(cluster, process))
    return rep, {
        "makespan": rep.makespan,
        "bytes_sent": rep.bytes_sent,
        "bytes_elided": rep.bytes_elided,
        "config_cycles": rep.config_cycles,
        "preemptions": rep.preemptions,
        "placements": rep.placements,
        "launch_log": plain(rep.launch_log()),
        "devices": plain(rep.devices),
        "cache_stats": plain(rep.cache_stats),
        "links": plain(rep.links),
        "resources": plain(rep.resources),
        "metrics": plain(rep.metrics),
    }


@pytest.mark.parametrize("process", ["poisson", "bursty", "diurnal"])
def test_scheduler_pool_on_open_loop_traffic_is_the_references(process):
    (_, j), (_, t) = _pool_report(jsched, jcluster, process), _pool_report(tsched, tcluster, process)
    assert len(j["launch_log"]) > 20 and j["bytes_elided"] > 0
    assert j == t


def _cluster_run(cluster, power, policy: str, process: str = "bursty"):
    profiles = _profiles(cluster)
    c = cluster.Cluster.uniform(2, {"opengemm": 1, "gemmini": 1}, policy=policy, link="pcie",
                                overlap="overlapped", power=power.PowerSpec.default())
    reqs = cluster.generate(profiles, rate=0.03, horizon=12_000, process=process, seed=5)
    return c.run(reqs, slo=cluster.slo_targets(profiles))


def _cluster_numbers(rep) -> dict:
    return {
        "makespan": rep.makespan,
        "launches": rep.launches,
        "bytes_sent": rep.bytes_sent,
        "bytes_elided": rep.bytes_elided,
        "elision_ratio": rep.elision_ratio,
        "preemptions": rep.preemptions,
        "deadline_misses": rep.deadline_misses,
        "config_cycles": rep.config_cycles,
        "exposed_config_cycles": rep.exposed_config_cycles,
        "port_utilization": rep.port_utilization,
        "attainment": rep.attainment,
        "goodput": rep.goodput,
        "p50_queue": rep.queue_delay_percentile(50),
        "p99_latency": rep.latency_percentile(99),
        "placements": rep.placements(),
        "tenants": plain(rep.tenants),
        "records": plain(rep.records),
        "roofline": plain(rep.roofline),
        "traces": plain(rep.traces()),
        "links": plain(rep.links),
        "resources": plain(rep.resources),
    }


@pytest.mark.parametrize("policy", ["affinity", "round_robin", "jsq", "p2c"])
def test_cluster_under_each_router_is_the_references(policy):
    assert set(tcluster.ROUTERS) == set(jcluster.ROUTERS) == {"affinity", "round_robin", "jsq", "p2c"}
    j = _cluster_numbers(_cluster_run(jcluster, jpower, policy))
    t = _cluster_numbers(_cluster_run(tcluster, tpower, policy))
    assert j["launches"] > 20 and len(j["placements"]) == 5
    assert j == t


@pytest.mark.parametrize("policy", ["affinity", "round_robin"])
def test_energy_attribution_of_a_cluster_run_is_the_references(policy):
    j = jmeter.attribute_energy(_cluster_run(jcluster, jpower, policy)).check()
    t = tmeter.attribute_energy(_cluster_run(tcluster, tpower, policy)).check()
    assert j.total_energy > 0 and len(j.lanes) > 4
    assert (j.total_energy, j.max_residual) == (t.total_energy, t.max_residual)
    assert plain(j.summary) == plain(t.summary)
    assert plain(j.lanes) == plain(t.lanes)


SIZES = [0, 1, 4, 7, 64, 100, 1_000, 4_096, 65_536]


@pytest.mark.parametrize("link", ["csr", "noc", "pcie"])
def test_link_and_transport_cycles_are_the_references(link):
    jl, tl = jlink.resolve_link(link), tlink.resolve_link(link)
    assert plain(jl) == plain(tl)
    for n in SIZES:
        assert jl.write_cycles(n) == tl.write_cycles(n)
        if jl.supports_dma:
            assert jl.burst_cycles(n) == tl.burst_cycles(n)
        assert jl.mmio_cycles(n, 4) == tl.mmio_cycles(n, 4)
        if jl.wc_depth >= 2:  # a link without a posted-write buffer has no wc price
            assert jl.wc_cycles(n, 4) == tl.wc_cycles(n, 4)
    for kind in ("opengemm", "gemmini"):
        jm, tm = JREGISTRY[kind], TREGISTRY[kind]
        for n in SIZES:
            for mode in ("auto", "mmio", "burst", "wc"):
                for objective in ("cycles", "joules", "edp"):
                    assert plain(jtransport.plan_fields(n, jm, jl, mode, objective)) == \
                        plain(ttransport.plan_fields(n, tm, tl, mode, objective))
        assert jtransport.crossover_fields(jm, jl) == ttransport.crossover_fields(tm, tl)


def test_roofline_points_are_the_references():
    def points(rl):
        return [
            rl.processor_roofline(1024.0, 16.0, 3.5),
            rl.concurrent_config_roofline(1024.0, 1.77, 200.0),
            rl.sequential_config_roofline(1024.0, 1.77, 200.0),
            rl.knee_point(1024.0, 1.77),
            rl.config_bound(1024.0, 1.77, 200.0),
            rl.effective_config_bandwidth(4096.0, 900.0, 350.0),
            rl.decode_roofline_point("serve[t0]", tokens=30, ops_per_token=2.0 * 4 * 64 * 64 / 4,
                                     descriptor_bytes=1_204, config_cycles=1_460.0,
                                     makespan=1_337.0, p_peak=1024.0),
            rl.energy_roofline_point("e", total_ops=1e6, config_bytes=512, config_energy=40.0,
                                     total_energy=900.0, compute_power=3.0, p_peak=1024.0),
        ]
    j, t = points(jroofline), points(troofline)
    assert j[6].i_oc > 0 and not math.isnan(j[6].performance)
    assert plain(j) == plain(t)


def _program(ir):
    """Two setups of the same accelerator per iteration of a loop, the
    second changing one field, then a final launch outside the loop."""
    fn = ir.func("main")
    top = fn.regions[0].block
    c8, c16, lb, ub, step = (ir.constant(8), ir.constant(16), ir.constant(0, ir.INDEX),
                             ir.constant(4, ir.INDEX), ir.constant(1, ir.INDEX))
    for op in (c8, c16, lb, ub, step):
        top.append(op)
    loop = ir.for_(lb.result, ub.result, step.result)
    top.append(loop)
    body = loop.regions[0].block
    s1 = ir.setup("opengemm", {"M": c8.result, "K": c8.result, "N": c16.result})
    body.append(s1)
    t1 = ir.launch(s1.result, "opengemm")
    body.append(t1)
    body.append(ir.await_(t1.result))
    s2 = ir.setup("opengemm", {"M": c8.result, "K": c16.result, "N": c16.result})
    body.append(s2)
    t2 = ir.launch(s2.result, "opengemm")
    body.append(t2)
    body.append(ir.await_(t2.result))
    body.append(ir.yield_([]))
    s3 = ir.setup("gemmini", {"M": c16.result, "K": c16.result, "N": c16.result})
    top.append(s3)
    t3 = ir.launch(s3.result, "gemmini")
    top.append(t3)
    top.append(ir.await_(t3.result))
    top.append(ir.return_())
    return ir.Module(ops=[fn])


def test_interpreting_an_ir_module_is_the_references():
    j = jinterp.run(_program(jir), dict(JREGISTRY))
    t = tinterp.run(_program(tir), dict(TREGISTRY))
    assert len(j.invocations) == 9
    assert (j.total_cycles, j.config_bytes, j.performance, j.i_oc) == \
        (t.total_cycles, t.config_bytes, t.performance, t.i_oc)
    assert j.log_signature() == t.log_signature()
    assert plain(j) == plain(t)


# ------------------------------------------------------------ from_arch


def test_profile_from_arch_gives_the_references_tiles_for_qwen2():
    j = jcluster.TenantProfile.from_arch("q", "qwen2-0.5b", accel="opengemm")
    t = tcluster.TenantProfile.from_arch("q", "qwen2-0.5b", accel="opengemm")
    assert t.dims == j.dims == (16, 64, 64)
    assert plain(t) == plain(j)


def test_profile_from_arch_gives_the_references_tiles_for_rwkv6():
    j = jcluster.TenantProfile.from_arch("r", "rwkv6-7b", accel="opengemm")
    t = tcluster.TenantProfile.from_arch("r", "rwkv6-7b", accel="opengemm")
    assert t.dims == j.dims == (16, 64, 64)
    assert plain(t) == plain(j)


def test_profile_from_arch_gives_the_references_tiles_for_whisper():
    j = jcluster.TenantProfile.from_arch("w", "whisper-medium", accel="opengemm")
    t = tcluster.TenantProfile.from_arch("w", "whisper-medium", accel="opengemm")
    assert t.dims == j.dims == (16, 64, 64)
    assert plain(t) == plain(j)


@pytest.mark.parametrize("arch", ["phi-3-vision-4.2b", "phi4-mini-3.8b", "minitron-4b",
                                  "qwen2.5-32b", "paper-lm-100m"])
def test_profile_from_arch_gives_the_references_tiles_for_the_new_configs(arch):
    j = jcluster.TenantProfile.from_arch("d", arch, accel="opengemm")
    t = tcluster.TenantProfile.from_arch("d", arch, accel="opengemm")
    assert t.dims == j.dims
    assert plain(t) == plain(j)


@pytest.mark.parametrize("arch", ["kimi-k2-1t-a32b", "jamba-1.5-large-398b", "qwen2.5-72b",
                                  "no-such-arch"])
def test_profile_from_arch_of_an_unported_family_points_at_the_roadmap(arch):
    """kimi-k2 and jamba, once unported, give the reference's tiles now; a
    name neither registry holds raises ``KeyError`` in both packages."""
    if arch in ("kimi-k2-1t-a32b", "jamba-1.5-large-398b"):
        j = jcluster.TenantProfile.from_arch("x", arch, accel="opengemm")
        t = tcluster.TenantProfile.from_arch("x", arch, accel="opengemm")
        assert t.dims == j.dims
        assert plain(t) == plain(j)
        return
    with pytest.raises(KeyError, match="unknown arch"):
        jcluster.TenantProfile.from_arch("x", arch)
    with pytest.raises(KeyError, match="unknown arch"):
        tcluster.TenantProfile.from_arch("x", arch)


def _shared_port_stream(pkg):
    """Five launches drawn as ``tests/test_engine.py``'s ``overlap_streams``
    draws them, from ``random.Random(7)``, with a gap of 0 drawn two times
    in three (the reference's strategy draws gaps 0-200; a seeded search
    found this stream in its first ten): each launch a gap, three dims of
    8-48, 0-39 config fields ``p{j}`` of value 64·(0-3) + j, and a tenant
    t0-t2. Two t2 launches arrive at 174.0 and two t1 launches at 305.0."""
    import random

    rng = random.Random(7)
    rng.randint(3, 8)  # the stream's length, drawn first: 5
    reqs, t = [], 0.0
    for _ in range(5):
        t += float(rng.choice([0, 0, rng.randint(0, 200)]))
        dims = tuple(8 * rng.randint(1, 6) for _ in range(3))
        extra = {f"p{j}": rng.randint(0, 3) * 64 + j for j in range(rng.randint(0, 40))}
        reqs.append(pkg.LaunchRequest(f"t{rng.randint(0, 2)}", dims, extra, arrival_time=t))
    return reqs


@pytest.mark.parametrize("cluster, sched", [(jcluster, jsched), (tcluster, tsched)],
                         ids=["reference", "port"])
def test_shared_port_delays_every_launch_keyed_by_request(cluster, sched):
    """``tests/test_engine.py::test_shared_port_contention_never_completes_earlier``
    keys each run's ends by (tenant, arrival). Two launches of one tenant
    at one arrival share that key, the dict keeps the last record, and the
    private and shared runs list them in different orders: here the key
    (t1, 305.0) holds the 221,184-op launch's end privately and the
    98,304-op launch's shared, so the shared run looks 63.5 cycles early.
    Keyed by request (tenant, arrival, ops: the two launches differ in
    ops), no launch ends earlier behind the shared port. Both packages
    give the same records (the cluster model is not at fault)."""
    reqs = _shared_port_stream(sched)
    assert [(r.tenant, r.arrival_time) for r in reqs] == [
        ("t1", 0.0), ("t2", 174.0), ("t2", 174.0), ("t1", 305.0), ("t1", 305.0)]

    def run(shared):
        cl = cluster.Cluster.uniform(2, {"opengemm": 1}, policy="round_robin", link="noc",
                                     overlap="serialized", shared_port=shared)
        return cl.run(list(reqs)).records

    private, shared = run(False), run(True)
    by_request = [{(r.tenant, r.arrival, r.ops): r.end for r in recs}
                  for recs in (private, shared)]
    assert len(by_request[0]) == len(by_request[1]) == len(reqs)  # each launch its own key
    assert by_request[0].keys() == by_request[1].keys()
    for key, end in by_request[1].items():
        assert end >= by_request[0][key] - 1e-9, key
    assert by_request[0][("t1", 305.0, 98304)] == 455.5
    assert by_request[1][("t1", 305.0, 98304)] == 512.0

    # the reference test's key collides: five launches, three keys, and the
    # comparison of the last records under (t1, 305.0) pairs two launches
    keyed = [{(r.tenant, r.arrival): r.end for r in recs} for recs in (private, shared)]
    assert len(keyed[0]) == len(keyed[1]) == 3
    assert keyed[0][("t1", 305.0)] == 575.5 and keyed[1][("t1", 305.0)] == 512.0
    assert keyed[1][("t1", 305.0)] < keyed[0][("t1", 305.0)]


@pytest.mark.parametrize("shared", [False, True])
def test_shared_port_stream_records_are_the_references(shared):
    def records(cluster, sched):
        cl = cluster.Cluster.uniform(2, {"opengemm": 1}, policy="round_robin", link="noc",
                                     overlap="serialized", shared_port=shared)
        return plain(cl.run(_shared_port_stream(sched)).records)

    assert records(jcluster, jsched) == records(tcluster, tsched)
