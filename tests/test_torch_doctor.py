"""The port's copy of the observation and diagnosis layer against the JAX
package's, on the CPU, with the rest of the framework-free half it needs.

Each scenario runs through both packages and the results are compared as
plain data, text or exported JSON: the golden scheduler trace of
``tests/test_obs.py`` and traced runs on every link and overlap mode (the
exported Chrome-trace documents, attribution, metrics and energy embedded);
``tests/test_doctor.py``'s what-if predictions, live diagnoses, diffs and
doctor CLI (the port's transcript and JSON on the port's traces equal the
reference CLI's on the reference's traces); a traced closed-loop bridge
run through the port's engines on the reduced qwen2-0.5b (fused sampling,
so the report does not depend on the model's numbers); and the load
shedding, power cap, migration, snapshot and autotune scenarios of
``tests/test_engine.py``, ``test_doctor.py``, ``test_power.py``,
``test_fabric.py`` and ``test_costmodel.py``.
"""

from __future__ import annotations

import importlib
import json
from types import SimpleNamespace

import pytest

from test_torch_cycle_model import plain

SIDES = ("jax", "port")
LINKS_MODES = [(link, mode) for link in ("csr", "noc", "pcie")
               for mode in ("serialized", "overlapped")]


def pkg(side: str) -> SimpleNamespace:
    """One package's modules under one set of names."""
    root = "repro" if side == "jax" else "repro_torch"
    names = ("sched", "cluster", "obs", "fabric", "power", "engine", "bridge", "serving",
             "obs.whatif", "obs.diff", "obs.doctor", "obs.diagnose", "cluster.powercap",
             "core.accelerators")
    mods = {n.replace(".", "_"): importlib.import_module(f"{root}.{n}") for n in names}
    return SimpleNamespace(**mods)


def _both(fn, *args):
    """``fn(package, *args)`` through each package: (reference's, port's)."""
    return fn(pkg("jax"), *args), fn(pkg("port"), *args)


# ------------------------------------------------------------- scenarios


def _stream(p, n=14, fields=24, mixed=True, gap=0.0):
    """``tests/test_doctor.py``'s stream: every field changes every launch."""
    return [p.sched.LaunchRequest(f"t{i % 3}", (16, 16, 16),
                                  {f"f{j}": 96 * i + j for j in range(fields)},
                                  accel=("opengemm" if i % 2 else "gemmini") if mixed
                                  else "opengemm",
                                  arrival_time=gap * i)
            for i in range(n)]


def _run(p, link, mode, tracer=None, **kwargs):
    s = p.sched.Scheduler.from_registry({"opengemm": 1, "gemmini": 1}, link=link,
                                        overlap=mode, tracer=tracer, **kwargs)
    return s.run_open_loop(_stream(p))


GOLDEN_REQS = [("a", 0.0), ("b", 10.0), ("a", 200.0), ("b", 260.0)]


def _golden(p):
    tr = p.obs.Tracer()
    s = p.sched.Scheduler.from_registry({"opengemm": 1}, link="noc", overlap="overlapped",
                                        tracer=tr)
    reqs = [p.sched.LaunchRequest(t, (16, 16, 16), {f"p{j}": int(at) + j for j in range(8)},
                                  arrival_time=at) for t, at in GOLDEN_REQS]
    return tr, s.run_open_loop(reqs)


# ----------------------------------------------------------------- traces


def test_golden_trace_is_the_references(tmp_path):
    out = {}
    for side in SIDES:
        p = pkg(side)
        tr, rep = _golden(p)
        att = p.obs.attribute(rep).check()
        path = tmp_path / f"{side}.json"
        doc = p.obs.write_trace(tr, str(path), attribution=att, metrics=rep.metrics)
        out[side] = (tr.lanes(), p.obs.chrome_trace(tr), doc, path.read_bytes())
    assert out["port"] == out["jax"]
    lanes, doc = out["jax"][0], out["jax"][2]
    assert lanes == ["cfg[noc]", "host", "compute[opengemm:0]", "tenant[a]", "tenant[b]"]
    assert pkg("port").obs.validate_trace(doc) == [] and doc["attribution"]["max_residual"] <= 1e-3


def _traced(p, link, mode, power: bool):
    tr = p.obs.Tracer()
    kw = {"power": p.power.PowerSpec.default()} if power else {}
    rep = _run(p, link, mode, tracer=tr, **kw)
    energy = None
    if power:
        p.obs.trace_power(tr, rep)
        energy = p.power.attribute_energy(rep).check()
    doc = p.obs.chrome_trace(tr)
    doc["attribution"] = p.obs.attribute(rep).check().to_dict()
    doc["metrics"] = rep.metrics.collect()
    if energy is not None:
        doc["energy"] = energy.to_dict()
    return json.loads(json.dumps(doc)), p.obs.validate_trace(doc)


@pytest.mark.parametrize("link,mode", LINKS_MODES)
def test_traced_scheduler_runs_export_the_references_documents(link, mode):
    (want, wp), (got, gp) = _both(_traced, link, mode, link == "pcie")
    assert wp == gp == []
    assert len(want["traceEvents"]) > 50
    assert got == want


def test_the_document_comparison_sees_a_changed_event():
    want, _ = _traced(pkg("port"), "noc", "overlapped", False)
    got = json.loads(json.dumps(want))
    got["traceEvents"][-1]["ts"] += 1e-9
    assert got != want


# --------------------------------------------------------------- what-if


@pytest.mark.parametrize("link,mode", LINKS_MODES)
def test_replay_is_the_references(link, mode):
    def replayed(p):
        rep = _run(p, link, mode)
        rows = p.obs_whatif.extract_rows(rep)
        r = p.obs_whatif.replay(rows, mode=mode, buffers=rep.staging_buffers)
        return plain(rows), plain(r), r.makespan == rep.makespan
    want, got = _both(replayed)
    assert want[2] and got == want


def _predictions(p):
    ser, ov = _run(p, "pcie", "serialized"), _run(p, "pcie", "overlapped")
    mmio = _run(p, "noc", "serialized", transport="mmio")
    s = p.sched.Scheduler.from_registry({"opengemm": 1}, link="noc", overlap="overlapped",
                                        staging_buffers=1)
    one = s.run_open_loop(_stream(p, n=12, fields=32, mixed=False))
    out = {
        "overlap": p.obs.predict_overlap(ser),
        "burst": p.obs.predict_burst(mmio),
        "staging": p.obs.predict_staging(one, buffers=2),
        "moot": [p.obs.predict_overlap(ov), p.obs.predict_staging(ser)],
    }
    return {k: v.to_dict() if hasattr(v, "to_dict") else v for k, v in out.items()}


def test_whatif_predictions_are_the_references():
    want, got = _both(_predictions)
    assert want["overlap"]["action"] == "enable_overlap" and want["moot"] == [None, None]
    assert want["burst"]["knob"] == {"transport": "burst"}
    assert got == want


# -------------------------------------------------------------- diagnosis


@pytest.mark.parametrize("link,mode", LINKS_MODES)
def test_live_diagnosis_is_the_references(link, mode):
    def diagnosed(p):
        d = p.obs.diagnose_report(_run(p, link, mode))
        return d.to_dict(), d.render()
    want, got = _both(diagnosed)
    if (link, mode) == ("pcie", "serialized"):
        assert want[0]["regime"]["label"] == "config_bound" and "enable_overlap" in want[1]
    assert got == want


def test_classify_is_the_references():
    cases = [dict(makespan=100.0, exposed_config=20.0, config_cycles=20.0, host_busy=30.0,
                  wire_busy=10.0, compute_busy=40.0),
             dict(makespan=100.0, exposed_config=12.0, config_cycles=40.0, host_busy=60.0,
                  wire_busy=30.0, compute_busy=95.0),
             dict(makespan=100.0, exposed_config=2.0, config_cycles=80.0, host_busy=20.0,
                  wire_busy=80.0, compute_busy=60.0),
             dict(makespan=100.0, exposed_config=2.0, config_cycles=10.0, host_busy=20.0,
                  wire_busy=30.0, compute_busy=90.0)]
    cell = {"makespan": 1000.0, "exposed_config_cycles": 400.0, "config_cycles": 500.0,
            "host_busy": 600.0, "wire_busy": 300.0, "compute_busy": 550.0}

    def classified(p):
        return [p.obs.classify(**c).to_dict() for c in cases] + [
            p.obs.classify_cell(cell).to_dict()]
    want, got = _both(classified)
    assert [r["label"] for r in want] == ["arrival_limited", "config_bound", "wire_bound",
                                          "compute_bound", "config_bound"]
    assert got == want


def _diffs(p):
    ser = p.obs.attribute(_run(p, "noc", "serialized")).check().to_dict()
    ov = p.obs.attribute(_run(p, "noc", "overlapped")).check().to_dict()
    base = {"makespan": 100.0, "exposed_config": 10.0, "summary": {"compute": 50.0},
            "lanes": {"cfg[noc]": {"kind": "wire", "components": {"exposed_transfer": 10.0}},
                      "compute[d0]": {"kind": "compute", "components": {"busy": 50.0}}}}
    other = {"makespan": 110.0, "exposed_config": 12.0, "summary": {"compute": 55.0},
             "lanes": {"cfg[noc2]": {"kind": "wire", "components": {"exposed_transfer": 12.0}},
                       "compute[d0]": {"kind": "compute", "components": {"busy": 40.0}},
                       "compute[d1]": {"kind": "compute", "components": {"busy": 15.0}}}}
    out = []
    for a, b in ((ser, ov), (ov, ser), (base, other)):
        d = p.obs_diff.diff(a, b)
        out.append((d, p.obs_diff.render(d), p.obs_diff.render(d, top=2)))
    return out


def test_diff_is_the_references():
    want, got = _both(_diffs)
    assert want[0][0]["makespan"]["delta"] < 0.0
    assert want[2][0]["lanes"]["cfg[noc2]"]["status"] == "renamed"
    assert got == want


# ------------------------------------------------------------ doctor CLI


def _doctor(p, tmp, capsys) -> tuple:
    paths = {}
    for name, link, mode in (("ser", "pcie", "serialized"), ("ov", "pcie", "overlapped")):
        tracer = p.obs.Tracer()
        rep = _run(p, link, mode, tracer=tracer)
        paths[name] = tmp / f"{name}.json"
        p.obs.write_trace(tracer, str(paths[name]), attribution=p.obs.attribute(rep).check(),
                          metrics=rep.metrics)
    capsys.readouterr()
    rc_alone = p.obs_doctor.main([str(paths["ser"])])
    alone = capsys.readouterr().out
    out = tmp / "doctor.json"
    rc = p.obs_doctor.main([str(paths["ser"]), "--against", str(paths["ov"]), "--json", str(out)])
    shown = capsys.readouterr()
    return rc_alone, alone, rc, shown.out, json.loads(out.read_text()), \
        shown.err.replace(str(tmp), "TMP")


def test_doctor_cli_transcript_and_json_are_the_references(tmp_path, capsys):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _doctor(pkg("jax"), tmp_path / "jax", capsys)
    got = _doctor(pkg("port"), tmp_path / "port", capsys)
    assert want[0] == want[2] == 0
    assert "config-wall doctor" in want[3] and "trace diff" in want[3]
    assert want[4]["diagnosis"]["regime"]["label"] == "config_bound"
    assert want[4]["diff"]["makespan"]["delta"] > 0.0
    assert got == want


def test_doctor_cli_names_the_ports_module(capsys):
    with pytest.raises(SystemExit):
        pkg("port").obs_doctor.main(["--help"])
    assert "usage: python -m repro_torch.obs.doctor" in capsys.readouterr().out


def test_doctor_cli_rejects_attribution_free_documents(tmp_path):
    bare = tmp_path / "bare.json"
    bare.write_text(json.dumps({"traceEvents": []}))
    with pytest.raises(AssertionError):
        pkg("port").obs_doctor.load_trace(str(bare))


# ------------------------------------------------------- closed-loop bridge


@pytest.fixture(scope="module")
def pair():
    from _torch_port import reduced_pair

    return reduced_pair(0)


def _tenants(side: str, pair) -> list:
    """``tests/test_obs.py``'s two bridged tenants on one package's engines,
    over the same parameters."""
    p = pkg(side)
    model, params = pair[1:3] if side == "jax" else pair[3:5]
    decode = p.serving.ServingEngine.compile_decode(model)
    tenants = []
    for i in range(2):
        eng = p.serving.ServingEngine(model, params, max_slots=4, max_len=64, decode_fn=decode)
        eng.submit(p.serving.Request(uid=0, prompt=[3 + i, 5], max_new_tokens=3))
        tenants.append(p.bridge.TenantEngine(f"t{i}", eng, accel="opengemm", slo_cycles=2_000.0))
    return tenants


def _traced_bridge(p, tenants, tmp, overlap: str) -> dict:
    """``tests/test_obs.py``'s traced bridge scenario."""
    tracer = p.obs.Tracer()
    cluster = p.cluster.Cluster.uniform(1, {"opengemm": 1}, sticky=True, link="noc",
                                        overlap=overlap, tracer=tracer)
    rep = p.bridge.ClosedLoopDriver(tenants, cluster).run()
    att = p.obs.attribute(rep).check(tolerance=1e-9)
    path = tmp / f"{overlap}.json"
    doc = p.obs.write_trace(tracer, str(path), attribution=att, metrics=rep.metrics)
    diag = p.obs.diagnose_report(rep)
    return {"doc": json.loads(path.read_text()), "written": doc == json.loads(path.read_text()),
            "exposed": (att.exposed_config, rep.cluster.exposed_config_cycles),
            "diagnosis": diag.to_dict(), "render": diag.render(),
            "from_doc": p.obs_diagnose.diagnose_doc(doc).to_dict(),
            "tokens": rep.tokens, "lanes": tracer.lanes()}


@pytest.mark.parametrize("overlap", ["serialized", "overlapped"])
def test_traced_bridge_run_exports_the_references_document(pair, tmp_path, overlap):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    want = _traced_bridge(pkg("jax"), _tenants("jax", pair), tmp_path / "jax", overlap)
    got = _traced_bridge(pkg("port"), _tenants("port", pair), tmp_path / "port", overlap)
    assert want["tokens"] == 6 and want["written"]
    assert want["exposed"][0] == want["exposed"][1]
    assert any(lane.startswith("step[") for lane in want["lanes"])
    assert want["diagnosis"]["regime"]["label"] == want["from_doc"]["regime"]["label"]
    assert got == want


# ------------------------------------------------------ shed and migration


def _shed_bursty(p):
    """``tests/test_doctor.py``'s shed pin: a bursty two-host run landing on
    h0 of an affinity cluster, observed every 50 launches."""
    profiles = [p.cluster.TenantProfile("tight", dims=(16, 16, 16), accel="opengemm", weight=1.0),
                p.cluster.TenantProfile("loose", dims=(16, 16, 16), accel="opengemm", weight=2.0)]
    reqs = p.cluster.generate(profiles, rate=1 / 8, horizon=40_000, process="bursty", seed=5)
    reqs = sorted(reqs, key=lambda r: r.arrival_time)[:400]
    cluster = p.cluster.Cluster.uniform(2, {"opengemm": 1}, policy="affinity", link="noc")
    monitor = p.obs.StreamMonitor(window=5_000.0)
    trig = p.cluster.ShedTrigger(p.fabric.MigrationPlanner(link="noc"), k=1.5, sustain=2,
                                 monitor=monitor)
    for i, req in enumerate(reqs):
        cluster.hosts[0].dispatch(req)
        if (i + 1) % 50 == 0:
            trig.observe(cluster.hosts, now=req.arrival_time)
    return plain(trig.decisions), plain(monitor.series("cluster.port_wait", host="h0"))


def _big_req(p, tenant, i, n_static=32):
    extra = {f"w{j}": 7 * j for j in range(n_static)}
    extra["A"] = 0x1000 + 64 * i
    return p.sched.LaunchRequest(tenant, (8, 16, 16), extra, accel="gemmini")


def _shed_skewed(p):
    """``tests/test_engine.py``'s skewed hosts: one hot host sheds twice,
    the slot context moving with the tenant; then four hosts, two hot."""
    h0, h1 = (p.cluster.Host.from_registry(f"h{i}", {"gemmini": 1, "opengemm": 1}, link="noc")
              for i in range(2))
    for i in range(8):
        h0.dispatch(_big_req(p, "hot", i))
        h0.dispatch(_big_req(p, "side", i, n_static=4))
    h0.adopt_context("hot")
    trig = p.cluster.ShedTrigger(p.fabric.MigrationPlanner(link="noc"), k=1.5, sustain=1)
    first, second = trig.observe([h0, h1], now=0.0), trig.observe([h0, h1], now=0.0)
    hosts = [p.cluster.Host.from_registry(f"h{i}", {"gemmini": 1, "opengemm": 1}, link="noc")
             for i in range(4)]
    for i in range(8):
        hosts[0].dispatch(_big_req(p, "a", i))
        hosts[1].dispatch(_big_req(p, "b", i))
    many = p.cluster.ShedTrigger(p.fabric.MigrationPlanner(link="noc"), k=1.2,
                                 sustain=1).observe(hosts, now=0.0)
    return plain(first), plain(second), plain(many), h1.hosts_context("hot")


@pytest.mark.parametrize("scenario", [_shed_bursty, _shed_skewed], ids=["bursty", "skewed"])
def test_shed_decisions_are_the_references(scenario):
    want, got = _both(scenario)
    assert want[0]
    assert got == want


def _migrations(p):
    """``tests/test_fabric.py``'s warm, cold and contended migrations and
    the snapshot wire format."""
    def warm_host(host_id, tenant, link):
        host = p.cluster.Host.from_registry(host_id, {"gemmini": 1, "opengemm": 1}, link=link)
        for i in range(3):
            host.dispatch(_big_req(p, tenant, i))
        return host

    out = []
    for link in ("noc", "pcie"):
        src = warm_host("src", "t0", link)
        for i in range(3):
            src.dispatch(_big_req(p, "t1", 0x100 + i))
        dst = p.cluster.Host.from_registry("dst", {"gemmini": 1, "opengemm": 1}, link=link)
        planner = p.fabric.MigrationPlanner(link=link)
        probe = _big_req(p, "t0", 0x40)
        out.append(plain(planner.estimate("t0", src, dst, probe)))
        out.append(plain(planner.estimate("ghost", src, dst, probe)))
        snaps = p.fabric.capture_contexts(src)
        out.append([s.to_bytes() for s in snaps])
        out.append([p.fabric.ship_cycles(s, p.fabric.resolve_link(link)) for s in snaps])
        out.append(plain(planner.migrate("t0", src, dst, probe, now=100.0)))
        out.append(plain(planner.migrate("t1", src, dst, _big_req(p, "t1", 0x140), now=0.0)))
        out.append(plain(p.fabric.MigrationPlanner(link=link, policy="cold").migrate(
            "t1", dst, src, _big_req(p, "t1", 0x180))))
    snap = p.fabric.ContextSnapshot("t0", "gemmini", 8, {"M": 8, "A": 0x1000})
    out.append((snap.to_bytes(), p.fabric.delta_fields(snap, {"M": 8, "A": 0x1040, "B": 1})))
    return out


def test_migrations_and_snapshots_are_the_references():
    want, got = _both(_migrations)
    assert want[0]["mode"] == "warm" and want[2]
    assert got == want


# --------------------------------------------------------------- power cap


def _cap_requests(p, n=40):
    return [p.sched.LaunchRequest(f"t{i % 4}", (8, 16, 16),
                                  {f"p{j}": i * 64 + j for j in range(8)},
                                  accel="opengemm" if i % 2 else "gemmini",
                                  arrival_time=12.0 * i) for i in range(n)]


def _capped(p, n: int, trigger: bool):
    """``tests/test_power.py``'s cap at 60 % of the uncapped peak window,
    with or without the shedding trigger."""
    window = 1024.0

    def cluster():
        return p.cluster.Cluster.uniform(2, {"opengemm": 1, "gemmini": 1}, link="noc",
                                         power=p.power.PowerSpec.default())
    probe = cluster()
    probe.run(_cap_requests(p, n))
    peak, _ = p.power.max_window_energy(probe.hosts, window)
    budget = 0.6 * peak / window
    mon = p.obs.StreamMonitor(window=window)
    trig = p.cluster_powercap.PowerCapTrigger(
        p.fabric.MigrationPlanner(link="noc", policy="warm"), budget_power=budget,
        window=window, monitor=mon) if trigger else None
    cl = cluster()
    rep, cap = p.cluster_powercap.run_power_capped(cl, _cap_requests(p, n), budget_power=budget,
                                                   window=window, trigger=trig)
    bound = p.cluster_powercap.request_energy_bound(cl.hosts[0], _cap_requests(p, 1)[0])
    return {"cap": cap.to_dict(), "plain": plain(cap), "makespan": rep.makespan,
            "launches": rep.launches, "records": plain(rep.records), "bound": bound,
            "draw": mon.power_draw(max(h.clock for h in cl.hosts))}


@pytest.mark.parametrize("n,trigger", [(40, False), (60, True)])
def test_power_cap_is_the_references(n, trigger):
    want, got = _both(_capped, n, trigger)
    assert want["cap"]["held"] and want["cap"]["delayed"] > 0
    assert got == want


# ---------------------------------------------------------------- autotune


def _tuned(p):
    from repro.engine.costmodel import CALIBRATION_PATH as REFERENCE_FITS

    og, gem = p.core_accelerators.REGISTRY["opengemm"], p.core_accelerators.REGISTRY["gemmini"]
    out = [plain(p.engine.tune_from_ratio(w, c, can_hide=h))
           for w, c, h in ((0.0, 100.0, False), (500.0, 100.0, False), (80.0, 100.0, True),
                           (500.0, 100.0, True), (5000.0, 100.0, True))]
    for cm in (None, p.engine.ComputeModel.calibrated(REFERENCE_FITS)):
        for model in (og, gem):
            for link in ("csr", "noc", "pcie"):
                for dims in ((8, 8, 8), (16, 16, 16), (64, 64, 64)):
                    k = p.engine.tune(model, link, dims, 48, compute_model=cm)
                    out.append((plain(k), k.scheduler_kwargs()))
    return out


def test_autotune_is_the_references():
    want, got = _both(_tuned)
    assert {row[0]["overlap"] for row in want[5:]} == {"serialized", "overlapped"}
    assert got == want
