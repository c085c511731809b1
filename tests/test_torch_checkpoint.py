"""The port's checkpoint store and supervisor against the JAX package's,
on the CPU.

The store writes the reference's on-disk format: a checkpoint written by
either package restores in the other bit for bit (bf16, int32 and a
``(params, opt_state)`` tuple included), and for the same tree the port
writes the reference's bytes, file for file. The reference's checkpoint
and substrate tests have counterparts here: CRC rejection on restore,
async save and gc, ``keys``, placement on a device, the supervisor's
replay and the straggler monitor. ``fabric.ContextStore`` persists its
numpy ``uint8`` snapshots through the port's store in the same format,
across the packages in both directions. The supervisor replays exactly after a
fault that follows a checkpoint, and, the port's choice, after one that
comes before the first checkpoint, where the reference replays on the
state it had already advanced (pinned here too).
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import reduced_pair, to_torch
from repro.checkpoint import CheckpointStore as JaxStore
from repro.data import SyntheticLMDataset
from repro.optim import AdamW as JaxAdamW
from repro.runtime import TrainSupervisor as JaxSupervisor
from repro_torch.checkpoint import CheckpointStore
from repro_torch.launch.steps import build_train_step
from repro_torch.optim import AdamW
from repro_torch.runtime import StragglerMonitor, TrainSupervisor
from repro_torch.tree import leaves


def _tree():
    return {
        "w": torch.arange(12, dtype=torch.float32).reshape(3, 4),
        "opt": {"m": torch.ones((5,), dtype=torch.bfloat16)},
    }


def _assert_bits_equal(a, b) -> None:
    """Two trees of tensors with the same keys, dtypes, shapes and bytes."""
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))


# ------------------------------------------------------- the store itself


def test_checkpoint_roundtrip(tmp_path):
    store = CheckpointStore(str(tmp_path))
    tree = {"a": torch.arange(6, dtype=torch.int32).reshape(2, 3),
            "b": {"c": torch.ones((4,), dtype=torch.bfloat16)}, "s": torch.tensor(7)}
    store.save(10, tree)
    assert store.latest_step() == 10
    out = store.restore(10, tree)
    _assert_bits_equal(out, tree)
    assert out["b"]["c"].dtype == torch.bfloat16 and out["s"].shape == ()


def test_checkpoint_async_and_gc(tmp_path):
    store = CheckpointStore(str(tmp_path), keep=2)
    tree = {"x": torch.zeros((8,))}
    for s in (1, 2, 3, 4):
        store.save(s, tree, blocking=False)
        store.wait()
    assert store.steps() == [3, 4]
    assert not [n for n in os.listdir(tmp_path) if n.endswith(".tmp")]


def test_async_save_takes_its_copies_before_the_writer_starts(tmp_path):
    """A tensor changed in place right after an async save is written as it
    was when ``save`` was called."""
    store = CheckpointStore(str(tmp_path))
    tree = {"x": torch.arange(1 << 16, dtype=torch.float32)}
    want = tree["x"].clone()
    store.save(1, tree, blocking=False)
    tree["x"].add_(1.0)
    store.wait()
    assert torch.equal(store.restore(1, tree)["x"], want)


@pytest.mark.parametrize("where", ["first", "last"])
def test_restore_rejects_a_corrupted_leaf_with_crc(tmp_path, where):
    """Flipping bytes at the end of any one array file fails the whole
    restore; the manifest is untouched, so keys still enumerate."""
    store = CheckpointStore(str(tmp_path))
    tree = _tree()
    store.save(7, tree)
    step_dir = os.path.join(str(tmp_path), "step_7")
    files = sorted(f for f in os.listdir(step_dir) if f.endswith(".npy"))
    with open(os.path.join(step_dir, files[0 if where == "first" else -1]), "r+b") as f:
        f.seek(-4, 2)
        f.write(b"\xde\xad\xbe\xef")
    with pytest.raises(IOError, match="CRC mismatch"):
        store.restore(7, tree)
    assert store.keys(7) == ["opt/m", "w"]


def test_keys_lists_manifest_leaves(tmp_path):
    store = CheckpointStore(str(tmp_path))
    store.save(2, {"b": torch.zeros((2,)), "a": {"x": torch.ones((1,))}})
    assert store.keys(2) == ["a/x", "b"]
    store.save(3, (torch.zeros(1), {"step": torch.tensor(1, dtype=torch.int32)}))
    assert store.keys(3) == ["[0]", "[1]/step"]


def test_restore_places_each_leaf_on_its_device(tmp_path):
    """Each leaf goes to the device named for it in ``devices`` (the
    one-device counterpart of the reference's shardings); a leaf named
    ``None`` or not named stays on its like leaf's device."""
    store = CheckpointStore(str(tmp_path))
    tree = _tree()
    store.save(3, tree)
    out = store.restore(3, tree, devices={"w": torch.device("meta"), "opt": {"m": None}})
    assert out["w"].device.type == "meta" and out["w"].shape == (3, 4)
    assert out["opt"]["m"].device.type == "cpu"
    assert torch.equal(out["opt"]["m"], tree["opt"]["m"])
    moved = TrainSupervisor.reshard(tree, {"w": "meta", "opt": {"m": "cpu"}})
    assert moved["w"].device.type == "meta" and moved["opt"]["m"].device.type == "cpu"


# ------------------------------------------------------------ interchange


@pytest.fixture(scope="module")
def state_pair():
    """A (params, opt_state) state of reduced phi-3.5-MoE in both packages,
    after one JAX update so no leaf is trivial: bf16 weights, f32 router,
    norms, master, m and v, and an int32 step."""
    cfg, jmodel, jparams, _, _ = reduced_pair(0, "phi3.5-moe-42b-a6.6b")
    opt = JaxAdamW()
    batch = SyntheticLMDataset(cfg.vocab_size, 8, 2, seed=5).batch(0)
    grads = jax.jit(jax.grad(lambda p: jmodel.loss(p, batch)[0]))(jparams)
    jparams, jopt, _ = jax.jit(opt.update)(jparams, grads, opt.init(jparams))
    jstate = (jparams, jopt)
    return jstate, jax.tree.map(to_torch, jstate)


def test_a_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path, state_pair):
    jstate, tstate = state_pair
    JaxStore(str(tmp_path)).save(4, jstate)
    store = CheckpointStore(str(tmp_path))
    assert store.latest_step() == 4
    assert "[0]/embed" in store.keys(4) and "[1]/master/embed" in store.keys(4)
    zeros = jax.tree.map(torch.zeros_like, tstate)
    out = store.restore(4, zeros)
    _assert_bits_equal(out, tstate)
    assert out[1]["step"].dtype == torch.int32 and int(out[1]["step"]) == 1
    assert out[0]["layers"]["moe"]["router"].dtype == torch.float32
    assert out[0]["embed"].dtype == torch.bfloat16


def test_a_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path, state_pair):
    jstate, tstate = state_pair
    CheckpointStore(str(tmp_path)).save(5, tstate)
    out = JaxStore(str(tmp_path)).restore(5, jax.tree.map(jnp.zeros_like, jstate))
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(jstate)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(np.asarray(a).reshape(-1).view(np.uint8),
                                      np.asarray(b).reshape(-1).view(np.uint8))


def test_the_port_writes_the_references_bytes(tmp_path, state_pair):
    """For the same state both packages write the same files, byte for
    byte: the manifest and every ``.npy``."""
    jstate, tstate = state_pair
    JaxStore(str(tmp_path / "jax")).save(1, jstate)
    CheckpointStore(str(tmp_path / "port")).save(1, tstate)
    jdir, tdir = tmp_path / "jax" / "step_1", tmp_path / "port" / "step_1"
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == len(jax.tree.leaves(jstate)) + 1
    for name in names:
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name


def test_numpy_leaves_save_in_the_references_bytes_and_restore_on_the_host(tmp_path):
    """A tree of numpy arrays saves as the reference's store saves it, byte
    for byte; restored into numpy templates it comes back as numpy arrays,
    into tensor templates as tensors."""
    tree = {"ctx": {"t0": np.frombuffer(b"\x01\x02\x03\xff", np.uint8).copy(),
                    "t1": np.arange(6, dtype=np.int32).reshape(2, 3)}}
    JaxStore(str(tmp_path / "jax")).save(3, tree)
    CheckpointStore(str(tmp_path / "port")).save(3, tree)
    jdir, tdir = tmp_path / "jax" / "step_3", tmp_path / "port" / "step_3"
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == 3
    for name in names:
        assert (jdir / name).read_bytes() == (tdir / name).read_bytes(), name
    store = CheckpointStore(str(tmp_path / "jax"))
    like = {"ctx": {"t0": np.zeros(0, np.uint8), "t1": np.zeros(0, np.int32)}}
    out = store.restore(3, like)
    for key in ("t0", "t1"):
        assert isinstance(out["ctx"][key], np.ndarray)
        np.testing.assert_array_equal(out["ctx"][key], tree["ctx"][key])
    as_tensors = store.restore(3, {"ctx": {"t0": torch.zeros(0, dtype=torch.uint8),
                                           "t1": torch.zeros(0, dtype=torch.int32)}})
    assert torch.equal(as_tensors["ctx"]["t1"], torch.from_numpy(tree["ctx"]["t1"]))


def _warm_host(cluster, fabric_req, tenant: str, n_static: int = 32):
    """A host whose gemmini device holds ``tenant``'s big context, as
    ``tests/test_fabric.py`` warms one."""
    host = cluster.Host.from_registry("h0", {"gemmini": 1, "opengemm": 1}, link="noc")
    for i in range(3):
        extra = {f"w{j}": 7 * j for j in range(n_static)}
        extra["A"] = 0x1000 + 64 * i
        host.dispatch(fabric_req(tenant, (8, 16, 16), extra, accel="gemmini"))
    return host


def _snapshots(side: str) -> list:
    if side == "jax":
        import repro.cluster as cluster
        from repro.fabric import capture_contexts
        from repro.sched import LaunchRequest
    else:
        import repro_torch.cluster as cluster
        from repro_torch.fabric import capture_contexts
        from repro_torch.sched import LaunchRequest
    snaps = []
    for tenant in ("t0", "t1"):
        snaps += capture_contexts(_warm_host(cluster, LaunchRequest, tenant))
    return snaps


def test_context_store_roundtrips_through_the_ports_store(tmp_path):
    """``fabric.ContextStore`` persists through the port's store, and a
    fresh host restored from it dispatches warm."""
    import repro_torch.cluster as cluster
    from repro_torch.fabric import ContextStore, install_contexts
    from repro_torch.sched import LaunchRequest

    snaps = _snapshots("port")
    assert [s.tenant for s in snaps] == ["t0", "t1"]
    ContextStore(str(tmp_path)).save(1, snaps)
    restored = ContextStore(str(tmp_path)).restore()
    assert restored == {s.tenant: s for s in snaps}
    assert ContextStore(str(tmp_path / "empty")).restore() == {}
    host = cluster.Host.from_registry("h0", {"gemmini": 1, "opengemm": 1}, link="noc")
    assert install_contexts(host, [restored["t0"]]) == 1
    extra = {f"w{j}": 7 * j for j in range(32)}
    extra["A"] = 0x2000
    host.dispatch(LaunchRequest("t0", (8, 16, 16), extra, accel="gemmini"))
    gem = host.sched.devices[0]
    assert gem.cache.stats.hits == 1 and gem.cache.stats.misses == 0


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_a_context_saved_by_one_package_restores_in_the_other(tmp_path, writer, reader):
    """Contexts saved by either package's ``ContextStore`` restore through
    the other's to the same snapshots (compared as their CRC-guarded wire
    bytes), and both write the same files for the same contexts."""
    from repro.fabric import ContextStore as JaxContextStore
    from repro_torch.fabric import ContextStore as PortContextStore

    stores = {"jax": JaxContextStore, "port": PortContextStore}
    snaps = _snapshots(writer)
    stores[writer](str(tmp_path / writer)).save(2, snaps)
    restored = stores[reader](str(tmp_path / writer)).restore()
    assert {t: s.to_bytes() for t, s in restored.items()} == \
        {s.tenant: s.to_bytes() for s in snaps}
    assert type(restored["t0"]).__module__.startswith("repro_torch" if reader == "port" else "repro.")
    stores[reader](str(tmp_path / reader)).save(2, _snapshots(reader))
    names = sorted(os.listdir(tmp_path / writer / "step_2"))
    assert names == sorted(os.listdir(tmp_path / reader / "step_2")) and len(names) == 3
    for name in names:
        assert (tmp_path / writer / "step_2" / name).read_bytes() == \
            (tmp_path / reader / "step_2" / name).read_bytes(), name


# ------------------------------------------------------------- supervisor


class _Faults:
    """Raises once at each of ``steps``, as a lost node would."""

    def __init__(self, *steps: int):
        self.armed = set(steps)

    def __call__(self, step: int) -> None:
        if step in self.armed:
            self.armed.discard(step)
            raise RuntimeError(f"simulated node failure at step {step}")


def _train_pair():
    """(step_fn, state, batch_fn) of reduced qwen2-0.5b cut to 2 layers: the
    port's train step over the reference's data."""
    cfg, _, _, tmodel, tparams = reduced_pair(0, "qwen2-0.5b")
    tmodel = type(tmodel)(dataclasses.replace(tmodel.cfg, n_layers=2), device="cpu")
    opt = AdamW()
    step = build_train_step(tmodel, opt)
    ds = SyntheticLMDataset(cfg.vocab_size, 16, 2, seed=3)

    def step_fn(state, batch):
        return step(*state, batch)[:2]

    def batch_fn(i):
        return {k: torch.from_numpy(v) for k, v in ds.batch(i).items()}

    return step_fn, (tparams, opt.init(tparams)), batch_fn


@pytest.mark.parametrize("faults", [(7,), (2,), (2, 6)],
                         ids=["after a checkpoint", "before the first checkpoint", "both"])
def test_supervisor_replay_reproduces_training_bit_for_bit(tmp_path, faults):
    """Ten train steps straight, and under the supervisor (checkpoints every
    4) with a fault after the first checkpoint, before it, or both: the
    final parameters and optimizer state are equal bit for bit, and the
    state ``run`` was given is left as it was."""
    step_fn, state0, batch_fn = _train_pair()
    kept = [x.clone() for x in leaves(state0)]
    state = state0
    for i in range(10):
        state = step_fn(state, batch_fn(i))
    sup = TrainSupervisor(step_fn, CheckpointStore(str(tmp_path)), ckpt_every=4)
    recovered = sup.run(state0, batch_fn, 10, fault_hook=_Faults(*faults))
    assert sup.restarts == len(faults)
    _assert_bits_equal(recovered, state)
    assert all(torch.equal(a, b) for a, b in zip(kept, leaves(state0)))
    assert CheckpointStore(str(tmp_path)).steps() == [4, 8, 10]


def test_supervisor_resumes_from_the_latest_checkpoint(tmp_path):
    """A second ``run`` over a directory that holds steps 4, 8 and 10 starts
    from step 10 and returns the restored state."""
    step_fn, state0, batch_fn = _train_pair()
    first = TrainSupervisor(step_fn, CheckpointStore(str(tmp_path)), ckpt_every=4)
    done = first.run(state0, batch_fn, 10)
    calls = []
    again = TrainSupervisor(lambda s, b: calls.append(1) or step_fn(s, b),
                            CheckpointStore(str(tmp_path)), ckpt_every=4)
    _assert_bits_equal(again.run(state0, batch_fn, 10), done)
    assert not calls


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    def always(step: int) -> None:
        if step == 1:
            raise RuntimeError("simulated node failure at step 1")

    sup = TrainSupervisor(lambda s, b: s + b, CheckpointStore(str(tmp_path)), ckpt_every=2,
                          max_restarts=2)
    with pytest.raises(RuntimeError, match="step 1"):
        sup.run(torch.zeros(()), lambda i: torch.ones(()), 4, fault_hook=always)
    assert sup.restarts == 3


def test_the_reference_replays_on_an_advanced_state(tmp_path):
    """``w += i + 1`` over 6 steps gives 21. Under the reference's
    supervisor (checkpoints every 4) a fault at step 2, before the first
    checkpoint, replays steps 0-1 on the state that already took them: 24.
    The port's supervisor replays from the state ``run`` was given: 21."""
    def jstep(w, i):
        return w + i + 1

    jsup = JaxSupervisor(jstep, JaxStore(str(tmp_path / "jax")), ckpt_every=4)
    jw = jsup.run(jnp.zeros((), jnp.int32), lambda i: jnp.int32(i), 6, fault_hook=_Faults(2))
    tsup = TrainSupervisor(jstep, CheckpointStore(str(tmp_path / "port")), ckpt_every=4)
    tw = tsup.run(torch.zeros((), dtype=torch.int32), lambda i: torch.tensor(i, dtype=torch.int32),
                  6, fault_hook=_Faults(2))
    assert jsup.restarts == tsup.restarts == 1
    assert int(jw) == 24
    assert int(tw) == 21


def test_straggler_monitor_flags_outliers():
    mon = StragglerMonitor(factor=3.0)
    for i in range(10):
        mon.observe(i, 0.01)
    assert not mon.flagged
    mon.observe(10, 0.5)
    assert len(mon.flagged) == 1 and mon.flagged[0][0] == 10
