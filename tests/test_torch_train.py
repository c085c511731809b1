"""The port's training path against the JAX package's, on the CPU: the
loss and its gradients, one train step of each family, the cosine
schedule and AdamW, a short run, the bf16 gradient compression, the data
pipeline's copy and the training driver.

Parameters are the JAX ``Model.init`` tree carried across bit for bit
(``tests/_torch_port.py``); batches come from the reference's synthetic
stream. The reference's gradients are taken jitted at
``xla_allow_excess_precision=False`` (``EXACT``), so its bf16 ops round
as written, as the port's do (``tests/test_torch_ssm.py`` says why).
Tolerances, each stated where it is used:

* loss and its parts: relative 2e-3 (a bf16 product rounds apart in about
  one element in 2,000 between the frameworks, and the logits are bf16);
* each gradient leaf: relative L2 ≤ 2e-2 (bf16 gradients rounded apart
  through the backward; the leaves fall 0.3-0.8 % apart). The embedding's
  row of a token sums one bf16 term a position it holds, in another order
  in each framework, yet the rows of the frequent tokens (31-33 terms)
  fall closer (0.6-0.7 %) than those of tokens seen once (up to 2 %): the
  gap is the upstream roundings, which a sum of many terms averages;
* AdamW fed the same gradients, whose sums are exact: grad_norm, m and v
  bit for bit, lr within 4 f32 ulp (a float32 ``cos``), the master within
  4 ulp of itself or of an update (PyTorch's CPU ``sqrt``), and the bf16
  parameters equal except where the two masters round to neighbouring
  bf16 values.
"""

from __future__ import annotations

import ast
import dataclasses
import re
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import reduced_pair, to_torch
from repro.data import SyntheticLMDataset as JaxDataset
from repro.data import make_train_iterator as jax_iterator
from repro.launch.steps import build_train_step as jax_build_train_step
from repro.models.model import Model as JaxModel
from repro.optim import AdamW as JaxAdamW
from repro.optim import CosineSchedule as JaxSchedule
from repro_torch.configs import get as torch_get
from repro_torch.data import SyntheticLMDataset, make_train_iterator
from repro_torch.launch import train as train_driver
from repro_torch.launch.steps import build_train_step
from repro_torch.models.model import Model as TorchModel
from repro_torch.optim import AdamW, CosineSchedule
from repro_torch.tree import leaves, unflatten
from torch.utils._python_dispatch import TorchDispatchMode

EXACT = {"xla_allow_excess_precision": False}
SRC = Path(__file__).resolve().parents[1] / "src"
LOSS_RTOL = 2e-3
GRAD_REL_L2 = 2e-2
ULPS = 4


def _batch(cfg, b: int = 4, s: int = 32, seed: int = 1, step: int = 0) -> dict:
    """A numpy batch of the reference's stream, with the reference driver's
    zero front-end embeddings for vlm and encdec."""
    batch = JaxDataset(cfg.vocab_size, s, b, seed=seed).batch(step)
    batch.update(train_driver.frontend(cfg, b))
    return batch


def _to_torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rel_l2(a, b) -> float:
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(a), 1e-30))


def _jax_grads(jmodel, jparams, batch):
    f = jax.jit(jax.value_and_grad(jmodel.loss, has_aux=True), compiler_options=EXACT)
    return f(jparams, batch)


def _torch_grads(tmodel, tparams, batch):
    flat = [p.detach().requires_grad_() for p in leaves(tparams)]
    loss, parts = tmodel.loss(unflatten(tparams, flat), _to_torch_batch(batch))
    return loss, parts, torch.autograd.grad(loss, flat)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """How many float32 steps lie between ``a`` and ``b``, elementwise."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, np.int64(-2**31) - ia, ia)  # order negatives below positives
    ib = np.where(ib < 0, np.int64(-2**31) - ib, ib)
    return np.abs(ia - ib)


# ----------------------------------------------------------- loss and grads


def test_loss_and_gradients_match_jax():
    """Reduced paper-lm-100m, B = 4, S = 32: the loss and its parts within
    relative 2e-3 of JAX's, every gradient leaf within relative L2 2e-2,
    each embedding row of a token seen five times or more too (the rows of
    the most frequent tokens closer than a token seen once, typically),
    and the global gradient norm within 1e-2."""
    cfg, jmodel, jparams, tmodel, tparams = reduced_pair(0, "paper-lm-100m")
    batch = _batch(cfg)
    (jloss, jparts), jgrads = _jax_grads(jmodel, jparams, batch)
    tloss, tparts, tgrads = _torch_grads(tmodel, tparams, batch)
    np.testing.assert_allclose(float(tloss.detach()), float(jloss), rtol=LOSS_RTOL)
    for k in ("ce", "zloss", "moe_aux"):
        np.testing.assert_allclose(float(tparts[k].detach()), float(jparts[k]), rtol=LOSS_RTOL)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    assert len(jflat) == len(tgrads) == 12
    for (path, j), t in zip(jflat, tgrads):
        assert t.dtype == to_torch(j).dtype and tuple(t.shape) == j.shape, path
        rel = _rel_l2(j, t.float().numpy())
        assert rel <= GRAD_REL_L2, (jax.tree_util.keystr(path), rel)
    # the embedding's rows, each summed over the positions of its token
    counts = np.bincount(batch["tokens"].reshape(-1), minlength=cfg.vocab_size)
    j, t = np.asarray(jgrads["embed"], np.float32), tgrads[0].float().numpy()
    rows = np.linalg.norm(j - t, axis=1) / np.maximum(np.linalg.norm(j, axis=1), 1e-30)
    assert counts.max() >= 30 and (rows[counts >= 5] <= GRAD_REL_L2).all()
    assert rows[counts >= 30].max() <= np.median(rows[counts == 1])
    jnorm = np.sqrt(sum(np.sum(np.square(np.asarray(g, np.float32))) for g in jax.tree.leaves(jgrads)))
    tnorm = np.sqrt(sum(float(torch.sum(torch.square(g.float()))) for g in tgrads))
    np.testing.assert_allclose(tnorm, jnorm, rtol=1e-2)


def test_masked_sum_gold_logit_equals_the_gathered_one():
    """The reference's gold logit, a masked sum over the vocabulary, equals
    the port's gather bit for bit on finite logits: every other term of the
    sum is ±0."""
    rng = np.random.default_rng(0)
    logits = torch.from_numpy((rng.standard_normal((3, 7, 1000)) * 40).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 1000, (3, 7)))
    mask = (torch.arange(1000)[None, None, :] == labels[..., None]).float()
    masked = torch.sum(logits * mask, dim=-1)
    gathered = torch.take_along_dim(logits, labels[..., None], dim=-1)[..., 0]
    assert torch.equal(masked, gathered)
    jmasked = jnp.sum(jnp.asarray(logits.numpy()) * jnp.asarray(mask.numpy()), axis=-1)
    np.testing.assert_array_equal(np.asarray(jmasked), gathered.numpy())


def test_a_train_forward_splits_each_stacked_leaf_once():
    """Each stacked layer leaf reaches the loss through one ``unbind``, whose
    backward is a single ``stack``; a ``select`` a layer would build a zero
    tensor the size of the stack for every layer's gradient."""
    cfg, _, _, tmodel, tparams = reduced_pair(0, "paper-lm-100m")
    flat = [p.detach().requires_grad_() for p in leaves(tparams)]
    loss, _ = tmodel.loss(unflatten(tparams, flat), _to_torch_batch(_batch(cfg, 1, 8)))
    stacked = {id(p) for p in leaves(unflatten(tparams, flat)["layers"])}
    consumers, seen, todo = {}, set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is not None and hasattr(nxt, "variable") and id(nxt.variable) in stacked:
                consumers.setdefault(id(nxt.variable), []).append(node.name())
            todo.append(nxt)
    assert len(consumers) == len(stacked) == 9
    assert all(names == ["UnbindBackward0"] for names in consumers.values()), consumers


# -------------------------------------------------------- one step a family


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "phi3.5-moe-42b-a6.6b", "rwkv6-7b",
                                  "whisper-medium", "phi-3-vision-4.2b"])
def test_train_step_of_each_family_matches_jax(arch):
    """One train step of the reduced config (B = 2, S = 16): a finite loss
    within relative 2e-3 of JAX's on the same parameters and batch, its MoE
    aux term on its own within the same tolerance, every parameter leaf's
    dtype kept, and the parameters moved."""
    cfg, jmodel, jparams, tmodel, tparams = reduced_pair(0, arch)
    batch = _batch(cfg, 2, 16)
    (jloss, jparts), _ = _jax_grads(jmodel, jparams, batch)
    step = build_train_step(tmodel, AdamW())
    opt = AdamW().init(tparams)
    before = [p.clone() for p in leaves(tparams)]
    new_params, new_opt, metrics = step(tparams, opt, _to_torch_batch(batch))
    assert np.isfinite(float(metrics["loss"])) and np.isfinite(float(metrics["grad_norm"]))
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(metrics["moe_aux"]), float(jparts["moe_aux"]),
                               rtol=LOSS_RTOL)
    if cfg.family == "moe":
        assert float(metrics["moe_aux"]) > 0
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(tparams)))  # inputs kept
    assert [p.dtype for p in leaves(new_params)] == [p.dtype for p in before]
    assert any(not torch.equal(a, b) for a, b in zip(before, leaves(new_params)))
    assert int(new_opt["step"]) == 1 and new_opt["step"].dtype == torch.int32


def test_build_train_step_with_bf16_grad_compression_matches_jax():
    """``grad_compression="bf16"`` casts the gradients to bf16 before the
    update, the MoE router's f32 gradient included. Against the reference's
    ``build_train_step``: the loss within 2e-3 and grad_norm within 2e-2
    (bf16 gradients); the gradients the update receives, each within
    relative L2 2e-2 of the reference's cast to bf16; and the updated
    masters: the first update moves a weight by lr times the sign of its
    gradient (plus weight decay), so they agree within 0.1·lr but where a
    gradient near zero takes the other sign, there 2·lr apart, on under
    1 % of the weights."""
    cfg, jmodel, jparams, tmodel, tparams = reduced_pair(0, "phi3.5-moe-42b-a6.6b")
    cfg = dataclasses.replace(cfg, grad_compression="bf16")
    jmodel = type(jmodel)(cfg)
    tmodel = TorchModel(dataclasses.replace(tmodel.cfg, grad_compression="bf16"), device="cpu")
    batch = _batch(cfg, 2, 16)
    jstep = jax.jit(jax_build_train_step(jmodel, JaxAdamW()), compiler_options=EXACT)
    _, jopt, jmet = jstep(jparams, JaxAdamW().init(jparams), batch)
    jgrads = jax.tree.leaves(_jax_grads(jmodel, jparams, batch)[1])
    seen = []

    class Spy(AdamW):
        def update(self, params, grads, state):
            seen.extend(leaves(grads))
            return super().update(params, grads, state)

    step = build_train_step(tmodel, Spy())
    _, topt, tmet = step(tparams, AdamW().init(tparams), _to_torch_batch(batch))
    assert len(seen) == len(jgrads) == len(leaves(tparams))
    assert {g.dtype for g in seen} == {torch.bfloat16}
    assert jparams["layers"]["moe"]["router"].dtype == jnp.float32
    for j, t in zip(jgrads, seen):
        assert _rel_l2(np.asarray(j.astype(jnp.bfloat16), np.float32), t.float().numpy()) \
            <= GRAD_REL_L2
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tmet["grad_norm"]), float(jmet["grad_norm"]), rtol=2e-2)
    lr = float(jmet["lr"])
    for j, t in zip(jax.tree.leaves(jopt["master"]), leaves(topt["master"])):
        gap = np.abs(t.numpy() - np.asarray(j))
        assert gap.max() <= 2.01 * lr and np.mean(gap > 0.1 * lr) < 0.01


# ----------------------------------------------------------------- remat

REMAT_ARCHS = ["qwen2-0.5b", "phi3.5-moe-42b-a6.6b", "phi-3-vision-4.2b", "rwkv6-7b",
               "whisper-medium"]


def _port_grads(cfg, params, batch: dict, remat: str):
    """The loss and every gradient leaf of the port at ``remat``."""
    model = TorchModel(dataclasses.replace(cfg, remat=remat), device="cpu")
    return _torch_grads(model, params, batch)


@pytest.mark.parametrize("arch", REMAT_ARCHS)
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_gives_the_gradients_of_none(arch, remat):
    """Checkpointing changes memory, not numbers: on the CPU the loss, its
    parts and every gradient leaf equal ``remat="none"``'s bit for bit
    (B = 2, S = 16; the recomputed forward is the first one op for op)."""
    cfg = dataclasses.replace(torch_get(arch).reduced(), remat="none")
    params = TorchModel(cfg, device="cpu").init(0)
    batch = _batch(cfg, 2, 16)
    loss, parts, grads = _port_grads(cfg, params, batch, "none")
    rloss, rparts, rgrads = _port_grads(cfg, params, batch, remat)
    assert torch.equal(rloss, loss)
    assert all(torch.equal(rparts[k], parts[k]) for k in parts)
    assert len(rgrads) == len(grads) == len(leaves(params))
    assert all(torch.equal(a, b) for a, b in zip(rgrads, grads))


def _backward_ops(cfg, params, batch: dict, remat: str) -> Counter:
    """The aten ops the backward of the loss at ``remat`` runs, by name:
    the gradients' own, and the forward ops a checkpoint recomputes."""
    model = TorchModel(dataclasses.replace(cfg, remat=remat), device="cpu")
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss, _ = model.loss(unflatten(params, flat), batch)
    counts = Counter()

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    with Count():
        torch.autograd.grad(loss, flat)
    return counts


def test_remat_dots_keeps_the_products_outputs_and_recomputes_the_rest():
    """The reduced qwen2-0.5b: ``"dots"`` recomputes no 2-D product (its
    backward runs as many ``mm`` as ``"none"``'s, where ``"full"`` runs the
    forward's projections again, up to the last whose output the backward
    needs: six a layer, the MLP's ``wo`` feeding only the residual) and
    recomputes everything else the layers ran, as ``"full"`` does: the
    attention's ``bmm`` and softmax, the norms, the rotary embedding."""
    cfg = dataclasses.replace(torch_get("qwen2-0.5b").reduced(), remat="none")
    params = TorchModel(cfg, device="cpu").init(0)
    batch = _to_torch_batch(_batch(cfg, 2, 16))
    none, dots, full = (_backward_ops(cfg, params, batch, r) for r in ("none", "dots", "full"))
    projections = 6 * cfg.n_layers  # wq, wk, wv, wo, wi, wg a layer
    assert dots["aten.mm"] == none["aten.mm"]
    assert full["aten.mm"] == none["aten.mm"] + projections
    for op in ("aten.bmm", "aten._softmax", "aten.rsqrt", "aten.cos"):
        assert dots[op] == full[op] > none[op], op
    assert full - dots == Counter({"aten.mm": projections}) and not dots - full


def test_no_checkpoint_runs_under_no_grad(monkeypatch):
    """``remat="full"``: the forward under ``no_grad`` and a decode step run
    no checkpoint and give ``"none"``'s logits bit for bit; the same forward
    under autograd checkpoints every layer."""
    from repro_torch.models import model as TM

    calls = []
    run = TM.checkpoint

    def counted(*args, **kwargs):
        calls.append(1)
        return run(*args, **kwargs)

    monkeypatch.setattr(TM, "checkpoint", counted)
    cfg = dataclasses.replace(torch_get("qwen2-0.5b").reduced(), remat="none")
    plain, model = TorchModel(cfg, device="cpu"), TorchModel(
        dataclasses.replace(cfg, remat="full"), device="cpu")
    params = plain.init(0)
    tokens = {"tokens": torch.from_numpy(_batch(cfg, 2, 16)["tokens"])}
    with torch.no_grad():
        assert torch.equal(model.forward(params, tokens)[0], plain.forward(params, tokens)[0])
        step = [m.decode_step(params, m.init_cache(2, 4), tokens["tokens"][:, :1], 0)[0]
                for m in (model, plain)]
        assert torch.equal(*step)
    assert calls == []
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    model.forward(unflatten(params, flat), tokens)
    assert len(calls) == cfg.n_layers


def test_build_train_step_with_remat_full_matches_jax():
    """``build_train_step`` at ``remat="full"`` against the reference's
    ``remat="full"`` gradients (reduced paper-lm-100m, B = 4, S = 32), at
    ``test_loss_and_gradients_match_jax``'s tolerances: the loss within
    relative 2e-3, every gradient the update receives within relative L2
    2e-2."""
    cfg, _, jparams, tmodel, tparams = reduced_pair(0, "paper-lm-100m")
    jmodel = JaxModel(dataclasses.replace(cfg, remat="full"))
    batch = _batch(cfg)
    (jloss, _), jgrads = _jax_grads(jmodel, jparams, batch)
    seen = []

    class Spy(AdamW):
        def update(self, params, grads, state):
            seen.extend(leaves(grads))
            return super().update(params, grads, state)

    model = TorchModel(dataclasses.replace(tmodel.cfg, remat="full"), device="cpu")
    _, _, metrics = build_train_step(model, Spy())(tparams, AdamW().init(tparams),
                                                   _to_torch_batch(batch))
    np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=LOSS_RTOL)
    jflat = jax.tree.leaves(jgrads)
    assert len(seen) == len(jflat) == 12
    for j, t in zip(jflat, seen):
        assert _rel_l2(j, t.float().numpy()) <= GRAD_REL_L2


# ------------------------------------------------------------ optimizer


def test_cosine_schedule_matches_jax():
    """Steps 0-200 through warm-up, the decay and past its end, in float32:
    within 4 ulp of the reference's evaluated op by op. ``1 + cos`` near
    the end of the decay cancels, so the last-bit difference of two
    libraries' float32 ``cos`` grows there to a few ulp of the rate (the
    reference jitted lies as far from itself eagerly)."""
    steps = np.arange(0, 201, dtype=np.int32)
    for sched in ((3e-4, 20, 100), (1e-3, 2, 30), (3e-4, 100, 200)):
        j = np.asarray(JaxSchedule(*sched)(jnp.asarray(steps)))
        t = CosineSchedule(*sched)(torch.from_numpy(steps)).numpy()
        assert t.dtype == np.float32
        assert _ulps(j, t).max() <= ULPS, sched


def _exact_sum_grads(rng, params, exponent: int):
    """Gradients of integers in [-8, 8] times 2**-exponent, in each leaf's
    dtype: their squares and every partial sum of them are exact in float32
    at this size, so the global norm cannot depend on the order of the sum."""
    return jax.tree.map(
        lambda p: (rng.integers(-8, 9, p.shape) * 2.0 ** -exponent).astype(np.float32)
        .astype(p.dtype), params)


def test_adamw_matches_jax_on_the_same_gradients():
    """Ten updates of reduced paper-lm-100m's parameters fed the same
    seeded gradients, against the reference's ``update`` evaluated op by
    op. The gradients' norm runs from 0.4 to 6, so clipping is on for most
    steps, and their sums are exact (:func:`_exact_sum_grads`): grad_norm,
    step, m and v equal the reference's bit for bit; lr (a float32 cos)
    within 4 ulp and the master within 4 ulp of itself or of an update;
    each bf16 parameter equal to the reference's but where the two masters
    round to neighbouring bf16 values."""
    cfg, _, jparams, _, tparams = reduced_pair(0, "paper-lm-100m")
    sched = dict(peak_lr=1e-3, warmup_steps=3, total_steps=10)
    jopt, topt = JaxAdamW(JaxSchedule(**sched)), AdamW(CosineSchedule(**sched))
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    rng = np.random.default_rng(3)
    clipped = 0
    for exponent in (8, 9, 10, 11, 12, 9, 10, 8, 11, 10):
        grads_np = _exact_sum_grads(rng, jparams, exponent)
        jparams, jstate, jm = jopt.update(jparams, grads_np, jstate)
        tparams, tstate, tm = topt.update(
            tparams, jax.tree.map(lambda g: to_torch(g), grads_np), tstate)
        clipped += float(jm["grad_norm"]) > 1.0
        np.testing.assert_array_equal(tm["grad_norm"].numpy(), np.asarray(jm["grad_norm"]))
        assert _ulps(np.asarray(jm["lr"]), tm["lr"].numpy()).max() <= ULPS
    assert clipped >= 5
    assert int(tstate["step"]) == int(jstate["step"]) == 10
    assert tstate["step"].dtype == torch.int32
    for key in ("m", "v"):
        for j, t in zip(jax.tree.leaves(jstate[key]), leaves(tstate[key])):
            assert t.dtype == torch.float32
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    for j, t, jm, tm in zip(jax.tree.leaves(jparams), leaves(tparams),
                            jax.tree.leaves(jstate["master"]), leaves(tstate["master"])):
        assert tm.dtype == torch.float32 and t.dtype == to_torch(j).dtype
        # PyTorch's float32 sqrt on the CPU rounds ~0.7 % of inputs one ulp
        # off the IEEE result, so an update may differ by an ulp of its size
        # (about lr): the masters agree within 4 ulp of the master or of an
        # update, whichever is larger
        scale = np.maximum(np.abs(np.asarray(jm)), np.float32(sched["peak_lr"]))
        assert (np.abs(np.asarray(jm) - tm.numpy()) <= ULPS * np.spacing(scale)).all()
        differ = (to_torch(j) != t).numpy()
        assert differ.mean() < 0.01
        # each side's parameter is its own master rounded, so where they
        # differ a bf16 rounding boundary lies between the two masters
        assert torch.equal(t, tm.to(t.dtype))


def test_short_run_losses_match_jax():
    """Ten train steps of reduced paper-lm-100m (B = 4, S = 32, the
    driver's schedule at lr 1e-3), each side on its own gradients: the loss
    at every step within relative 5e-3 of the reference's (the sides drift
    apart by their rounding), and falling."""
    cfg, jmodel, jparams, tmodel, tparams = reduced_pair(0, "paper-lm-100m")
    sched = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10)
    jopt, topt = JaxAdamW(JaxSchedule(**sched)), AdamW(CosineSchedule(**sched))
    jstep = jax.jit(jax_build_train_step(jmodel, jopt), compiler_options=EXACT)
    tstep = build_train_step(tmodel, topt)
    jstate, tstate = jopt.init(jparams), topt.init(tparams)
    jl, tl = [], []
    for i in range(10):
        batch = _batch(cfg, step=i)
        jparams, jstate, jm = jstep(jparams, jstate, batch)
        tparams, tstate, tm = tstep(tparams, tstate, _to_torch_batch(batch))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
    np.testing.assert_allclose(tl, jl, rtol=5e-3)
    assert tl[-1] < tl[0] * 0.9


# ------------------------------------------------------------------ data


def _code(path: Path) -> str:
    """The module's AST with its docstrings dropped."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef)) and node.body and \
                isinstance(node.body[0], ast.Expr) and isinstance(node.body[0].value, ast.Constant):
            node.body = node.body[1:] or [ast.Pass()]
    return ast.dump(tree)


def test_data_pipeline_is_a_copy_of_the_references():
    """``data/pipeline.py`` has the reference's code, and gives its batches
    bit for bit: by step, shard and seed, and through the prefetch
    iterator, in order."""
    assert _code(SRC / "repro_torch" / "data" / "pipeline.py") == \
        _code(SRC / "repro" / "data" / "pipeline.py")
    for args in ((100, 8, 4, 7), (32_000, 256, 8, 0)):
        j, t = JaxDataset(*args), SyntheticLMDataset(*args)
        for step, shard, n in ((0, 0, 1), (3, 1, 4), (99, 2, 4)):
            a, b = j.batch(step, shard, n), t.batch(step, shard, n)
            for k in ("tokens", "labels"):
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])
    zeros = np.mean(SyntheticLMDataset(32_000, 256, 8).batch(0)["tokens"] == 0)
    assert 0.15 < zeros < 0.22  # Zipf with a = 1.2: about 18 % of positions are token 0
    jit_, tit = jax_iterator(100, 8, 2, prefetch=3), make_train_iterator(100, 8, 2, prefetch=3)
    try:
        for _ in range(5):
            (js, jb), (ts, tb) = next(jit_), next(tit)
            assert js == ts
            np.testing.assert_array_equal(jb["tokens"], tb["tokens"])
    finally:
        jit_.close()
        tit.close()


# ---------------------------------------------------------------- driver


@pytest.mark.parametrize("ckpt", [False, True])
def test_the_driver_improves_the_loss_on_the_cpu(ckpt, tmp_path, capsys):
    """``python -m repro_torch.launch.train --device cpu --reduced --steps
    20``, with and without ``--ckpt-dir``: the reference's lines, a loss
    that falls, and under the supervisor checkpoints at steps 8, 16 and
    20 (the last always written)."""
    argv = ["--device", "cpu", "--reduced", "--steps", "20"]
    if ckpt:
        argv += ["--ckpt-dir", str(tmp_path), "--ckpt-every", "8"]
    run = train_driver.main(argv)
    out = capsys.readouterr().out
    assert "[train] arch=paper-lm-100m params=0.1M batch=8 seq=256" in out
    first, last = map(float, re.search(r"loss (\S+) -> (\S+)", out).groups())
    assert last < first and len(run.losses) == 20
    assert first == pytest.approx(run.losses[0], abs=1e-4)
    if ckpt:
        assert "[train] straggler events: " in out and "restarts: 0" in out
        assert sorted(p.name for p in tmp_path.iterdir()) == ["step_16", "step_20", "step_8"]
    else:
        assert "  step    0 loss=" in out and "  step   10 loss=" in out
