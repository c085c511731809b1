"""The port's int8 KV cache (``cache_quant="int8"``) against the JAX
package's, on the same parameters, on the CPU.

Tolerances, each stated where it is used:

* ``quantize_kv`` / ``dequantize_kv``: bit for bit, exact .5 ties (half to
  even), all-zero rows and rows under the 1e-8 scale floor included;
* the cache tree, shapes and dtypes: equal to the reference's;
* a masked-out row's four leaves (``k``, ``v``, ``k_scale``,
  ``v_scale``): bit for bit what they were;
* whole-model logits against JAX's int8 decode: ``test_decode_parity``'s
  rtol 0.05, atol 0.15 and top-1 ≥ 0.9 (bf16 products round apart between
  the frameworks, and a K element rounded apart may quantize one step
  apart); sampled ids equal, or at a bf16 tie within that tolerance
  (``_torch_port.assert_sampled_ids_within_ties``); the engine's config
  traffic equal and its streams equal up to such a tie;
* int8 against bf16 decode in the port: ``tests/test_serving.py``'s
  top-1 ≥ 0.95, rtol 0.2, atol 0.5, and the cache under 0.65× the bf16
  cache's bytes.

JAX is imported inside the CPU tests, so the ``gpu`` test also collects on
a machine without it."""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get as torch_get
from repro_torch.models import layers as TL
from repro_torch.models.model import Model as TorchModel

RTOL, ATOL, TOP1 = 0.05, 0.15, 0.9  # tests/test_decode_parity.py
TIES = [127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 125.5, -126.5]  # at a scale of 1
TIES_ROUNDED = [127, -127, 0, 2, 2, 0, -2, -2, 126, -126]  # half to even
PROMPTS = [[5, 9, 2], [7, 1], [3, 3, 3, 3], [11]]


@pytest.fixture(scope="module")
def pair():
    return _int8(_pair_of("qwen2-0.5b"))


def _pair_of(arch: str, seed: int = 0):
    from _torch_port import reduced_pair

    return reduced_pair(seed, arch)


def _int8(pair):
    """``pair`` with both models at ``cache_quant="int8"``, on the same
    parameters."""
    from repro.models.model import Model

    cfg, _, jparams, tmodel, tparams = pair
    cfg = dataclasses.replace(cfg, cache_quant="int8")
    return (cfg, Model(cfg), jparams,
            TorchModel(dataclasses.replace(tmodel.cfg, cache_quant="int8"), device="cpu"),
            tparams)


def _kv_rows(shape: tuple, seed: int = 0) -> np.ndarray:
    """Seeded f32 K/V rows (B, S, H, D), B ≥ 2, H ≥ 2, D ≥ 10: normal
    values; in batch row 0 an all-zero (position, head) and one of values
    far under the scale's 1e-8 floor; in batch row 1 one of exact ties at a
    scale of 1 (``TIES``, then zeros); every value a bf16 one."""
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[0, 0, -1] = 1e-12 * rng.standard_normal(shape[-1])
    x[1, -1, -1] = 0.0
    x[1, -1, -1, :len(TIES)] = TIES
    return x


def _assert_logits_close(want, got):
    from _torch_port import to_numpy32

    a, b = to_numpy32(want), to_numpy32(got)
    np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
    assert (a.argmax(-1) == b.argmax(-1)).mean() >= TOP1


def _tokens(cfg, shape, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def _jax_dequantized(jcache: dict, key: str) -> np.ndarray:
    from _torch_port import to_numpy32
    from repro.models import layers as JL

    return to_numpy32(JL.dequantize_kv(jcache[key], jcache[f"{key}_scale"]))


# ---------------------------------------------------------- the quantizer


@pytest.mark.parametrize("shape", [(4, 1, 2, 64), (2, 5, 2, 16)])
def test_quantize_and_dequantize_equal_jax_bit_for_bit(shape):
    import jax.numpy as jnp

    from _torch_port import to_torch
    from repro.models import layers as JL

    x = jnp.asarray(_kv_rows(shape), jnp.bfloat16)
    jq, js = JL.quantize_kv(x)
    tq, ts = TL.quantize_kv(to_torch(x))
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    assert tuple(ts.shape) == (*shape[:-1], 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.view(torch.int16).numpy(), np.asarray(js).view(np.int16))
    assert tq[1, -1, -1, :len(TIES)].tolist() == TIES_ROUNDED
    floor = float(torch.tensor(1e-8).to(torch.bfloat16))
    assert not tq[0, 0, 0].any() and float(ts[0, 0, 0]) == float(ts[0, 0, -1]) == floor
    got = TL.dequantize_kv(tq, ts)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  np.asarray(JL.dequantize_kv(jq, js)).view(np.int16))


# ------------------------------------------------------------ the cache


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "phi3.5-moe-42b-a6.6b", "phi-3-vision-4.2b",
                                  "whisper-medium"])
def test_init_cache_tree_equals_the_references(arch):
    """dense, moe and vlm: int8 ``k``/``v`` and bf16 ``k_scale``/``v_scale``
    of one column; encdec's cache is the bf16 one, ``cache_quant`` or not,
    as the reference's."""
    from repro.configs import get
    from repro.models.model import Model

    def tree(cache) -> dict:
        return {k: (tuple(v.shape), str(v.dtype).removeprefix("torch.")) for k, v in cache.items()}

    cfg = dataclasses.replace(get(arch).reduced(), remat="none", cache_quant="int8")
    tcfg = dataclasses.replace(torch_get(arch).reduced(), remat="none", cache_quant="int8")
    want = tree(Model(cfg).init_cache(3, 8))
    got = tree(TorchModel(tcfg, device="cpu").init_cache(3, 8))
    assert got == want
    plain = tree(TorchModel(dataclasses.replace(tcfg, cache_quant="none"),
                            device="cpu").init_cache(3, 8))
    if cfg.family == "encdec":
        assert got == plain and "k_scale" not in got
    else:
        assert got == {**{k: (s, "int8") for k, (s, _) in plain.items()},
                       "k_scale": ((cfg.n_layers, 3, 8, cfg.n_kv_heads, 1), "bfloat16"),
                       "v_scale": ((cfg.n_layers, 3, 8, cfg.n_kv_heads, 1), "bfloat16")}


def test_cache_bytes_under_065_of_bf16(pair):
    """``tests/test_serving.py``'s ``test_int8_cache_halves_bytes`` on the
    port: int8 values and a bf16 scale a head (D = 16, so 2/16 on top)."""
    _, _, _, tmodel, _ = pair

    def nbytes(cache: dict) -> int:
        return sum(v.numel() * v.element_size() for v in cache.values())

    plain = TorchModel(dataclasses.replace(tmodel.cfg, cache_quant="none"), device="cpu")
    full, quant = nbytes(plain.init_cache(4, 128)), nbytes(tmodel.init_cache(4, 128))
    assert quant < 0.65 * full
    assert quant == full // 2 + full // tmodel.cfg.head_dim_


# ------------------------------------------------------------- decoding


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "phi-3-vision-4.2b"])
def test_teacher_forced_decode_matches_jax(arch):
    import jax
    import jax.numpy as jnp

    from _torch_port import to_numpy32

    cfg, jmodel, jparams, tmodel, tparams = _int8(_pair_of(arch))
    b, s = 2, 10
    toks = _tokens(cfg, (b, s))
    jcache, tcache = jmodel.init_cache(b, s), tmodel.init_cache(b, s)
    step = jax.jit(jmodel.decode_step)
    want, got = [], []
    for i in range(s):
        lg, jcache = step(jparams, jcache, jnp.asarray(toks[:, i:i + 1]), jnp.int32(i))
        want.append(to_numpy32(lg[:, 0]))
        lt, tcache = tmodel.decode_step(tparams, tcache, torch.from_numpy(toks[:, i:i + 1]), i)
        got.append(to_numpy32(lt[:, 0]))
    _assert_logits_close(np.stack(want, 1), np.stack(got, 1))
    for key in ("k", "v"):
        assert tcache[key].dtype == torch.int8
        want_kv = _jax_dequantized(jcache, key)
        got_kv = TL.dequantize_kv(tcache[key], tcache[f"{key}_scale"])
        np.testing.assert_allclose(to_numpy32(got_kv), want_kv, rtol=RTOL, atol=ATOL)


def test_sampled_ids_equal_jax_within_ties(pair):
    """Six fused steps of three slots at their own positions, one dead, with
    host overrides: ids equal, or at a bf16 tie within parity."""
    from _torch_port import assert_sampled_ids_within_ties

    assert_sampled_ids_within_ties(pair)


def test_int8_decode_keeps_the_bf16_decodes_top1(pair):
    """``tests/test_serving.py``'s ``test_int8_cache_decode_top1_agreement``
    on the port: teacher-forced int8 against bf16 decode, B = 2, S = 10."""
    cfg, _, _, tmodel, tparams = pair
    b, s = 2, 10
    toks = torch.from_numpy(_tokens(cfg, (b, s)))
    plain = TorchModel(dataclasses.replace(tmodel.cfg, cache_quant="none"), device="cpu")

    def run(model) -> np.ndarray:
        cache, out = model.init_cache(b, s), []
        for i in range(s):
            lg, cache = model.decode_step(tparams, cache, toks[:, i:i + 1], i)
            out.append(lg[:, 0].float().numpy())
        return np.stack(out, 1)

    a, q = run(plain), run(tmodel)
    assert (a.argmax(-1) == q.argmax(-1)).mean() >= 0.95
    np.testing.assert_allclose(a, q, rtol=0.2, atol=0.5)
    assert not np.array_equal(a, q)  # the cache is quantized


def test_masked_rows_keep_all_four_leaves_bit_for_bit(pair):
    """A prefill chunk with n_valid = 3 of 8 for slot 1 over a seeded int8
    cache: slot 0's rows and slot 1's rows outside the three written
    positions keep every leaf's bits; the written rows, dequantized, and the
    probe agree with JAX's."""
    import jax
    import jax.numpy as jnp

    from _torch_port import to_numpy32, to_torch

    cfg, jmodel, jparams, tmodel, tparams = pair
    b, max_len = 2, 16
    rng = np.random.default_rng(5)
    shape = (cfg.n_layers, b, max_len, cfg.n_kv_heads)
    junk = {key: rng.integers(-127, 128, (*shape, cfg.head_dim_)).astype(np.int8)
            for key in ("k", "v")}
    junk.update({key: (0.05 * rng.random((*shape, 1)) + 1e-3).astype(jnp.bfloat16)
                 for key in ("k_scale", "v_scale")})
    jcache = {k: jnp.asarray(v) for k, v in junk.items()}
    tcache = {k: to_torch(v) for k, v in junk.items()}
    before = {k: v.clone() for k, v in tcache.items()}
    chunk = np.array([4, 8, 15, 0, 0, 0, 0, 0], np.int32)
    pos0, n_valid, slot_mask = np.array([5, 2], np.int32), np.int32(3), np.array([False, True])
    jprobe, jcache = jax.jit(jmodel.prefill_chunk)(
        jparams, jcache, jnp.asarray(chunk), jnp.asarray(pos0), jnp.asarray(n_valid),
        jnp.asarray(slot_mask))
    tprobe, tcache = tmodel.prefill_chunk(
        tparams, tcache, torch.from_numpy(chunk), torch.from_numpy(pos0),
        torch.as_tensor(n_valid), torch.from_numpy(slot_mask))
    np.testing.assert_array_equal(tprobe.numpy(), np.asarray(jprobe))
    assert set(tcache) == {"k", "v", "k_scale", "v_scale"}
    for key, leaf in tcache.items():
        assert torch.equal(leaf[:, 0], before[key][:, 0]), key
        assert torch.equal(leaf[:, 1, :2], before[key][:, 1, :2]), key
        assert torch.equal(leaf[:, 1, 5:], before[key][:, 1, 5:]), key
        assert not torch.equal(leaf[:, 1, 2:5], before[key][:, 1, 2:5]), key
    for key in ("k", "v"):
        got = TL.dequantize_kv(tcache[key], tcache[f"{key}_scale"])
        np.testing.assert_allclose(to_numpy32(got), _jax_dequantized(jcache, key),
                                   rtol=RTOL, atol=ATOL)


def test_a_masked_decode_row_attends_with_its_own_quantized_kv(pair):
    """One decode step, slot 1 masked out: its logits are those of the same
    step with no mask (where it writes its quantized K/V first), while its
    leaves keep their bits."""
    cfg, _, _, tmodel, tparams = pair
    cache = tmodel.init_cache(2, 8)
    toks = torch.tensor([[3], [4]], dtype=torch.int32)
    pos = torch.tensor([0, 0], dtype=torch.int32)
    tmodel.decode_step(tparams, cache, toks, pos)
    pos = torch.tensor([1, 1], dtype=torch.int32)
    before = {k: v.clone() for k, v in cache.items()}
    free, _ = tmodel.decode_step(tparams, {k: v.clone() for k, v in cache.items()}, toks, pos)
    masked, cache = tmodel.decode_step(tparams, cache, toks, pos, torch.tensor([True, False]))
    assert torch.equal(masked, free)
    for key, leaf in cache.items():
        assert torch.equal(leaf[:, 1], before[key][:, 1]), key
        assert not torch.equal(leaf[:, 0], before[key][:, 0]), key


@pytest.mark.parametrize("sampling", ["fused", "host"])
def test_engine_streams_and_config_traffic_equal_jax_engine(pair, sampling):
    """Four requests through two slots: config traffic and sync bytes equal,
    and each stream equal to the JAX engine's, or equal up to a step where
    JAX's own logits at the two chosen ids lie within parity of each other
    (a bf16 tie the frameworks round apart; the reduced model's 256 bf16
    logits tie often). A dense model's rows are independent, so a request
    past such a tie leaves the others comparable."""
    import jax
    import jax.numpy as jnp

    from repro.serving import Request as JaxRequest
    from repro.serving import ServingEngine as JaxEngine
    from repro_torch.serving import Request, ServingEngine

    def run(engine_cls, request_cls, model, params):
        engine = engine_cls(model, params, max_slots=2, max_len=32, sampling=sampling)
        for i, p in enumerate(PROMPTS):
            engine.submit(request_cls(uid=i, prompt=list(p), max_new_tokens=6))
        streams = {r.uid: r.generated for r in engine.run_until_done()}
        return streams, engine.config_traffic(), engine.sync_bytes, engine.cache

    _, jmodel, jparams, tmodel, tparams = pair
    want = run(JaxEngine, JaxRequest, jmodel, jparams)
    got = run(ServingEngine, Request, tmodel, tparams)
    assert got[1:3] == want[1:3]
    assert sorted(len(g) for g in got[0].values()) == [6] * len(PROMPTS)
    assert {k: v.dtype for k, v in got[3].items()} == {
        "k": torch.int8, "v": torch.int8, "k_scale": torch.bfloat16, "v_scale": torch.bfloat16}
    step = jax.jit(jmodel.decode_step)
    equal = 0
    for uid, prompt in enumerate(PROMPTS):
        w, g = want[0][uid], got[0][uid]
        n = next((i for i, (a, c) in enumerate(zip(w, g)) if a != c), None)
        if n is None:
            equal += 1
            continue
        seq = prompt + w[:n]  # JAX's logits of the step that chose token n
        cache = jmodel.init_cache(1, len(seq))
        for i, tok in enumerate(seq):
            logits, cache = step(jparams, cache, jnp.asarray([[tok]], jnp.int32), jnp.int32(i))
        row = np.asarray(logits[0, 0], np.float32)
        hi, other = row[w[n]], row[g[n]]
        assert hi - other <= ATOL + RTOL * abs(hi), (uid, n, hi, other)
    assert equal >= len(PROMPTS) // 2


# ------------------------------------------------------------ on the card


@pytest.mark.gpu
def test_cuda_int8_fused_step():
    """On the card: ``quantize_kv`` bit for bit the CPU's on the same rows;
    one masked fused step (after a warm-up) with no read-back, one
    greedy_sample launch and the masked slot's four leaves bit-identical;
    and the masked step's logits within parity of the CPU port's over the
    same weights and cache."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: greedy_sample has no CPU mode")
    from repro_torch.kernels.sampling import greedy_sample
    from repro_torch.tree import tree_map

    x = torch.from_numpy(_kv_rows((4, 1, 2, 64))).to(torch.bfloat16)
    q, s = TL.quantize_kv(x)
    cq, cs = TL.quantize_kv(x.cuda())
    assert torch.equal(cq.cpu(), q) and torch.equal(cs.cpu(), s)
    assert torch.equal(TL.dequantize_kv(cq, cs).cpu(), TL.dequantize_kv(q, s))

    cfg = dataclasses.replace(torch_get("qwen2-0.5b").reduced(), remat="none",
                              cache_quant="int8")
    model, cpu = TorchModel(cfg, device="cuda"), TorchModel(cfg, device="cpu")
    params = model.init(0)
    cpu_params = tree_map(lambda p: p.cpu(), params)
    cache = model.init_cache(4, 16)
    toks = torch.tensor([[3], [4], [5], [6]], dtype=torch.int32, device="cuda")
    for i in range(3):
        model.decode_step(params, cache, toks, i)
    pos = torch.tensor([3, 3, 3, 3], dtype=torch.int32, device="cuda")
    live = torch.tensor([True, True, True, False], device="cuda")
    zeros = torch.zeros(4, dtype=torch.int32, device="cuda")
    no_override = torch.zeros(4, dtype=torch.bool, device="cuda")
    host_cache = {k: v.cpu() for k, v in cache.items()}
    want, _ = cpu.decode_step(cpu_params, {k: v.clone() for k, v in host_cache.items()},
                              toks.cpu(), pos.cpu(), live.cpu())
    model.decode_and_sample(params, {k: v.clone() for k, v in cache.items()}, toks, zeros,
                            no_override, pos, live)  # warm-up
    torch.cuda.synchronize()
    before = greedy_sample.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        ids, cache = model.decode_and_sample(params, cache, toks, zeros, no_override, pos, live)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert greedy_sample.launches == before + 1
    assert ids.dtype == torch.int32 and tuple(ids.shape) == (4, 1)
    for key, leaf in cache.items():
        assert torch.equal(leaf[:, 3].cpu(), host_cache[key][:, 3]), key
    logits, _ = model.decode_step(params, {k: v.cuda() for k, v in host_cache.items()}, toks,
                                  pos, live)
    np.testing.assert_allclose(logits.float().cpu().numpy(), want.float().numpy(),
                               rtol=RTOL, atol=ATOL)
