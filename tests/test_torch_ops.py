"""The port's matmul, configured_matmul, flash_attention, top_k and the
split-and-merge arithmetic of its flash_attention and greedy_sample kernels
against the JAX package's.

The same inputs, made with numpy and carried across bit-exactly, go
through ``repro.kernels.ops`` (the Pallas kernels in interpret mode, and
the plain ``ref`` versions) and ``repro_torch.kernels.ops``, which on a CPU
tensor runs its plain version. Tolerances are the JAX tests' own
(``tests/test_kernels.py``). The CUDA kernels run only on a card: their
tests are marked ``gpu`` and skip here. JAX is imported inside the CPU
tests so the ``gpu`` tests also collect on a machine without it."""

from __future__ import annotations

import numpy as np
import pytest
import torch

import math

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention, k_end, plan_attention
from repro_torch.kernels.matmul import configured_matmul, matmul
from repro_torch.kernels.sampling import K_MAX, greedy_sample, plan_greedy_sample, plan_top_k, top_k

MATMUL_SHAPES = [(128, 128, 128), (256, 128, 128), (128, 384, 256), (384, 256, 128)]
ATTN_SHAPES = [(1, 2, 128, 64), (2, 4, 256, 64), (1, 1, 256, 128)]
DTYPES = ["float32", "bfloat16"]


def _pair(x: np.ndarray, dtype: str):
    """The same values as a JAX array and a CPU tensor, bit-exactly."""
    import jax.numpy as jnp
    from _torch_port import to_torch

    j = jnp.asarray(x).astype(getattr(jnp, dtype))
    return j, to_torch(j)


def _normal(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _ints(seed: int, shape, lo: int = -16, hi: int = 16) -> np.ndarray:
    return np.random.default_rng(seed).integers(lo, hi, shape).astype(np.float32)


def _close(got, want, rtol: float, atol: float) -> None:
    from _torch_port import to_numpy32

    np.testing.assert_allclose(to_numpy32(got), to_numpy32(want), rtol=rtol, atol=atol)


# ------------------------------------------------------------------ matmul


@pytest.mark.parametrize("shape", MATMUL_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_matmul_op_matches_jax(shape, dtype):
    from repro.kernels import ops as jax_ops
    from repro.kernels import ref as jax_ref

    m, k, n = shape
    ja, a = _pair(_normal(1, (m, k)), dtype)
    jb, b = _pair(_normal(2, (k, n)), dtype)
    got = ops.matmul_op(a, b)
    assert got.dtype == a.dtype and got.shape == (m, n)
    _close(got, jax_ops.matmul_op(ja, jb, backend="pallas_interpret"), 2e-2, 2e-2)
    _close(got, jax_ref.matmul_ref(ja, jb), 2e-2, 2e-2)


@pytest.mark.parametrize("shape", [(5, 7, 3), (130, 70, 33), (1, 896, 257), (64, 0, 8)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_matmul_op_ragged_shapes_match_jax_ref(shape, dtype):
    """The Pallas kernel takes multiples of 128 only; the port takes any
    shape, held to the JAX plain version."""
    from repro.kernels import ref as jax_ref

    m, k, n = shape
    ja, a = _pair(_normal(3, (m, k)), dtype)
    jb, b = _pair(_normal(4, (k, n)), dtype)
    _close(ops.matmul_op(a, b), jax_ref.matmul_ref(ja, jb), 2e-2, 2e-2)


@pytest.mark.parametrize("zp_a", [-8, 0, 5, 8])
@pytest.mark.parametrize("zp_b", [-8, -3, 0, 8])
def test_configured_matmul_op_exact(zp_a, zp_b):
    """Integer-valued inputs: every product and sum is exact in float32, so
    the port equals the Pallas kernel and the plain version exactly."""
    import jax.numpy as jnp
    from repro.kernels import ops as jax_ops
    from repro.kernels import ref as jax_ref

    ja, a = _pair(_ints(10 + zp_a, (128, 128)), "float32")
    jb, b = _pair(_ints(20 + zp_b, (128, 128)), "float32")
    zp = jnp.array([zp_a, zp_b], jnp.int32)
    got = ops.configured_matmul_op(a, b, torch.tensor([zp_a, zp_b], dtype=torch.int32))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_ops.configured_matmul_op(ja, jb, zp, backend="pallas_interpret")))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_ref.configured_matmul_ref(ja, jb, zp[0], zp[1])))


@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_configured_matmul_op_types_and_ragged_shapes_exact(dtype):
    """OpenGeMM's own case, int8, and bf16 at a shape no 128-block divides,
    against the JAX plain version, exactly; every spelling of the zero
    points gives the same result."""
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref

    ja, a = _pair(_ints(5, (70, 130), -128, 128), dtype)
    jb, b = _pair(_ints(6, (130, 33), -128, 128), dtype)
    want = np.asarray(jax_ref.configured_matmul_ref(ja, jb, jnp.int32(-8), jnp.int32(7)))
    for zp in [(-8, 7), [np.int32(-8), np.int64(7)], torch.tensor([-8, 7], dtype=torch.int32)]:
        np.testing.assert_array_equal(ops.configured_matmul_op(a, b, zp).numpy(), want)


def _epilogue(a: torch.Tensor, b: torch.Tensor, zp_a: int, zp_b: int) -> torch.Tensor:
    """The int8 wgmma route's arithmetic written out in int64: the product
    of the operands as they lie, corrected by the zero points through row
    and column sums, rounded to float32 once."""
    k = a.shape[1]
    ab = a.long() @ b.long()
    rowsum, colsum = a.long().sum(1, keepdim=True), b.long().sum(0, keepdim=True)
    return (ab - zp_b * rowsum - zp_a * colsum + k * zp_a * zp_b).float()


@pytest.mark.parametrize("shape", [(70, 130, 33), (128, 896, 64), (5, 16, 16)])
@pytest.mark.parametrize("zp", [(-8, 8), (0, 0), (5, -3), (8, -8)])
def test_int8_epilogue_identity_equals_jax_plain_version(shape, zp):
    """Where every float32 partial sum is an integer below 2**24 (here
    896 · 136 · 136 < 2**24), the exact integer result rounded once equals
    the JAX plain version, which sums in float32."""
    import jax.numpy as jnp
    from repro.kernels import ref as jax_ref

    m, k, n = shape
    ja, a = _pair(_ints(30 + k, (m, k), -128, 128), "int8")
    jb, b = _pair(_ints(40 + n, (k, n), -128, 128), "int8")
    want = np.asarray(jax_ref.configured_matmul_ref(ja, jb, jnp.int32(zp[0]), jnp.int32(zp[1])))
    np.testing.assert_array_equal(_epilogue(a, b, *zp).numpy(), want)
    np.testing.assert_array_equal(ops.configured_matmul_op(a, b, zp).numpy(), want)


def test_int8_epilogue_identity_is_exact_where_float32_sums_are_not():
    """Full-range int8 at K = 4096 with zero points (-128, 127): the sums
    pass 2**24, the float32 plain version rounds on the way, and the
    identity still gives the float64 answer rounded once."""
    a = torch.from_numpy(_ints(50, (32, 4096), -128, 128)).to(torch.int8)
    b = torch.from_numpy(_ints(51, (4096, 16), -128, 128)).to(torch.int8)
    exact = ((a.double() + 128) @ (b.double() - 127)).float()
    assert float(exact.abs().max()) > 2**24
    np.testing.assert_array_equal(_epilogue(a, b, -128, 127).numpy(), exact.numpy())


# --------------------------------------------------------------- attention


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_op_matches_jax(shape, causal, dtype):
    from repro.kernels import ops as jax_ops
    from repro.kernels import ref as jax_ref

    (jq, q), (jk, k), (jv, v) = (_pair(_normal(s, shape), dtype) for s in (1, 2, 3))
    got = ops.attention_op(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, jax_ops.attention_op(jq, jk, jv, causal=causal, backend="pallas_interpret"),
           3e-2, 3e-2)
    _close(got, jax_ref.flash_attention_ref(jq, jk, jv, causal=causal), 3e-2, 3e-2)


def test_attention_op_decode_shape():
    """Sq = 1 against 256 keys (the serving path), at
    test_flash_attention_decode_shape's tolerance; causal bottom-right lets
    the one query see every key, so it equals full attention."""
    from repro.kernels import ops as jax_ops
    from repro.kernels import ref as jax_ref

    jq, q = _pair(_normal(1, (2, 4, 1, 64)), "float32")
    jk, k = _pair(_normal(2, (2, 4, 256, 64)), "float32")
    jv, v = _pair(_normal(3, (2, 4, 256, 64)), "float32")
    got = ops.attention_op(q, k, v, causal=False)
    _close(got, jax_ops.attention_op(jq, jk, jv, causal=False, backend="pallas_interpret"),
           2e-2, 2e-3)
    _close(got, jax_ref.flash_attention_ref(jq, jk, jv, causal=False), 2e-2, 2e-3)
    _close(ops.attention_op(q, k, v, causal=True),
           jax_ref.flash_attention_ref(jq, jk, jv, causal=True), 2e-2, 2e-3)
    _close(ops.attention_op(q, k, v, causal=True), got, 2e-2, 2e-3)


def test_attention_op_causal_sq_below_sk_follows_ref_not_pallas():
    """A documented divergence inside the reference: with Sq < Sk the plain
    version masks bottom-right and the Pallas kernel top-left. The port
    follows the plain version; the Pallas kernel is more than 1 away."""
    from repro.kernels import ops as jax_ops
    from repro.kernels import ref as jax_ref
    from _torch_port import to_numpy32

    jq, q = _pair(_normal(1, (1, 2, 128, 64)), "float32")
    jk, k = _pair(_normal(2, (1, 2, 256, 64)), "float32")
    jv, v = _pair(_normal(3, (1, 2, 256, 64)), "float32")
    got = ops.attention_op(q, k, v, causal=True)
    _close(got, jax_ref.flash_attention_ref(jq, jk, jv, causal=True), 3e-2, 3e-2)
    pallas = jax_ops.attention_op(jq, jk, jv, causal=True, backend="pallas_interpret")
    assert np.abs(to_numpy32(got) - to_numpy32(pallas)).max() > 1.0


def _split_merge_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool) -> torch.Tensor:
    """The SIMT kernel's arithmetic written out in float32: each query
    tile's keys cut into ``plan_attention``'s ranges, each range's partial
    (m, l, acc) over unscaled scores with p = exp((s - m) / sqrt(D)) (a
    range whose keys are all masked keeps m = -inf, l = 0, acc = 0), and
    the partials merged with weights exp((m_p - max m) / sqrt(D))."""
    b, h, sq, d = q.shape
    sk = k.shape[2]
    plan = plan_attention(b * h, sq, sk, d, causal)
    scale = torch.tensor(1 / math.sqrt(d), dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    out = torch.empty((b, h, sq, d), dtype=torch.float32)
    for q0 in range(0, sq, plan.block_q):
        rows = torch.arange(q0, min(sq, q0 + plan.block_q))
        parts = []
        for start, stop in plan.key_ranges(k_end(q0, plan.block_q, sq, sk, causal)):
            s = qf[:, :, rows] @ kf[:, :, start:stop].transpose(-1, -2)
            if causal:
                keys = torch.arange(start, stop)
                s = s.masked_fill(keys[None, :] > rows[:, None] + sk - sq, float("-inf"))
            m = s.amax(-1) if stop > start else torch.full(s.shape[:-1], float("-inf"))
            p = torch.exp((s - torch.where(m == float("-inf"), 0.0, m)[..., None]) * scale)
            parts.append((m, p.sum(-1), p @ vf[:, :, start:stop]))
        big = torch.stack([m for m, _, _ in parts]).amax(0)
        num, den = 0.0, 0.0
        for m, l_p, acc in parts:
            w = torch.where(m == float("-inf"), 0.0, torch.exp((m - big) * scale))
            num, den = num + w[..., None] * acc, den + w * l_p
        out[:, :, rows] = num / den[..., None]
    return out.to(q.dtype)


@pytest.mark.parametrize("q_shape, k_shape, causal", [
    *(((1, 1, s, d), (1, 1, s, d), False) for s, d, _ in
      [(128, 64, 0), (256, 64, 0), (384, 64, 0), (512, 64, 0), (256, 128, 0)]),  # the ladder
    ((1, 2, 128, 64), (1, 2, 256, 64), True),  # causal Sq < Sk
    ((2, 4, 1, 64), (2, 4, 256, 64), True),  # decode: Sq = 1
    ((2, 4, 1, 64), (2, 4, 256, 64), False),
    ((1, 14, 512, 64), (1, 14, 512, 64), True),  # qwen2-0.5b's width
    ((1, 2, 33, 40), (1, 2, 65, 40), True),
])
def test_attention_split_merge_identity_equals_jax_plain_version(q_shape, k_shape, causal):
    """Merging the per-split partial states over the plan's key ranges gives
    the JAX plain version at 1e-5: the split, the exponent taken on
    unscaled score differences, and the merge change only the rounding."""
    from repro.kernels import ref as jax_ref

    (jq, q), (jk, k), (jv, v) = (_pair(_normal(s, shape), "float32")
                                 for s, shape in ((1, q_shape), (2, k_shape), (3, k_shape)))
    assert plan_attention(q_shape[0] * q_shape[1], q_shape[2], k_shape[2], q_shape[3],
                          causal).splits > 1
    _close(_split_merge_attention(q, k, v, causal),
           jax_ref.flash_attention_ref(jq, jk, jv, causal=causal), 1e-5, 1e-5)


def _beats(av: float, ai: int, bv: float, bi: int) -> bool:
    """greedy_sample.cu's combine: NaN first, then the larger value, ties
    and NaNs to the lower index."""
    an, bn = math.isnan(av), math.isnan(bv)
    if an or bn:
        return an and (not bn or ai < bi)
    return av > bv or (av == bv and ai < bi)


def _across_greedy_chunks(b: int, v: int) -> np.ndarray:
    """(b, v) seeded normal rows whose ties and NaNs straddle each chunk
    boundary that ``plan_greedy_sample`` gives: row r takes pattern r % 4,
    a tie of 5 across each boundary, a NaN on each side, +inf on both
    sides, or zeros of both signs everywhere."""
    x = _normal(70 + b, (b, v))
    starts = [start for start, _ in plan_greedy_sample(b, v).bounds(v)[1:]]
    assert starts
    for r in range(b):
        for start in starts:
            if r % 4 == 0:
                x[r, start - 3:start + 3] = 5.0
            elif r % 4 == 1:
                x[r, start - 1:start + 1] = np.nan
            elif r % 4 == 2:
                x[r, start - 2:start + 2] = np.inf
        if r % 4 == 3:
            x[r] = 0.0
            x[r, 2::5] = -0.0
    return x


@pytest.mark.parametrize("b, v", [(1, 151_936), (4, 70_000), (64, 40_000)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_greedy_split_merge_identity_equals_jnp_argmax(b, v, dtype):
    """The kernel's split: each block's (value, index) of its chunk, then
    rank 0's combine of the cluster's pairs. On ties and NaNs across the
    chunk boundaries that equals jnp.argmax of the whole row, and the
    wrapper's plain version."""
    import jax.numpy as jnp
    from _torch_port import to_torch
    from repro.kernels import ref as jax_ref

    x = _across_greedy_chunks(b, v)
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    tx = to_torch(jx)
    plan = plan_greedy_sample(b, v)
    assert plan.cluster > 1
    pairs = []
    for start, stop in plan.bounds(v):
        i = ref.greedy_sample_ref(tx[:, start:stop]).long() + start
        pairs.append((tx.float().gather(1, i[:, None])[:, 0].tolist(), i.tolist()))
    got = []
    for r in range(b):
        bv, bi = float("-inf"), 2**31 - 1
        for vals, ids in pairs:
            if _beats(vals[r], ids[r], bv, bi):
                bv, bi = vals[r], ids[r]
        got.append(bi)
    want = np.asarray(jax_ref.greedy_sample_ref(jx))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(greedy_sample(tx).numpy(), want)


# -------------------------------------------------------------------- top-k


def _lax_top_k(x: np.ndarray, k: int, dtype: str):
    from repro.kernels import ref as jax_ref

    jx, tx = _pair(x, dtype)
    vals, ids = jax_ref.top_k_ref(jx, k)
    return jx, tx, np.asarray(vals, np.float32), np.asarray(ids)


@pytest.mark.parametrize("k", [1, 4, 8])
def test_top_k_op_matches_lax_and_pallas(k):
    from repro.kernels import ops as jax_ops

    jx, x, want_v, want_i = _lax_top_k(_normal(13, (3, 320)), k, "float32")
    got_v, got_i = ops.top_k_op(x, k)
    assert got_v.dtype == torch.float32 and got_i.dtype == torch.int32
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_v.numpy(), want_v)
    pallas_v, pallas_i = jax_ops.top_k_op(jx, k, backend="pallas_interpret")
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(pallas_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(pallas_v, np.float32))


@pytest.mark.parametrize("dtype", DTYPES)
def test_top_k_op_nan_and_ties_follow_lax_top_k(dtype):
    """NaN ranks first, ties go to the lowest index, and -inf entries keep
    index order, as lax.top_k does (torch.topk orders ties otherwise)."""
    rows = np.full((4, 6), -1.0, np.float32)
    rows[0] = [1.0, np.nan, 3.0, 3.0, np.inf, -np.inf]
    rows[1] = [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]
    rows[2] = [-np.inf, 0.5, -np.inf, np.nan, -np.inf, np.nan]
    rows[3] = [0.0, -0.5, 7.0, -0.5, 7.0, -0.5]
    _, x, want_v, want_i = _lax_top_k(rows, 5, dtype)
    np.testing.assert_array_equal(want_i[0, :4], [1, 4, 2, 3])
    got_v, got_i = ops.top_k_op(x, 5)
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_v.numpy(), want_v)  # NaN == NaN here


def _across_chunks(b: int, v: int, k: int) -> np.ndarray:
    """(b, v) rows whose ties and NaNs straddle each chunk boundary that
    ``plan_top_k`` gives: row r takes pattern r % 4 (a tie across each
    boundary, a NaN on each side, +inf on both sides, zeros of both signs)
    over seeded normal values."""
    x = _normal(60 + b, (b, v))
    starts = [start for start, _ in plan_top_k(b, v, k).bounds(v)[1:]]
    assert starts
    for r in range(b):
        for start in starts:
            if r % 4 == 0:
                x[r, start - 3:start + 3] = 5.0
            elif r % 4 == 1:
                x[r, start - 1:start + 1] = np.nan
            elif r % 4 == 2:
                x[r, start - 2:start + 2] = np.inf
        if r % 4 == 3:
            x[r, ::5] = 0.0
            x[r, 2::5] = -0.0
    return x


@pytest.mark.parametrize("b, v", [(4, 20_000), (1, 20_000), (3, 9_000)])
@pytest.mark.parametrize("k", [1, 5, 8, K_MAX])
@pytest.mark.parametrize("dtype", DTYPES)
def test_top_k_split_and_merge_equals_lax_top_k(b, v, k, dtype):
    """The kernel's split: each block's top k of its chunk, with global
    indices, then the top k of the blocks' candidates in block order. On
    ties and NaNs across the chunk boundaries, that equals the top k of the
    whole row, both the port's plain version's and lax.top_k's."""
    _, x, want_v, want_i = _lax_top_k(_across_chunks(b, v, k), k, dtype)
    bounds = plan_top_k(b, v, k).bounds(v)
    assert len(bounds) > 1
    cand_v, cand_i = [], []
    for start, stop in bounds:
        vals, ids = ref.top_k_ref(x[:, start:stop], min(k, stop - start))
        cand_v.append(vals)
        cand_i.append(ids + start)
    cand_v, cand_i = torch.cat(cand_v, 1), torch.cat(cand_i, 1)
    vals, pos = ref.top_k_ref(cand_v, k)
    ids = cand_i.gather(1, pos.long())
    np.testing.assert_array_equal(ids.numpy(), want_i)
    np.testing.assert_array_equal(vals.numpy(), want_v)
    whole_v, whole_i = ref.top_k_ref(x, k)
    np.testing.assert_array_equal(whole_i.numpy(), want_i)
    np.testing.assert_array_equal(whole_v.numpy(), want_v)


def test_top_k_k1_is_sample_op():
    _, x = _pair(_normal(17, (5, 200)), "bfloat16")
    _, ids = ops.top_k_op(x, 1)
    np.testing.assert_array_equal(ids[:, 0].numpy(), ops.sample_op(x).numpy())


def test_top_k_limit_is_at_least_64():
    assert K_MAX >= 64
    x = torch.randn((2, 300), generator=torch.Generator().manual_seed(0))
    _, ids = top_k(x, K_MAX)
    assert ids.shape == (2, K_MAX)


# ------------------------------------------------- what the wrappers refuse


def _mm(bad: str):
    a, b = torch.zeros((4, 8)), torch.zeros((8, 3))
    return {
        "int32": (a.int(), b.int()),
        "mixed": (a, b.bfloat16()),
        "float16": (a.half(), b.half()),
        "rank3": (a[None], b),
        "inner": (a, torch.zeros((7, 3))),
        "strided": (torch.zeros((8, 4)).T, b),
        "meta": (a.to("meta"), b.to("meta")),
    }[bad]


@pytest.mark.parametrize("bad", ["int32", "mixed", "float16", "rank3", "inner", "strided", "meta"])
def test_matmul_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises((TypeError, ValueError)):
        matmul(*_mm(bad))


@pytest.mark.parametrize("bad", ["int32", "mixed", "rank3", "inner", "strided", "meta"])
def test_configured_matmul_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises((TypeError, ValueError)):
        configured_matmul(*_mm(bad), (0, 0))


@pytest.mark.parametrize("zp", ["device", "shape", "dtype", "float", "three", "range"])
def test_configured_matmul_rejects_zero_points_off_the_host(zp):
    """The zero points are launch parameters: they must be on the host. A
    tensor on a device (``meta`` here; ``cuda`` on a card, see the gpu
    test) is refused rather than read, which would synchronise."""
    bad = {
        "device": torch.zeros(2, dtype=torch.int32, device="meta"),
        "shape": torch.zeros((1, 2), dtype=torch.int32),
        "dtype": torch.zeros(2, dtype=torch.int64),
        "float": (0.5, 1),
        "three": (1, 2, 3),
        "range": (2**25, 0),
    }[zp]
    with pytest.raises((TypeError, ValueError), match="zero points|configured_matmul"):
        configured_matmul(torch.zeros((4, 8)), torch.zeros((8, 3)), bad)


def _attn(bad: str):
    q = torch.zeros((1, 2, 8, 64))
    return {
        "mixed": (q, q.bfloat16(), q),
        "float16": (q.half(), q.half(), q.half()),
        "rank3": (q[0], q[0], q[0]),
        "heads": (q, torch.zeros((1, 1, 8, 64)), torch.zeros((1, 1, 8, 64))),
        "kv": (q, q, torch.zeros((1, 2, 9, 64))),
        "d256": (torch.zeros((1, 1, 8, 256)),) * 3,
        "no_keys": (q, torch.zeros((1, 2, 0, 64)), torch.zeros((1, 2, 0, 64))),
        "causal_sq_gt_sk": (q, q[:, :, :4].contiguous(), q[:, :, :4].contiguous()),
        "strided": (q.transpose(2, 3), q.transpose(2, 3), q.transpose(2, 3)),
        "meta": (q.to("meta"),) * 3,
    }[bad]


@pytest.mark.parametrize("bad", ["mixed", "float16", "rank3", "heads", "kv", "d256", "no_keys",
                                 "causal_sq_gt_sk", "strided", "meta"])
def test_flash_attention_rejects_what_the_kernel_does_not_take(bad):
    with pytest.raises((TypeError, ValueError)):
        flash_attention(*_attn(bad), causal=True)


@pytest.mark.parametrize("block_q, splits", [(32, 2), (64, 3), (64, 16), (64, 0)])
def test_flash_attention_rejects_a_plan_the_kernel_cannot_launch(block_q, splits):
    from repro_torch.kernels.flash_attention import AttnPlan

    q = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="cannot launch"):
        flash_attention(q, q, q, plan=AttnPlan(block_q, splits))


@pytest.mark.parametrize("cluster, chunk", [(3, 104), (32, 16), (2, 100), (2, 400), (4, 72)])
def test_greedy_sample_rejects_a_plan_the_kernel_cannot_launch(cluster, chunk):
    """V = 300: the cluster must be a size the kernel launches, the chunk a
    multiple of 8, and the chunks non-empty and covering the row."""
    from repro_torch.kernels.sampling import GreedyPlan

    with pytest.raises(ValueError, match="cannot launch"):
        greedy_sample(torch.zeros((2, 300)), GreedyPlan(cluster, chunk))


def test_flash_attention_full_takes_sq_above_sk():
    """Only causal attention needs Sq <= Sk: full attention over fewer keys
    than queries is well defined."""
    q = torch.randn((1, 1, 8, 32), generator=torch.Generator().manual_seed(0))
    out = flash_attention(q, q[:, :, :3].contiguous(), q[:, :, :3].contiguous(), causal=False)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("k", [0, -1, K_MAX + 1, 301, 2.0, True])
def test_top_k_rejects_k_out_of_range(k):
    with pytest.raises(ValueError):
        top_k(torch.zeros((2, 300)), k)


def test_cpu_tensors_run_the_plain_versions_and_launch_nothing():
    wrappers = (matmul, configured_matmul, flash_attention, top_k)
    before = [w.launches for w in wrappers]
    gen = torch.Generator().manual_seed(0)
    a, b = torch.randn((9, 5), generator=gen), torch.randn((5, 4), generator=gen)
    q = torch.randn((1, 2, 6, 16), generator=gen)
    x = torch.randn((3, 50), generator=gen)
    exact = dict(rtol=0, atol=0)
    torch.testing.assert_close(matmul(a, b), ref.matmul_ref(a, b), **exact)
    torch.testing.assert_close(configured_matmul(a, b, (1, -2)),
                               ref.configured_matmul_ref(a, b, 1, -2), **exact)
    torch.testing.assert_close(flash_attention(q, q, q), ref.flash_attention_ref(q, q, q), **exact)
    torch.testing.assert_close(top_k(x, 5), ref.top_k_ref(x, 5), **exact)
    assert [w.launches for w in wrappers] == before


# ------------------------------------------------------------------ on a card


def _cuda() -> None:
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full f32


def _launched(wrapper, fn):
    before = wrapper.launches
    out = fn()
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    return out


@pytest.mark.gpu
def test_cuda_matmul_matches_plain_version():
    """f32 at rtol 1e-4 (atol 1e-3: the rounding of ≤ 896-term f32 sums
    taken in another order), bf16 at 2e-2, at the calibration ladder's
    shapes, qwen2-0.5b's MLP width and ragged shapes."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for m, k, n in [*MATMUL_SHAPES, (384, 256, 384), (512, 896, 4864), (5, 7, 3), (130, 70, 33)]:
        a = torch.randn((m, k), generator=gen, device="cuda")
        b = torch.randn((k, n), generator=gen, device="cuda")
        for dtype, tol in ((torch.float32, dict(rtol=1e-4, atol=1e-3)),
                           (torch.bfloat16, dict(rtol=2e-2, atol=2e-2))):
            got = _launched(matmul, lambda: matmul(a.to(dtype), b.to(dtype)))
            torch.testing.assert_close(got, ref.matmul_ref(a.to(dtype), b.to(dtype)), **tol)


@pytest.mark.gpu
def test_cuda_configured_matmul_matches_plain_version_exactly():
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(1)
    for m, k, n in [(128, 128, 128), (512, 896, 4864), (70, 130, 33)]:
        a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda")
        b = torch.randint(-128, 128, (k, n), generator=gen, device="cuda")
        for dtype in (torch.int8, torch.bfloat16, torch.float32):
            for zp in ((-8, 8), (0, 0), (3, -5)):
                got = _launched(configured_matmul,
                                lambda: configured_matmul(a.to(dtype), b.to(dtype), zp))
                want = ref.configured_matmul_ref(a.to(dtype), b.to(dtype), *zp)
                torch.testing.assert_close(got, want, rtol=0, atol=0)
    with pytest.raises(ValueError, match="synchronise"):
        configured_matmul(a.to(torch.int8), b.to(torch.int8),
                          torch.zeros(2, dtype=torch.int32, device="cuda"))


@pytest.mark.gpu
def test_cuda_flash_attention_matches_plain_version():
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(2)
    cases = [(s, s) for s in ATTN_SHAPES] + [((1, 14, 512, 64),) * 2, ((1, 1, 384, 64),) * 2,
                                             ((2, 4, 1, 64), (2, 4, 256, 64)),
                                             ((1, 2, 100, 128), (1, 2, 300, 128)),
                                             ((1, 2, 33, 40), (1, 2, 65, 40))]
    for qs, ks in cases:
        q, k, v = (torch.randn(s, generator=gen, device="cuda") for s in (qs, ks, ks))
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                args = (q.to(dtype), k.to(dtype), v.to(dtype))
                got = _launched(flash_attention, lambda: flash_attention(*args, causal=causal))
                torch.testing.assert_close(
                    got, ref.flash_attention_ref(*args, causal=causal), rtol=3e-2, atol=3e-2)


@pytest.mark.gpu
def test_cuda_top_k_matches_plain_version_exactly():
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = [torch.randn((4, 151_936), generator=gen, device="cuda"),
            torch.randint(-3, 3, (3, 1000), generator=gen, device="cuda").float(),  # many ties
            torch.tensor([[1.0, float("nan"), 3.0, 3.0, float("inf"), float("-inf")]] * 2,
                         device="cuda"),
            torch.randn((1, 151_936), generator=gen, device="cuda"),  # the most blocks per row
            torch.randn((64, 151_936), generator=gen, device="cuda"),  # the fewest
            *(torch.from_numpy(_across_chunks(b, 151_936, k)).cuda()  # across chunk boundaries
              for b, k in ((4, 8), (1, 8), (2, K_MAX)))]
    for x in rows:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for k in (1, 2, 5, 8, 33, K_MAX):
                if k > x.shape[1]:
                    continue
                got_v, got_i = _launched(top_k, lambda: top_k(x.to(dtype), k))
                want_v, want_i = ref.top_k_ref(x.to(dtype), k)
                torch.testing.assert_close(got_i, want_i, rtol=0, atol=0)
                torch.testing.assert_close(got_v, want_v, rtol=0, atol=0, equal_nan=True)


@pytest.mark.gpu
@pytest.mark.parametrize("case, route", [
    ("int8", "wgmma"), ("int8 ragged M", "wgmma"), ("int8 K % 16", "simt"),
    ("int8 off-aligned", "simt"), ("float32", "simt"), ("bfloat16", "simt"),
    ("int8 position-coded", "wgmma"), ("int8 K=4096 full range", "wgmma"),
])
def test_cuda_configured_matmul_each_route_matches_plain_version(case, route):
    """Each route equals the plain version exactly on integer inputs whose
    float32 sums are exact, and counts its launch; the position-coded int8
    product (A the stacked identity, B coding its row and column) comes out
    exactly; and at K = 4096 with zero points (-128, 127) the wgmma route
    equals the float64 answer rounded once."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(6)
    shape, zp = {"int8 ragged M": (130, 144, 208), "int8 K % 16": (128, 136, 128),
                 "int8 K=4096 full range": (128, 4096, 128)}.get(case, (512, 896, 4864)), (-8, 8)
    m, k, n = shape
    dt = getattr(torch, case.split()[0])
    a = torch.randint(-128, 128, (m, k), generator=gen, device="cuda").to(dt)
    b = torch.randint(-128, 128, (k, n), generator=gen, device="cuda").to(dt)
    if case == "int8 off-aligned":
        a = _off_alignment(a)
    if case == "int8 position-coded":
        sel = torch.arange(m, device="cuda") % 128
        a = torch.zeros((m, 128), dtype=torch.int8, device="cuda")
        a[torch.arange(m, device="cuda"), sel] = 1
        b = (torch.arange(128, device="cuda")[:, None] % 16 * 16
             + torch.arange(n, device="cuda")[None, :] % 16 - 128).to(torch.int8)
        zp = (0, 0)
    if case == "int8 K=4096 full range":
        zp = (-128, 127)
    got = _routed(configured_matmul, route, lambda: configured_matmul(a, b, zp))
    if case == "int8 position-coded":
        want = b[sel].float()
    elif case == "int8 K=4096 full range":
        want = ((a.double() - zp[0]) @ (b.double() - zp[1])).float()
    else:
        want = ref.configured_matmul_ref(a, b, *zp)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _off_alignment(x: torch.Tensor) -> torch.Tensor:
    """The same values, contiguous, one element past a 16-byte boundary:
    an address that neither TMA nor the 16-byte copies take."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    out = buf[1:].view(x.shape)
    out.copy_(x)
    return out


def _routed(wrapper, route: str, fn):
    before = dict(wrapper.launches_by_route)
    out = _launched(wrapper, fn)
    assert wrapper.launches_by_route[route] == before[route] + 1, wrapper.launches_by_route
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, shape, off, route", [
    ("bfloat16", (512, 896, 4864), False, "wgmma"),
    ("bfloat16", (130, 72, 200), False, "wgmma"),
    ("bfloat16", (130, 70, 33), False, "simt"),
    ("bfloat16", (128, 128, 128), True, "simt"),
    ("float32", (512, 896, 4864), False, "pipelined"),
    ("float32", (384, 256, 384), False, "pipelined"),
    ("float32", (130, 72, 36), False, "pipelined"),
    ("float32", (130, 70, 33), False, "simt"),
    ("float32", (128, 128, 128), True, "simt"),
])
def test_cuda_matmul_each_route_matches_plain_version(dtype, shape, off, route):
    _cuda()
    m, k, n = shape
    gen = torch.Generator(device="cuda").manual_seed(4)
    dt = getattr(torch, dtype)
    a = torch.randn((m, k), generator=gen, device="cuda").to(dt)
    b = torch.randn((k, n), generator=gen, device="cuda").to(dt)
    if off:
        a = _off_alignment(a)
    got = _routed(matmul, route, lambda: matmul(a, b))
    tol = dict(rtol=1e-4, atol=1e-3) if dt == torch.float32 else dict(rtol=2e-2, atol=2e-2)
    torch.testing.assert_close(got, ref.matmul_ref(a, b), **tol)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(512, 896, 4864), (128, 128, 128), (130, 72, 200), (5, 8, 8)])
def test_cuda_matmul_bf16_position_coded_product_is_exact(shape):
    """A selects one row of B per row of C (0/1 entries) and B holds small
    integers, exact in bf16, coding (k % 16, n % 16): every C[i, j] must be
    B[sel(i), j] exactly, so a wrong shared-memory layout shows which row or
    column went astray."""
    _cuda()
    m, k, n = shape
    sel = (torch.arange(m, device="cuda") * 7 + 3) % k
    a = torch.zeros((m, k), device="cuda")
    a[torch.arange(m, device="cuda"), sel] = 1
    b = (torch.arange(k, device="cuda")[:, None] % 16 * 16
         + torch.arange(n, device="cuda")[None, :] % 16).float()
    a, b = a.bfloat16(), b.bfloat16()
    got = _routed(matmul, "wgmma", lambda: matmul(a, b))
    torch.testing.assert_close(got, b[sel], rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype, q_shape, k_shape, causal, off, route", [
    ("bfloat16", (1, 2, 200, 40), (1, 2, 200, 40), True, False, "wgmma"),
    ("bfloat16", (1, 14, 512, 64), (1, 14, 512, 64), True, False, "wgmma"),
    ("bfloat16", (1, 2, 100, 128), (1, 2, 300, 128), False, False, "wgmma"),
    ("bfloat16", (1, 2, 130, 128), (1, 2, 130, 128), True, False, "wgmma"),
    ("bfloat16", (2, 4, 1, 64), (2, 4, 256, 64), True, False, "wgmma"),  # decode
    ("bfloat16", (2, 4, 1, 64), (2, 4, 256, 64), False, False, "wgmma"),
    ("bfloat16", (1, 2, 128, 64), (1, 2, 256, 64), True, False, "wgmma"),  # causal Sq < Sk
    ("bfloat16", (1, 2, 33, 36), (1, 2, 65, 36), True, False, "simt"),
    ("bfloat16", (1, 2, 64, 64), (1, 2, 64, 64), True, True, "simt"),
    ("float32", (1, 2, 128, 64), (1, 2, 256, 64), True, False, "simt"),
])
def test_cuda_flash_attention_each_route_matches_plain_version(dtype, q_shape, k_shape, causal,
                                                               off, route):
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(5)
    dt = getattr(torch, dtype)
    q, k, v = (torch.randn(s, generator=gen, device="cuda").to(dt)
               for s in (q_shape, k_shape, k_shape))
    if off:
        q = _off_alignment(q)
    got = _routed(flash_attention, route, lambda: flash_attention(q, k, v, causal=causal))
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, causal=causal),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", [1, 2, 4, 8])
def test_cuda_flash_attention_each_split_matches_plain_version(splits):
    """The SIMT kernel at every cluster size, on f32 (cp.async staging, and
    plain staging at D = 38 and off 16-byte alignment) and bf16 off
    alignment: the ladder's shape, causal Sq < Sk, decode Sq = 1, ragged
    Sq and Sk; float32 within 1e-4 of the plain version, bf16 3e-2."""
    _cuda()
    from repro_torch.kernels.flash_attention import AttnPlan

    gen = torch.Generator(device="cuda").manual_seed(7 + splits)
    plan = AttnPlan(64, splits)
    for qs, ks, causal in [((1, 1, 512, 64), (1, 1, 512, 64), False),
                           ((1, 2, 128, 64), (1, 2, 256, 64), True),
                           ((2, 4, 1, 64), (2, 4, 256, 64), True),
                           ((1, 2, 100, 128), (1, 2, 300, 128), False),
                           ((1, 3, 70, 38), (1, 3, 91, 38), True)]:
        q, k, v = (torch.randn(s, generator=gen, device="cuda") for s in (qs, ks, ks))
        for dtype, off, staging, tol in ((torch.float32, False, "cp_async" if qs[3] % 4 == 0
                                          else "plain", 1e-4),
                                         (torch.float32, True, "plain", 1e-4),
                                         (torch.bfloat16, True, "plain", 3e-2)):
            x = q.to(dtype)
            args = (_off_alignment(x) if off else x, k.to(dtype), v.to(dtype))
            before = dict(flash_attention.launches_by_staging)
            got = _routed(flash_attention, "simt",
                          lambda: flash_attention(*args, causal=causal, plan=plan))
            assert flash_attention.launches_by_staging[staging] == before[staging] + 1
            torch.testing.assert_close(got, ref.flash_attention_ref(*args, causal=causal),
                                       rtol=tol, atol=tol)


def _attention_f64(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    """Softmax attention in float64, the bottom-right causal mask."""
    sq, sk = q.shape[2], k.shape[2]
    s = q.double() @ k.double().transpose(-1, -2) / math.sqrt(q.shape[-1])
    if causal:
        mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device).tril(sk - sq)
        s = s.masked_fill(~mask, float("-inf"))
    return torch.softmax(s, dim=-1) @ v.double()


def test_float64_attention_is_the_plain_version_in_float64():
    gen = torch.Generator().manual_seed(3)
    q, k, v = (torch.randn((1, 2, 5, 8), generator=gen) for _ in range(3))
    for causal in (True, False):
        torch.testing.assert_close(_attention_f64(q, k, v, causal).float(),
                                   ref.flash_attention_ref(q, k, v, causal=causal))


@pytest.mark.gpu
def test_cuda_flash_attention_f32_error_is_at_most_twice_the_plain_versions():
    """Against a float64 answer, the kernel's f32 error is at most twice
    the plain f32 version's, at qwen2-0.5b's width and the ladder's
    shapes."""
    _cuda()
    gen = torch.Generator(device="cuda").manual_seed(11)
    for shape, causal in [((1, 14, 512, 64), True), ((1, 1, 128, 64), False),
                          ((1, 1, 512, 64), False), ((1, 1, 256, 128), False)]:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda") for _ in range(3))
        exact = _attention_f64(q, k, v, causal)
        err = (flash_attention(q, k, v, causal=causal).double() - exact).abs().max()
        plain = (ref.flash_attention_ref(q, k, v, causal=causal).double() - exact).abs().max()
        assert err <= 2 * plain, (shape, float(err), float(plain))
