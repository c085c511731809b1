"""The port's matmul, configured_matmul, flash_attention and top_k against
the JAX package's.

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

from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.matmul import configured_matmul, matmul
from repro_torch.kernels.sampling import K_MAX, top_k

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
                         device="cuda")]
    for x in rows:
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            for k in (1, 2, 5, 8, 33, K_MAX):
                if k > x.shape[1]:
                    continue
                got_v, got_i = _launched(top_k, lambda: top_k(x.to(dtype), k))
                want_v, want_i = ref.top_k_ref(x.to(dtype), k)
                torch.testing.assert_close(got_i, want_i, rtol=0, atol=0)
                torch.testing.assert_close(got_v, want_v, rtol=0, atol=0, equal_nan=True)
