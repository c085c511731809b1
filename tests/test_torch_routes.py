"""The route rules of the port's matmul, configured_matmul and
flash_attention wrappers, and top_k's split of each row across blocks.

Each wrapper chooses its kernel on a CUDA tensor by a pure function of the
type, the shape, the operands' addresses and, for configured_matmul, the
zero points (``plan_matmul``, ``plan_configured_matmul``,
``attention_route``); top_k sizes its grid by ``plan_top_k``. So the rules
are held here on the CPU; the kernels behind each route are held to their
plain versions on the card (``test_torch_ops.py``'s ``gpu`` tests,
``chip_smoke.py``)."""

from __future__ import annotations

import pytest
import torch

from repro_torch.engine.calibrate import SHAPES
from repro_torch.kernels.flash_attention import ROUTES as ATTENTION_ROUTES
from repro_torch.kernels.flash_attention import attention_route, flash_attention
from repro_torch.kernels.matmul import (CONFIGURED_ROUTES, INT8_WGMMA_MAX_K, INT8_WGMMA_MAX_ZP,
                                        PIPELINED_TILES, ROUTES, WGMMA_BLOCK_NS,
                                        configured_matmul, matmul, plan_configured_matmul,
                                        plan_matmul)
from repro_torch.kernels.sampling import (K_MAX, TOP_K_ALIGN, TOP_K_MAX_SPLITS, TOP_K_MIN_CHUNK,
                                          TOP_K_PIECE, TOP_K_REGISTER_K, plan_top_k)

BF16, F32, I8 = torch.bfloat16, torch.float32, torch.int8
ALIGNED = (0x7F0000000000, 0x7F0000100000)


@pytest.mark.parametrize("dtype, shape, ptrs, route", [
    (BF16, (512, 896, 4864), ALIGNED, "wgmma"),  # qwen2-0.5b's MLP width
    (BF16, (128, 128, 128), ALIGNED, "wgmma"),
    (BF16, (5, 8, 8), ALIGNED, "wgmma"),  # any M; K, N multiples of 8
    (BF16, (130, 70, 33), ALIGNED, "simt"),  # K % 8 != 0: A's rows are not 16-byte strided
    (BF16, (1, 896, 257), ALIGNED, "simt"),  # N % 8 != 0
    (BF16, (5, 7, 3), ALIGNED, "simt"),
    (BF16, (64, 0, 8), ALIGNED, "simt"),  # K = 0: nothing for TMA to describe
    (BF16, (512, 896, 4864), (ALIGNED[0] + 2, ALIGNED[1]), "simt"),  # A one element off
    (BF16, (512, 896, 4864), (ALIGNED[0], ALIGNED[1] + 8), "simt"),  # B 8 bytes off
    (F32, (512, 896, 4864), ALIGNED, "pipelined"),
    (F32, (128, 128, 128), ALIGNED, "pipelined"),
    (F32, (1, 4, 4), ALIGNED, "pipelined"),  # K, N multiples of 4
    (F32, (130, 70, 33), ALIGNED, "simt"),
    (F32, (1, 896, 257), ALIGNED, "simt"),
    (F32, (64, 0, 8), ALIGNED, "simt"),
    (F32, (128, 128, 128), (ALIGNED[0] + 4, ALIGNED[1]), "simt"),  # one f32 off 16 bytes
])
def test_matmul_route(dtype, shape, ptrs, route):
    m, k, n = shape
    plan = plan_matmul(dtype, m, k, n, ptrs)
    assert plan.route == route
    assert route in ROUTES


@pytest.mark.parametrize("shape", SHAPES["matmul"])
def test_pipelined_tile_fills_more_of_the_card_at_the_ladder(shape):
    """The calibration ladder is the f32 route's main path: its tile must
    give at least 4 blocks at every shape, where 128 x 128 gave 1-9."""
    m, k, n = shape
    plan = plan_matmul(F32, m, k, n, ALIGNED)
    assert plan.route == "pipelined" and plan.block_m == plan.block_n
    assert plan.block_m in PIPELINED_TILES
    blocks = -(-m // plan.block_m) * -(-n // plan.block_n)
    assert blocks >= 4
    assert blocks > -(-m // 128) * -(-n // 128)


@pytest.mark.parametrize("sms, tile", [(132, 128), (160, 64), (1000, 32), (1, 128)])
def test_pipelined_tile_is_the_largest_that_covers_the_sms(sms, tile):
    """(512, 896)·(896, 4864): 152 blocks of 128, 608 of 64, 2,432 of 32."""
    assert plan_matmul(F32, 512, 896, 4864, ALIGNED, sms).block_m == tile


@pytest.mark.parametrize("shape, sms, block_n", [
    ((512, 896, 4864), 132, 192),  # 152 tiles of 128 (two waves) vs 104 of 192 (one)
    ((512, 896, 4864), 160, 128),  # 152 tiles of 128 fit one wave
    ((128, 128, 128), 132, 128),  # one tile either way: the narrower
    ((384, 256, 384), 132, 128),
])
def test_wgmma_width_minimises_the_last_wave(shape, sms, block_n):
    m, k, n = shape
    plan = plan_matmul(BF16, m, k, n, ALIGNED, sms)
    assert (plan.route, plan.block_m, plan.block_n) == ("wgmma", 128, block_n)
    assert all(w % 64 == 0 for w in WGMMA_BLOCK_NS)


@pytest.mark.parametrize("dtype, d, offset, route", [
    (BF16, 64, 0, "wgmma"),
    (BF16, 128, 0, "wgmma"),
    (BF16, 40, 0, "wgmma"),
    (BF16, 8, 0, "wgmma"),
    (BF16, 36, 0, "simt"),  # rows of 72 bytes: not 16-byte strided
    (BF16, 100, 0, "simt"),
    (BF16, 64, 2, "simt"),  # q one element off 16 bytes
    (BF16, 64, 16, "wgmma"),
    (F32, 64, 0, "simt"),  # f32 keeps the SIMT kernel
    (F32, 128, 0, "simt"),
])
def test_attention_route(dtype, d, offset, route):
    ptrs = (0x7F0000000000 + offset, 0x7F0000100000, 0x7F0000200000, 0x7F0000300000)
    assert attention_route(dtype, d, ptrs) == route
    assert route in ATTENTION_ROUTES


def test_every_route_is_counted():
    assert set(matmul.launches_by_route) == set(ROUTES)
    assert set(flash_attention.launches_by_route) == set(ATTENTION_ROUTES)


def test_every_configured_matmul_route_is_counted():
    assert set(configured_matmul.launches_by_route) == set(CONFIGURED_ROUTES)


@pytest.mark.parametrize("dtype, shape, ptrs, zp, route", [
    (I8, (512, 896, 4864), ALIGNED, (-8, 8), "wgmma"),  # qwen2-0.5b's MLP width
    (I8, (128, 128, 128), ALIGNED, (0, 0), "wgmma"),
    (I8, (5, 16, 16), ALIGNED, (5, -3), "wgmma"),  # any M; K, N multiples of 16
    (I8, (128, 4096, 128), ALIGNED, (-128, 127), "wgmma"),
    (I8, (128, INT8_WGMMA_MAX_K, 128), ALIGNED, (128, -128), "wgmma"),  # both limits, inclusive
    (I8, (128, 136, 128), ALIGNED, (0, 0), "simt"),  # K % 16 != 0: A's rows are not 16-byte strided
    (I8, (128, 128, 136), ALIGNED, (0, 0), "simt"),  # N % 16 != 0
    (I8, (70, 130, 33), ALIGNED, (-8, 7), "simt"),
    (I8, (64, 0, 16), ALIGNED, (0, 0), "simt"),  # K = 0
    (I8, (512, 896, 4864), (ALIGNED[0] + 1, ALIGNED[1]), (-8, 8), "simt"),  # A one byte off
    (I8, (512, 896, 4864), (ALIGNED[0], ALIGNED[1] + 8), (-8, 8), "simt"),  # B 8 bytes off
    (I8, (512, 896, 4864), ALIGNED, (129, 0), "simt"),  # |zp_a| past the exact epilogue
    (I8, (512, 896, 4864), ALIGNED, (0, -129), "simt"),
    (I8, (128, INT8_WGMMA_MAX_K + 16, 128), ALIGNED, (0, 0), "simt"),  # past int32 sums
    (F32, (512, 896, 4864), ALIGNED, (-8, 8), "simt"),  # f32 and bf16 keep the SIMT kernel
    (F32, (128, 128, 128), ALIGNED, (0, 0), "simt"),
    (BF16, (512, 896, 4864), ALIGNED, (-8, 8), "simt"),
    (BF16, (128, 128, 128), ALIGNED, (0, 0), "simt"),
])
def test_configured_matmul_route(dtype, shape, ptrs, zp, route):
    m, k, n = shape
    plan = plan_configured_matmul(dtype, m, k, n, ptrs, zp)
    assert plan.route == route
    assert route in CONFIGURED_ROUTES
    assert max(abs(z) for z in zp) <= INT8_WGMMA_MAX_ZP or route == "simt"


@pytest.mark.parametrize("shape, sms, block_n", [
    ((512, 896, 4864), 132, 192),  # 104 tiles of 192 in one wave, as bf16 matmul
    ((512, 896, 4864), 160, 128),
    ((128, 128, 128), 132, 128),
    ((128, 4096, 128), 132, 128),
])
def test_int8_wgmma_width_is_bf16_matmuls(shape, sms, block_n):
    m, k, n = shape
    plan = plan_configured_matmul(I8, m, k, n, ALIGNED, (-8, 8), sms)
    assert (plan.route, plan.block_m, plan.block_n) == ("wgmma", 128, block_n)
    assert plan.block_n == plan_matmul(BF16, m, k, n, ALIGNED, sms).block_n


def _check_top_k_plan(b, v, k, sms):
    plan = plan_top_k(b, v, k, sms)
    bounds = plan.bounds(v)
    assert 1 <= plan.splits <= TOP_K_MAX_SPLITS and len(bounds) == plan.splits
    assert bounds[0][0] == 0 and bounds[-1][1] == v
    assert all(stop > start for start, stop in bounds)  # every chunk non-empty
    assert all(b0[1] == b1[0] for b0, b1 in zip(bounds, bounds[1:]))
    assert plan.splits == 1 or plan.chunk % TOP_K_ALIGN == 0
    return plan


@pytest.mark.parametrize("b, v, k", [(1, 151, 8), (4, 151, 8), (4, 1000, 64), (3, 2047, 1),
                                     (133, 151_936, 8), (1024, 151_936, 4), (7, 2047, 64)])
def test_top_k_plan_keeps_short_rows_and_large_batches_whole(b, v, k):
    assert _check_top_k_plan(b, v, k, 132).splits == 1


@pytest.mark.parametrize("b, v, k", [(64, 151_936, 16), (64, 151_936, K_MAX), (1024, 151_936, 9),
                                     (4, 151_936, 33), (1, 10**7, K_MAX), (2, 4097, 16)])
def test_top_k_plan_cuts_radix_chunks_to_one_piece(b, v, k):
    """Above TOP_K_REGISTER_K each block selects from TOP_K_PIECE elements at
    a time: chunks are cut to one piece unless that needs more than
    TOP_K_MAX_SPLITS blocks."""
    assert k > TOP_K_REGISTER_K
    plan = _check_top_k_plan(b, v, k, 132)
    if -(-v // TOP_K_PIECE) <= TOP_K_MAX_SPLITS:
        assert plan.chunk <= TOP_K_PIECE
    else:
        assert plan.splits == TOP_K_MAX_SPLITS


@pytest.mark.parametrize("k", [1, 8, K_MAX])
def test_top_k_plan_fills_the_card_at_the_served_shape(k):
    """(4, 151,936) logits: about two blocks per SM, chunks of thousands."""
    plan = _check_top_k_plan(4, 151_936, k, 132)
    assert 0.9 * 2 * 132 <= 4 * plan.splits <= 2 * 132
    assert plan.chunk >= max(TOP_K_MIN_CHUNK, 32 * k)


@pytest.mark.parametrize("b, v, k, sms", [
    (1, 151_936, 8, 132), (1, 151_936, K_MAX, 132), (64, 151_936, 8, 132), (2, 151_936, 8, 132),
    (1, 10**7, 8, 1000), (7, 99_991, 5, 132), (4, 2048, 8, 132), (4, 2049, 8, 132),
])
def test_top_k_plan_chunks_cover_the_row(b, v, k, sms):
    plan = _check_top_k_plan(b, v, k, sms)
    assert plan.splits <= max(1, 2 * sms // b, -(-v // TOP_K_PIECE) if k > TOP_K_REGISTER_K else 1)
    assert plan.splits == 1 or plan.bounds(v)[-2][1] - plan.bounds(v)[-2][0] >= 32 * k
