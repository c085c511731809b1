"""The route rules of the port's matmul, configured_matmul and
flash_attention wrappers, flash_attention's staging and its split of each
query tile's keys across a cluster, and top_k's and greedy_sample's splits
of each row across blocks.

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
from repro_torch.kernels.flash_attention import ATTN_BLOCK_Q, ATTN_KEY_UNIT, ATTN_SPLITS, STAGINGS
from repro_torch.kernels.flash_attention import ROUTES as ATTENTION_ROUTES
from repro_torch.kernels.flash_attention import attention_route, attention_staging, flash_attention
from repro_torch.kernels.flash_attention import k_end as attention_k_end
from repro_torch.kernels.flash_attention import plan_attention
from repro_torch.kernels.matmul import (CONFIGURED_ROUTES, INT8_WGMMA_MAX_K, INT8_WGMMA_MAX_ZP,
                                        PIPELINED_TILES, ROUTES, WGMMA_BLOCK_NS,
                                        configured_matmul, matmul, plan_configured_matmul,
                                        plan_matmul)
from repro_torch.kernels.sampling import (GREEDY_ALIGN, GREEDY_CLUSTERS, GREEDY_MIN_CHUNK,
                                          GREEDY_PORTABLE_CLUSTER, K_MAX, TOP_K_ALIGN, TOP_K_MAX_SPLITS,
                                          TOP_K_MIN_CHUNK, TOP_K_PIECE, TOP_K_REGISTER_K,
                                          plan_greedy_sample, plan_top_k)

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


@pytest.mark.parametrize("dtype, d, offsets, staging", [
    (F32, 64, (0, 0, 0), "cp_async"),
    (F32, 128, (0, 0, 0), "cp_async"),
    (F32, 40, (0, 16, 32), "cp_async"),
    (F32, 36, (0, 0, 0), "cp_async"),  # 144-byte rows: whole 16-byte words
    (F32, 38, (0, 0, 0), "plain"),  # 152-byte rows
    (F32, 64, (4, 0, 0), "plain"),  # q one element off 16 bytes
    (F32, 64, (0, 0, 8), "plain"),  # v 8 bytes off
    (BF16, 64, (0, 0, 0), "plain"),  # bf16 tiles are converted as they are staged
    (BF16, 36, (0, 0, 0), "plain"),
])
def test_attention_staging(dtype, d, offsets, staging):
    ptrs = tuple(0x7F0000000000 + 0x100000 * i + off for i, off in enumerate(offsets))
    assert attention_staging(dtype, d, (*ptrs, 0x7F0000300004)) == staging  # out's address is not read
    assert staging in STAGINGS


def test_every_staging_is_counted():
    assert set(flash_attention.launches_by_staging) == set(STAGINGS)


def _check_attention_plan(bh, sq, sk, d, causal, sms=132):
    plan = plan_attention(bh, sq, sk, d, causal, sms)
    assert plan.block_q == ATTN_BLOCK_Q and plan.splits in ATTN_SPLITS
    tiles = -(-sq // plan.block_q)
    for t in range(tiles):
        end = attention_k_end(t * plan.block_q, plan.block_q, sq, sk, causal)
        ranges = plan.key_ranges(end)
        assert len(ranges) == plan.splits
        assert ranges[0][0] == 0 and ranges[-1][1] == end  # the ranges cover k_end exactly
        assert all(r0[1] == r1[0] for r0, r1 in zip(ranges, ranges[1:]))
        assert all(start % ATTN_KEY_UNIT == 0 for start, _ in ranges)  # whole units
        if -(-end // ATTN_KEY_UNIT) >= plan.splits:
            assert all(stop > start for start, stop in ranges)
    # the heaviest tile's keys give every split at least one unit
    assert plan.splits <= max(1, -(-sk // ATTN_KEY_UNIT))
    return plan


@pytest.mark.parametrize("s, d, _n", SHAPES["flash_attention"])
def test_attention_plan_gives_the_ladder_tens_of_blocks(s, d, _n):
    """The calibration ladder, (1, 1, S, D) full: 2-8 query tiles, which
    left 124-130 SMs idle; split 8 ways they are 16-64 blocks."""
    plan = _check_attention_plan(1, s, s, d, False)
    blocks = -(-s // plan.block_q) * plan.splits
    assert plan.splits == max(ATTN_SPLITS) and blocks >= 16


@pytest.mark.parametrize("causal", [True, False])
def test_attention_plan_fills_the_card_at_the_served_shape(causal):
    """(1, 14, 512, 64): 112 query tiles already fill most SMs; the plan
    splits at most in two (balancing the causal tiles' unequal keys), and
    the grid covers at least half the SMs."""
    plan = _check_attention_plan(14, 512, 512, 64, causal)
    blocks = 14 * -(-512 // plan.block_q) * plan.splits
    assert blocks >= 132 // 2 and plan.splits <= 2


@pytest.mark.parametrize("bh, sq, sk, d, causal", [
    (8, 1, 256, 64, True), (8, 1, 256, 64, False),  # decode: Sq = 1
    (2, 128, 256, 64, True), (2, 100, 300, 128, False), (2, 33, 65, 40, True),
    (2, 200, 200, 40, True), (2, 33, 33, 36, True), (1, 1, 1, 8, True), (3, 70, 17, 16, False),
    (4096, 512, 512, 64, True), (1, 5000, 5000, 128, True), (1, 64, 10**6, 64, False),
])
def test_attention_plan_ranges_cover_each_tiles_keys(bh, sq, sk, d, causal):
    plan = _check_attention_plan(bh, sq, sk, d, causal)
    if bh * -(-sq // plan.block_q) >= 132:
        assert plan.splits <= 2  # a grid that fills the card is split at most to balance it


@pytest.mark.parametrize("bh, sq, sk", [(1, 1, 256), (1, 512, 512), (14, 512, 512), (4096, 64, 64)])
def test_attention_plan_never_passes_the_portable_cluster(bh, sq, sk):
    for sms in (1, 8, 132, 10_000):
        assert plan_attention(bh, sq, sk, 64, True, sms).splits <= 8


def _check_greedy_plan(b, v, sms=132, wide=7):
    plan = plan_greedy_sample(b, v, sms, wide)
    bounds = plan.bounds(v)
    assert plan.cluster in GREEDY_CLUSTERS
    assert plan.cluster <= GREEDY_PORTABLE_CLUSTER or b <= wide  # every wide cluster fits at once
    assert len(bounds) == plan.cluster
    assert bounds[0][0] == 0 and bounds[-1][1] == v  # the chunks cover the row exactly
    assert all(b0[1] == b1[0] for b0, b1 in zip(bounds, bounds[1:]))
    assert all(stop > start for start, stop in bounds)  # every chunk non-empty
    assert plan.chunk % GREEDY_ALIGN == 0
    assert plan.cluster == 1 or plan.chunk >= GREEDY_MIN_CHUNK
    return plan


@pytest.mark.parametrize("shape", SHAPES["sampling"])
def test_greedy_plan_keeps_the_calibration_ladders_rows_whole(shape):
    b, _, v = shape
    assert _check_greedy_plan(b, v).cluster == 1


@pytest.mark.parametrize("b, cluster", [(1, 16), (4, 16), (7, 16), (8, 8), (16, 8), (17, 4),
                                        (64, 2), (66, 2), (67, 1), (256, 1)])
def test_greedy_plan_at_the_served_vocab(b, cluster):
    """V = 151,936 on an H100 (132 SMs, 7 clusters of 16 at once): about
    one block per SM over the grid. B = 64 fills 128 of 132 SMs; at B = 4
    the cluster of 16, the most one row can take, gives 64."""
    plan = _check_greedy_plan(b, 151_936)
    assert plan.cluster == cluster
    assert b * plan.cluster <= 132 or plan.cluster == 1
    if b >= 64:
        assert b * plan.cluster >= 132 // 2


@pytest.mark.parametrize("b", [1, 4, 7])
def test_greedy_plan_stays_portable_where_the_card_holds_no_wide_cluster(b):
    assert _check_greedy_plan(b, 151_936, wide=0).cluster == GREEDY_PORTABLE_CLUSTER
    assert _check_greedy_plan(b, 151_936, wide=b - 1).cluster == GREEDY_PORTABLE_CLUSTER


@pytest.mark.parametrize("b, v, sms, wide", [
    (1, 151_936, 132, 7), (4, 151_936, 132, 0), (1, 10**7, 10_000, 7), (1, 10**7, 10_000, 0),
    (2, 16_384, 132, 7), (2, 16_383, 132, 7), (3, 99_991, 132, 7), (1, 1, 132, 7), (5, 8200, 1, 7),
])
def test_greedy_plan_chunks_cover_the_row_and_respect_the_cap(b, v, sms, wide):
    plan = _check_greedy_plan(b, v, sms, wide)
    assert b * plan.cluster <= max(sms, b)
    assert plan.cluster <= max(GREEDY_CLUSTERS)
