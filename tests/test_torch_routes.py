"""The route rules of the port's matmul and flash_attention wrappers.

Each wrapper chooses its kernel on a CUDA tensor by a pure function of the
type, the shape and the operands' addresses (``plan_matmul``,
``attention_route``), so the rule is held here on the CPU; the kernels
behind each route are held to their plain versions on the card
(``test_torch_ops.py``'s ``gpu`` tests, ``chip_smoke.py``)."""

from __future__ import annotations

import pytest
import torch

from repro_torch.engine.calibrate import SHAPES
from repro_torch.kernels.flash_attention import ROUTES as ATTENTION_ROUTES
from repro_torch.kernels.flash_attention import attention_route, flash_attention
from repro_torch.kernels.matmul import (PIPELINED_TILES, ROUTES, WGMMA_BLOCK_NS, matmul,
                                        plan_matmul)

BF16, F32 = torch.bfloat16, torch.float32
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
