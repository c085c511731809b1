"""The frozen FLOP and byte counts against hand-worked values."""

from __future__ import annotations

import pytest

from bench import harness
from bench.counts import dense, ssm

TINY_DENSE = {"hidden_size": 8, "num_hidden_layers": 2, "num_attention_heads": 2,
              "num_key_value_heads": 1, "head_dim": 4, "intermediate_size": 16,
              "vocab_size": 10, "tie_word_embeddings": True}
TINY_SSM = {"hidden_size": 8, "num_hidden_layers": 2, "head_size": 4,
            "intermediate_size": 16, "vocab_size": 10}


def test_dense_tiny():
    # a layer: attention 8*4*(2*2 + 2*1) = 192, MLP 3*8*16 = 384, norms 16
    assert dense.weight_bytes(TINY_DENSE) == 2 * (2 * 592 + 8 + 10 * 8)
    flops, nbytes = dense.step(TINY_DENSE, 3, 5)
    # K/V: 2 layers x 3 rows x 6 positions x (K and V of 1 head of 4) x 2 bytes
    assert nbytes == 2544 + 2 * 3 * 6 * 16
    # products (2 * 576 + the head 80) and attention (2 layers x 2 x 2 heads x 4 x 6)
    assert flops == 2 * 3 * (1232 + 192)


def test_dense_untied_reads_the_embedding_rows_and_the_head():
    c = dict(TINY_DENSE, tie_word_embeddings=False)
    assert dense.weight_bytes(c) == 2544 + 2 * 80
    assert dense.step(c, 3, 5)[1] == dense.weight_bytes(c) + 576 + 3 * 8 * 2


def test_ssm_tiny():
    # a layer: 6 * 8 * 8 + 2 * 8 * 16 = 640 in products, 96 in vectors
    assert ssm.weight_bytes(TINY_SSM) == 2 * (2 * (640 + 96) + 16 + 80)
    flops, nbytes = ssm.step(TINY_SSM, 3, 0)
    # 3 embedding rows; a layer's f32 state (8 x 4 a row) read and written, and
    # its two token-shift rows read and written
    assert nbytes == 3136 + 3 * 8 * 2 + 2 * 3 * (2 * 32 * 4 + 4 * 8 * 2)
    assert flops == 2 * 3 * (2 * 640 + 80) + 6 * 2 * 3 * 32
    assert ssm.step(TINY_SSM, 3, 100) == (flops, nbytes)


@pytest.mark.parametrize("cell,weights_gb,least_ms", [
    ("phi4mini-decode-b256-c256", 7.672, 3.582),  # at position 128
    ("phi4mini-decode-b128-c1152", 7.672, 5.180),  # at position 576
    ("rwkv6-decode-b256-s256", 14.499, 9.537),
])
def test_the_cells_bounds(cell, weights_gb, least_ms):
    c = harness.load_cell(cell)
    counts = c.module("counts")
    assert counts.weight_bytes(c.config) / 1e9 == pytest.approx(weights_gb, abs=1e-3)
    flops, nbytes = counts.step(c.config, c.traffic["batch"], c.traffic["steps"] // 2)
    assert max(flops / 989e12, nbytes / 3.35e12) * 1e3 == pytest.approx(least_ms, abs=1e-3)
