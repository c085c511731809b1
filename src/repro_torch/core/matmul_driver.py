"""Tiled matrix-multiplication program generators — the paper's workload (§6).

The port's own copy of ``repro/core/matmul_driver.py``: the code is the
reference's, unchanged.

Generates accfg IR that mirrors what the C/MLIR sources in the paper's
artifact compile to:

* :func:`opengemm_tiled_matmul` — K×K×K GeMM tiled as 8-by-K-by-8 calls into
  an OpenGeMM-style concurrent-configuration accelerator (§6.2). Per tile the
  host computes three pointers (base + row/col offsets) and writes ~11 CSRs
  (pointers, sizes, strides, zero-points).

* :func:`gemmini_tiled_matmul` — K×K×K GeMM tiled into ``loop_ws``-style
  weight-stationary macro-invocations on a Gemmini-style sequential target
  (§6.1), with the Table-1 field set (addresses, sizes+padding bit-packed the
  way Listing 1 does, strides, activation/transpose flags). Matrices beyond
  the scratchpad-capacity tile are covered by multiple invocations — which is
  exactly where deduplication starts to pay (§6.1: "smaller sizes only
  require a single invocation").

Both emit *naive-but-idiomatic* code: every invocation writes the full
configuration, constants re-materialized per iteration — precisely the shape
of the C APIs (Listing 1) that a compiler sees as opaque volatile asm.
"""

from __future__ import annotations

from .builder import Builder
from .ir import Module

ELEM_BYTES = 1  # int8 inputs
ACC_BYTES = 4  # int32 accumulators


def opengemm_tiled_matmul(k: int, tile_m: int = 8, tile_n: int = 8) -> Module:
    """C = A·B with A,B ∈ int8^{K×K}, tiled 8-by-K-by-8 (§6.2)."""
    assert k % tile_m == 0 and k % tile_n == 0
    b = Builder()
    with b.function("main"):
        base_a = b.const(0x1000_0000)
        base_b = b.const(0x2000_0000)
        base_c = b.const(0x3000_0000)
        lb = b.index(0)
        ub_i = b.index(k // tile_m)
        ub_j = b.index(k // tile_n)
        one = b.index(1)
        with b.for_(lb, ub_i, one) as (_loop_i, i, _):
            with b.for_(lb, ub_j, one) as (_loop_j, j, _):
                # pointer arithmetic the host must do per tile (T_calc, Eq. 4)
                row = b.mul(i, b.const(tile_m * k * ELEM_BYTES))
                col = b.mul(j, b.const(tile_n * ELEM_BYTES))
                ptr_a = b.add(base_a, row)
                ptr_b = b.add(base_b, col)
                crow = b.mul(i, b.const(tile_m * k * ACC_BYTES))
                ccol = b.mul(j, b.const(tile_n * ACC_BYTES))
                ptr_c = b.add(base_c, b.add(crow, ccol))
                state = b.setup(
                    "opengemm",
                    {
                        "ptr_a": ptr_a,
                        "ptr_b": ptr_b,
                        "ptr_c": ptr_c,
                        "M": b.const(tile_m),
                        "K": b.const(k),
                        "N": b.const(tile_n),
                        "lda": b.const(k * ELEM_BYTES),
                        "ldb": b.const(k * ELEM_BYTES),
                        "ldc": b.const(k * ACC_BYTES),
                        "zpa": b.const(0),
                        "zpb": b.const(0),
                    },
                )
                token = b.launch(state, "opengemm")
                b.await_(token)
    return b.module


def gemmini_tiled_matmul(k: int, max_tile: int = 64) -> Module:
    """C = A·B + D via weight-stationary ``loop_ws`` invocations (§6.1).

    One invocation covers an I×K'×J block of at most ``max_tile`` per dim
    (scratchpad capacity); larger problems iterate block-wise.
    """
    tile = min(k, max_tile)
    assert k % tile == 0
    blocks = k // tile
    b = Builder()
    with b.function("main"):
        base_a = b.const(0x8000_0000)
        base_b = b.const(0x9000_0000)
        base_d = b.const(0xA000_0000)
        base_c = b.const(0xB000_0000)
        lb = b.index(0)
        ub = b.index(blocks)
        one = b.index(1)
        with b.for_(lb, ub, one) as (_li, bi, _):
            with b.for_(lb, ub, one) as (_lj, bj, _):
                with b.for_(lb, ub, one) as (_lk, bk, _):
                    # addresses: base + block offsets (row-major int8 / int32)
                    a_off = b.add(
                        b.mul(bi, b.const(tile * k * ELEM_BYTES)),
                        b.mul(bk, b.const(tile * ELEM_BYTES)),
                    )
                    b_off = b.add(
                        b.mul(bk, b.const(tile * k * ELEM_BYTES)),
                        b.mul(bj, b.const(tile * ELEM_BYTES)),
                    )
                    c_off = b.add(
                        b.mul(bi, b.const(tile * k * ACC_BYTES)),
                        b.mul(bj, b.const(tile * ACC_BYTES)),
                    )
                    ptr_a = b.add(base_a, a_off)
                    ptr_b = b.add(base_b, b_off)
                    ptr_d = b.add(base_d, c_off)
                    ptr_c = b.add(base_c, c_off)
                    # Listing-1 style bit packing of sizes and padding
                    sizes = b.pack(
                        (b.const(tile), 0), (b.const(tile), 16), (b.const(tile), 32)
                    )
                    pads = b.pack((b.const(0), 0), (b.const(0), 16), (b.const(0), 32))
                    flags = b.pack((b.const(0), 0), (b.const(0), 1), (b.const(0), 2))
                    # config_ex / config_ld / config_st preamble that Gemmini's
                    # C API re-issues on every tiled_matmul invocation
                    ex_cfg = b.pack(
                        (b.const(1), 0),  # dataflow = WS
                        (b.const(0), 2),  # activation
                        (b.const(1), 16),  # sys_shift
                        (b.const(0), 32),  # a_transpose | b_transpose
                    )
                    ld_a = b.pack((b.const(k * ELEM_BYTES), 0), (b.const(1), 32))
                    ld_b = b.pack((b.const(k * ELEM_BYTES), 0), (b.const(1), 32))
                    ld_d = b.pack((b.const(k * ACC_BYTES), 0), (b.const(1), 32))
                    st_c = b.pack((b.const(k * ACC_BYTES), 0), (b.const(0), 32))
                    state = b.setup(
                        "gemmini",
                        {
                            "cfg_ex": ex_cfg,
                            "cfg_ex_scale": b.const(0),
                            "cfg_ld_a": ld_a,
                            "cfg_ld_b": ld_b,
                            "cfg_ld_d": ld_d,
                            "cfg_st_c": st_c,
                            "A": ptr_a,
                            "B": ptr_b,
                            "D": ptr_d,
                            "C": ptr_c,
                            "I": b.const(tile),
                            "J": b.const(tile),
                            "K": b.const(tile),
                            "sizes_pads": b.pack((sizes, 0)),
                            "pad_word": pads,
                            "stride_A": b.const(k * ELEM_BYTES),
                            "stride_B": b.const(k * ELEM_BYTES),
                            "stride_D": b.const(k * ACC_BYTES),
                            "stride_C": b.const(k * ACC_BYTES),
                            "act_flags": flags,
                        },
                    )
                    token = b.launch(state, "gemmini")
                    b.await_(token)
    return b.module
