"""The port's RWKV-6 decode step (rwkv6-7b): every weight read once (six
d x d time-mix matrices, the channel mix's two, the vectors, the untied
head and the batch's embedding rows), at 2 bytes an element (bf16); each
layer's f32 state (heads x head_size^2 a row) read once and written once,
and its two token-shift rows (bf16). FLOPs: 2 a multiply-add of the
products over the batch, and 6 an element of the state update and read."""

from __future__ import annotations

BYTES = 2  # bf16, the served type
STATE_BYTES = 4  # the recurrent state is f32


def _layer_params(c: dict) -> int:
    d = c["hidden_size"]
    return 6 * d * d + 2 * d * c["intermediate_size"]


def weight_bytes(c: dict) -> int:
    d, v = c["hidden_size"], c["vocab_size"]
    vectors = 5 * d + 2 * d + d + 4 * d  # mixes, decay bias and bonus, channel mix, norms
    return BYTES * (c["num_hidden_layers"] * (_layer_params(c) + vectors) + 2 * d + d * v)


def step(c: dict, batch: int, pos: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one step; the state has no position, so ``pos``
    changes nothing."""
    n, d, v, hs = c["num_hidden_layers"], c["hidden_size"], c["vocab_size"], c["head_size"]
    state = d * hs  # heads x head_size x head_size of one row
    nbytes = (weight_bytes(c) + batch * d * BYTES
              + n * batch * (2 * state * STATE_BYTES + 2 * 2 * d * BYTES))
    flops = 2.0 * batch * (n * _layer_params(c) + d * v) + 6.0 * n * batch * state
    return flops, float(nbytes)
