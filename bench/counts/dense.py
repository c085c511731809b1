"""A dense GQA decoder's decode step (phi4-mini-3.8b): every weight read
once (the tied embedding once, as the head), each layer's K/V rows before
the step's position read once and the new row written, at 2 bytes an
element (bf16). FLOPs: 2 a multiply-add of the projections, the MLP and the
head over the batch, and of the scores and the weighted sum over the
``pos + 1`` positions each row attends to."""

from __future__ import annotations

BYTES = 2  # bf16, the served type


def _layer_params(c: dict) -> int:
    d, hd = c["hidden_size"], c["head_dim"]
    attn = d * hd * (2 * c["num_attention_heads"] + 2 * c["num_key_value_heads"])
    return attn + 3 * d * c["intermediate_size"] + 2 * d  # + the two norms


def weight_bytes(c: dict) -> int:
    d, v = c["hidden_size"], c["vocab_size"]
    table = v * d * (1 if c["tie_word_embeddings"] else 2)
    return BYTES * (c["num_hidden_layers"] * _layer_params(c) + d + table)


def step(c: dict, batch: int, pos: int) -> tuple[float, float]:
    """(FLOPs, bytes) of the step that writes position ``pos``."""
    n, d, v, hd = c["num_hidden_layers"], c["hidden_size"], c["vocab_size"], c["head_dim"]
    kv_row = 2 * c["num_key_value_heads"] * hd * BYTES  # K and V of one position, one layer
    nbytes = weight_bytes(c) + n * batch * (pos + 1) * kv_row
    if not c["tie_word_embeddings"]:
        nbytes += batch * d * BYTES  # the embedding rows, beside the head
    products = n * (_layer_params(c) - 2 * d) + d * v
    attend = n * 2 * c["num_attention_heads"] * hd * (pos + 1)  # scores and weighted sum
    return 2.0 * batch * (products + attend), float(nbytes)
