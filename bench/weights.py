"""Weights that the benchmark draws from the seed and hands to both sides.

The tree (names, shapes, types) is the program's, read from the program's
parameters on the ``meta`` device, so the program serves the tensors as
they are; every number in them is the benchmark's. One normal draw a type
fills one flat buffer on the device, from a ``torch.Generator`` seeded with
``--seed``; each leaf is a view of it, scaled and shifted in place by the
rule of its family's reference (``reference.<family>.init_rule``).
"""

from __future__ import annotations

import torch

ALIGN = 64  # elements: every leaf starts 128 bytes or more into its buffer


def leaves(tree: dict, prefix: tuple = ()):
    """``(path, tensor)`` of every leaf, in the tree's order."""
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def _put(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def draw(shapes: dict, rule, seed: int, device: str | torch.device) -> dict:
    """A tree like ``shapes`` (tensors whose shape and type are used) on
    ``device``: leaf ``path`` is ``mean + std * N(0, 1)`` with ``(mean, std)
    = rule(path, shape)``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    sizes: dict[torch.dtype, int] = {}
    plan = []
    for path, leaf in leaves(shapes):
        offset = sizes.get(leaf.dtype, 0)
        plan.append((path, leaf, offset))
        sizes[leaf.dtype] = offset + -(-leaf.numel() // ALIGN) * ALIGN
    flats = {dtype: torch.randn(sizes[dtype], generator=gen, dtype=dtype, device=device)
             for dtype in sorted(sizes, key=str)}
    out: dict = {}
    for path, leaf, offset in plan:
        view = flats[leaf.dtype][offset:offset + leaf.numel()].view(leaf.shape)
        mean, std = rule(path, tuple(leaf.shape))
        view.mul_(std)
        if mean:
            view.add_(mean)
        _put(out, path, view)
    return out


def fan_in_std(path: tuple, shape: tuple) -> float:
    """1/sqrt(fan_in) of a matrix: its first axis, a layer's where the leaf
    is stacked under ``layers``."""
    per_layer = shape[1:] if path[0] == "layers" else shape
    return per_layer[0] ** -0.5
