"""Trees of tensors: nested dicts, lists and tuples, walked as ``jax.tree``
walks them (dict keys sorted, ``None`` an empty subtree), for the
training path's optimizer, step and supervisor."""

from __future__ import annotations

from .dispatch.executor import flatten_with_path


def leaves(tree) -> list:
    """The leaves in ``jax.tree.leaves`` order."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of each of
    ``rest``, which share its structure; returns a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def unflatten(tree, flat: list):
    """A tree of ``tree``'s structure whose leaves are ``flat``, taken in
    :func:`leaves` order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            done = {k: build(t[k]) for k in sorted(t)}
            return {k: done[k] for k in t}
        if isinstance(t, (list, tuple)):
            return type(t)(build(v) for v in t)
        return None if t is None else next(it)

    return build(tree)
