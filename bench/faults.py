"""Faults planted in the program's RWKV time mix, for the readings that show
that the rwkv cell's comparison catches them (``bench/readings.py --fault``)
and for the benchmark's tests. Each is a context manager that replaces one
function of ``repro_torch.models.layers`` (looked up by name at each call)
and puts it back."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(name: str, make):
    from repro_torch.models import layers

    original = getattr(layers, name)
    setattr(layers, name, make(original))
    try:
        yield
    finally:
        setattr(layers, name, original)


def decay_squared(n_layers: int):
    """A wrong decay: ``w ** 2`` in place of ``w`` in every layer."""
    return _patched("_rwkv_decay", lambda f: lambda params, xw: f(params, xw).square())


def bonus_dropped(n_layers: int):
    """The bonus ``u`` of the current token left out in every layer."""
    return _patched("_wkv_step", lambda f: lambda r, k, v, w, u, state:
                    f(r, k, v, w, torch.zeros_like(u), state))


def state_frozen_layer0(n_layers: int):
    """The first layer's state never updated: each step returns it as it was.
    A decode step calls the recurrence once a layer, in order."""
    seen = [0]

    def make(f):
        def step(r, k, v, w, u, state):
            out, new = f(r, k, v, w, u, state)
            first = seen[0] % n_layers == 0
            seen[0] += 1
            return out, (state if first else new)
        return step

    return _patched("_wkv_step", make)


TIME_MIX = {"decay_squared": decay_squared, "bonus_dropped": bonus_dropped,
            "state_frozen_layer0": state_frozen_layer0}
