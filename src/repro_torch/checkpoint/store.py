"""Checkpointing: atomic, async, integrity-checked save/restore of trees
of tensors.

The counterpart of ``repro/checkpoint/store.py``, writing and reading the
reference's on-disk format, so a checkpoint written by either package
restores in the other bit for bit:

* ``step_N/`` holds one ``.npy`` file a leaf (a flat uint8 array of the
  leaf's bytes, as ``np.save`` writes it) and ``manifest.json`` with each
  leaf's ``file``, ``crc32`` (of the whole file), ``shape`` and ``dtype``
  (numpy's name; bf16 as ``"bfloat16"``, carried as its 16-bit pattern).
* Leaves are keyed as the reference's ``_flatten`` spells them: dict keys
  bare, sequence items ``[i]``, joined by ``/`` (a ``(params, opt_state)``
  state gives ``[0]/embed``, ``[1]/step``, ``[1]/master/embed``, ...).
* **Atomicity** — writes go to ``step_N.tmp/`` and are renamed into place;
  a crash mid-save never corrupts the restore set.
* **Async save** — the host copies are taken before the writer thread
  starts (the train loop pays the device→host copy), so a train step that
  follows cannot change what the thread writes.
* **Integrity** — restore checks every file's CRC before handing the tree
  back.
* **Leaves** are tensors or numpy arrays (``fabric.ContextStore`` saves
  its snapshots as ``uint8`` arrays, as it does through the reference's
  store).
* **Placement on restore** — each leaf goes to the device of its leaf in
  ``like_tree``, or to the device named for it in ``devices``, or, as the
  reference's ``shardings`` place it, onto a mesh as a DTensor with the
  placements named for it in ``placements``.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import zlib

import numpy as np
import torch

from ..distributed.spmd import place


def _to_host(x: torch.Tensor | np.ndarray) -> tuple[np.ndarray, str]:
    """A copy of ``x`` (a tensor or a numpy array) on the host as (array,
    numpy dtype name); a bf16 tensor as its 16-bit pattern, which numpy has
    no dtype for."""
    if isinstance(x, np.ndarray):
        arr = np.array(x, copy=True)
        return arr, arr.dtype.name
    x = x.detach().to("cpu", copy=True)
    if x.dtype == torch.bfloat16:
        return x.view(torch.int16).numpy(), "bfloat16"
    arr = x.numpy()
    return arr, arr.dtype.name


def _from_host(raw: np.ndarray, dtype: str, shape: list) -> torch.Tensor:
    """The tensor whose bytes ``raw`` (flat uint8) holds."""
    if dtype == "bfloat16":
        return torch.from_numpy(raw.view(np.int16).reshape(shape)).view(torch.bfloat16)
    return torch.from_numpy(raw.view(np.dtype(dtype)).reshape(shape))


def _flatten(tree, prefix: str = "") -> dict:
    """``{key: leaf}`` in the reference's key spelling and leaf order (dict
    keys sorted, ``None`` an empty subtree)."""

    def join(part: str) -> str:
        return f"{prefix}/{part}" if prefix else part

    if isinstance(tree, dict):
        return {k: v for key in sorted(tree) for k, v in _flatten(tree[key], join(key)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, item in enumerate(tree)
                for k, v in _flatten(item, join(f"[{i}]")).items()}
    if tree is None:
        return {}
    return {prefix: tree}


def _flatten_dicts(tree, prefix: str = "") -> dict:
    """:func:`_flatten` of a tree whose leaves are tuples (placements)."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flatten_dicts(tree[key], f"{prefix}/{key}" if prefix else key).items()}
    return {prefix: tree}


def _rebuild(tree, flat: dict, prefix: str = ""):
    """A tree of ``tree``'s structure whose leaf at each key is ``flat[key]``."""

    def join(part: str) -> str:
        return f"{prefix}/{part}" if prefix else part

    if isinstance(tree, dict):
        return {k: _rebuild(v, flat, join(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, flat, join(f"[{i}]")) for i, v in enumerate(tree))
    if tree is None:
        return None
    return flat[prefix]


class CheckpointStore:
    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._pending: threading.Thread | None = None

    # ------------------------------------------------------------------ save

    def save(self, step: int, tree, blocking: bool = True) -> None:
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        if blocking:
            self._write(step, host)
        else:
            self.wait()
            self._pending = threading.Thread(
                target=self._write, args=(step, host), daemon=True
            )
            self._pending.start()

    def wait(self) -> None:
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def _write(self, step: int, host: dict) -> None:
        tmp = os.path.join(self.directory, f"step_{step}.tmp")
        final = os.path.join(self.directory, f"step_{step}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        manifest = {"step": step, "arrays": {}}
        for key, (arr, dtype) in host.items():
            fn = key.replace("/", "__") + ".npy"
            path = os.path.join(tmp, fn)
            np.save(path, np.ascontiguousarray(arr).reshape(-1).view(np.uint8))
            with open(path, "rb") as f:
                crc = zlib.crc32(f.read())
            manifest["arrays"][key] = {
                "file": fn,
                "crc32": crc,
                "shape": list(arr.shape),
                "dtype": dtype,
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
        shutil.rmtree(final, ignore_errors=True)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)

    # --------------------------------------------------------------- restore

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and not name.endswith(".tmp"):
                if os.path.exists(os.path.join(self.directory, name, "manifest.json")):
                    out.append(int(name.split("_", 1)[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def keys(self, step: int) -> list[str]:
        """Leaf keys recorded in one step's manifest — lets callers restore
        without already holding a template tree."""
        with open(os.path.join(self.directory, f"step_{step}", "manifest.json")) as f:
            return sorted(json.load(f)["arrays"])

    def restore(self, step: int, like_tree, devices=None, placements=None, mesh=None):
        """Restore into the structure of ``like_tree``, each leaf on the device
        of its ``like_tree`` leaf, or on the one ``devices`` (a tree of
        devices, ``None`` where the like leaf's device stands) names; or,
        given ``placements`` (a tree of the ``distributed.*_shardings``) and
        ``mesh``, as a DTensor on the mesh with its placements, each rank
        keeping its shard of the saved array (reshard-on-restore; the files
        are the same as for an unsharded save). A numpy leaf of
        ``like_tree`` comes back as a numpy array on the host
        (``fabric.ContextStore`` restores its ``uint8`` snapshots so)."""
        base = os.path.join(self.directory, f"step_{step}")
        with open(os.path.join(base, "manifest.json")) as f:
            manifest = json.load(f)
        flat_like = _flatten(like_tree)
        flat_dev = _flatten(devices) if devices is not None else {}
        flat_placed = _flatten_dicts(placements) if placements is not None else {}
        leaves = {}
        for key, like in flat_like.items():
            meta = manifest["arrays"][key]
            path = os.path.join(base, meta["file"])
            with open(path, "rb") as f:
                crc = zlib.crc32(f.read())
            if crc != meta["crc32"]:
                raise IOError(f"checkpoint corruption: CRC mismatch for {key}")
            raw = np.load(path)
            if isinstance(like, np.ndarray):
                leaves[key] = raw.view(np.dtype(meta["dtype"])).reshape(meta["shape"])
            else:
                arr = _from_host(raw, meta["dtype"], meta["shape"])
                if key in flat_placed:
                    leaves[key] = place(arr, mesh, flat_placed[key])
                else:
                    leaves[key] = arr.to(flat_dev.get(key, like.device))
        return _rebuild(like_tree, leaves)
