"""Sharding rules: DP / TP / EP / ZeRO over the production mesh, as DTensor
placements.

The counterpart of ``repro/distributed/sharding.py``, rule for rule. Each
rule first gives the reference's ``PartitionSpec`` in a pure form, a tuple
with one entry a tensor dim: ``None``, a mesh axis name, or a tuple of axis
names (``*_specs``), computed from the mesh's axis names and sizes alone,
so a test compares it entry by entry with the reference's and no process
group is needed. :func:`placements` turns a spec into DTensor placements
over a ``DeviceMesh`` (one ``Shard(dim)`` or ``Replicate()`` a mesh dim),
and the ``*_shardings`` functions give whole trees of them.

Rules are *divisibility-aware*: a dim is only sharded along a mesh axis when
its size divides evenly. qwen2.5-32b has 40 heads and qwen2-0.5b has 14,
neither divisible by the 16-way model axis, so those archs shard the packed
``heads×head_dim`` projection dim and DTensor reshards around the split
into heads (a reshape of a sharded dim it cannot keep sharded), as GSPMD
reshards around the reference's attention einsum.

Scheme:
* batch dims            → ("pod","data") (DP across pods and the data axis;
                          a step runs it on one merged mesh dim,
                          :func:`step_mesh`)
* attn/MLP in-proj      → model axis on the output (TP, Megatron-style)
* attn/MLP out-proj     → model axis on the input
* MoE expert stacks     → model axis on the expert dim (EP)
* embeddings            → vocab on model axis (falls back to d_model)
* norms/scalars/biases  → replicated
* optimizer states      → param spec + the largest remaining dim sharded
                          along the data axis (ZeRO-style state partitioning)
* KV caches             → batch on data; kv-heads on model when divisible,
                          else head_dim on model (long_500k's batch=1 case)

Paths are the key names of the port's trees, in sorted-key order. A mesh
is a ``DeviceMesh`` with named dims or a ``{axis name: size}`` dict in the
mesh's order.
"""

from __future__ import annotations

import math

from torch.distributed.tensor import Replicate, Shard

from ..models.config import ModelConfig
from .spmd import is_merged, merge


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of such a dict, in the
    mesh's order."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def batch_axes(mesh, cfg: ModelConfig | None = None) -> tuple[str, ...]:
    axes = ("pod", "data") if "pod" in axis_sizes(mesh) else ("data",)
    if cfg is not None and cfg.pure_dp:
        axes = axes + ("model",)  # batch over every axis: 256/512-way DP
    return axes


def step_mesh(mesh, cfg: ModelConfig | None = None):
    """The ``DeviceMesh`` a step over ``mesh`` (the reference's axes) runs
    on: the batch axes (:func:`batch_axes`) merged into one dim of the same
    ranks, pod-major (``spmd.merge``: ``pod_data``, 32 devices, beside
    ``model`` at 2×16×16; ``data_model`` under ``pure_dp``), the other axes
    as they are; ``mesh`` itself where the batch is one axis (every 16×16
    cell but ``pure_dp``) or ``mesh`` is a step mesh already. So no tensor
    dim is ever split over two mesh dims, which torch 2.11's DTensor
    refuses ("hybrid sharding strategies"), and every torch plans the
    batch over one group. The arguments keep ``mesh`` and the reference's
    placements (:func:`placements`); ``launch.steps`` carries them over
    (``spmd.onto``)."""
    axes = batch_axes(mesh, cfg)
    if len(axes) == 1 or is_merged(mesh):
        return mesh
    return merge(mesh, axes)


def _div(mesh, dim: int, axis: str) -> str | None:
    return axis if dim % axis_sizes(mesh)[axis] == 0 and dim > 0 else None


def _apply_fsdp(mesh, spec: tuple, shape: tuple[int, ...]) -> tuple:
    """Additionally shard the largest unsharded divisible dim along data."""
    data = axis_sizes(mesh)["data"]
    spec = list(spec)
    best, best_dim = -1, -1
    for i, (dim, ax) in enumerate(zip(shape, spec)):
        if ax is None and dim % data == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best >= 0:
        spec[best] = "data"
    return tuple(spec)


_ATTN_PARAMS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")
# rwkv time-mix: TP here puts a cross-shard reduce inside every step of the
# 4096-long sequence scan; tp_attention=0 replicates the mixer the same way
_MIXER_CTX = {"attn", "self_attn", "cross_attn", "tm"}
_RWKV_TM_PARAMS = ("wr", "wk", "wv", "wg", "wo", "w_decay")


def _spec_for_param(mesh, path: tuple[str, ...], shape: tuple[int, ...],
                    cfg: ModelConfig | None = None) -> tuple:
    name = path[-1]
    ctx = set(path)
    nd = len(shape)
    fsdp = cfg is not None and cfg.fsdp

    if cfg is not None and cfg.pure_dp:
        return (None,) * nd  # fully replicated; batch takes every axis

    if (cfg is not None and not cfg.tp_attention
            and (name in _ATTN_PARAMS or name in _RWKV_TM_PARAMS) and ctx & _MIXER_CTX):
        spec = (None,) * nd  # replicate attention, TP only in the MLPs
        return _apply_fsdp(mesh, spec, shape) if fsdp else spec

    def trailing(*axes):
        """Pad leading stack dims (stacked layers/groups) with None."""
        spec = (None,) * (nd - len(axes)) + axes
        return _apply_fsdp(mesh, spec, shape) if fsdp else spec

    if name == "embed":
        v, d = shape[-2], shape[-1]
        ax = _div(mesh, v, "model")
        if ax:
            return (ax, None)
        return (None, _div(mesh, d, "model"))
    if name == "head":
        return (None, _div(mesh, shape[-1], "model"))

    # MoE expert stacks: (…, E, d, ff) / (…, E, ff, d) — EP on the expert dim
    if ctx & {"moe", "mamba_moe"} or name == "router":
        if name == "router":
            return (None,) * nd
        ax = _div(mesh, shape[-3], "model")
        if ax:
            spec = (None,) * (nd - 3) + (ax, None, None)
            # the shard_map MoE consumes experts at exactly EP sharding; FSDP
            # must not add a data dim there
            if fsdp and cfg.moe_impl != "shard_map":
                spec = _apply_fsdp(mesh, spec, shape)
            return spec
        return trailing(None, None, _div(mesh, shape[-1], "model"))

    if nd >= 2:
        din, dout = shape[-2], shape[-1]
        # column-parallel (shard output dim): qkv projections, MLP in/gate,
        # mamba in_proj & conv, rwkv r/k/v/g/decay
        if name in ("wq", "wk", "wv", "wi", "wg", "in_proj", "conv_w", "wr", "w_decay"):
            return trailing(None, _div(mesh, dout, "model"))
        # row-parallel (shard input dim): output projections
        if name in ("wo", "out_proj", "x_proj", "a_log"):
            return trailing(_div(mesh, din, "model"), None)
    if nd >= 1 and name in ("bq", "bk", "bv", "dt_bias", "d_skip"):
        return trailing(_div(mesh, shape[-1], "model"))
    # norms, scalar mixes, biases: replicated
    return (None,) * nd


def named_leaves(tree, prefix: tuple[str, ...] = ()):
    """``(key path, leaf)`` of a tree of dicts, dict keys sorted, as the
    reference's ``tree_flatten_with_path`` names them."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from named_leaves(tree[k], prefix + (k,))
    elif tree is not None:
        yield prefix, tree


def _map_with_paths(tree, fn, prefix: tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _map_with_paths(v, fn, prefix + (k,)) for k, v in tree.items()}
    return fn(prefix, tree)


def param_specs(mesh, abstract_params, cfg: ModelConfig | None = None):
    return _map_with_paths(abstract_params,
                           lambda names, leaf: _spec_for_param(mesh, names, leaf.shape, cfg))


def opt_state_specs(mesh, abstract_opt_state, cfg: ModelConfig | None = None):
    """ZeRO-style: the master/m/v leaves take the param spec plus one extra
    dim sharded along the data axis (largest unsharded divisible dim)."""
    data = axis_sizes(mesh)["data"]

    def fn(names, leaf):
        if names[0] == "step":
            return ()
        spec = list(_spec_for_param(mesh, names[1:], leaf.shape, cfg))  # strip master/m/v
        if "data" not in spec:  # FSDP params already consume the data axis
            best, best_dim = -1, -1
            for i, (dim, ax) in enumerate(zip(leaf.shape, spec)):
                if ax is None and dim % data == 0 and dim > best_dim:
                    best, best_dim = i, dim
            if best >= 0:
                spec[best] = "data"
        return tuple(spec)

    return _map_with_paths(abstract_opt_state, fn)


def input_specs(mesh, specs: dict, cfg: ModelConfig | None = None):
    b = batch_axes(mesh, cfg)
    total = math.prod(axis_sizes(mesh)[a] for a in b)

    def fn(names, leaf):
        batch = b if leaf.shape[0] % total == 0 else None
        return (batch,) + (None,) * (leaf.dim() - 1)

    return _map_with_paths(specs, fn)


def cache_specs(mesh, cfg: ModelConfig, abstract_cache):
    b_axes = batch_axes(mesh)
    data = math.prod(axis_sizes(mesh)[a] for a in b_axes)

    def fn(names, leaf):
        name, shape = names[-1], tuple(leaf.shape)
        if name in ("k", "v", "xk", "xv", "k_scale", "v_scale"):
            # (L, B, S, Hkv, D) — scales are D=1 companions of a quantized cache
            batch = b_axes if shape[1] % data == 0 else None
            if cfg.cache_shard_seq and _div(mesh, shape[2], "model"):
                # flash-decoding layout: shard the sequence dim
                return (None, batch, "model", None, None)
            hkv = _div(mesh, shape[3], "model")
            hd = None if hkv else _div(mesh, shape[4], "model")
            return (None, batch, None, hkv, hd)
        if name == "h":  # (G, m, B, d_in, N)
            batch = b_axes if shape[2] % data == 0 else None
            return (None, None, batch, _div(mesh, shape[3], "model"), None)
        if name == "conv":  # (G, m, B, K, d_in)
            batch = b_axes if shape[2] % data == 0 else None
            return (None, None, batch, None, _div(mesh, shape[4], "model"))
        if name == "s":  # (L, B, H, hd, hd)
            batch = b_axes if shape[1] % data == 0 else None
            return (None, batch, _div(mesh, shape[2], "model"), None, None)
        if name in ("shift_tm", "shift_cm"):  # (L, B, d)
            batch = b_axes if shape[1] % data == 0 else None
            return (None, batch, _div(mesh, shape[2], "model"))
        return (None,) * len(shape)

    return _map_with_paths(abstract_cache, fn)


# --------------------------------------------------------------------------
# Specs as DTensor placements
# --------------------------------------------------------------------------


def _axes_of(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh, spec: tuple) -> tuple:
    """One placement a mesh dim: ``Shard(d)`` where tensor dim ``d``'s entry
    names the mesh axis, else ``Replicate()``. A dim sharded over several
    axes lists them in the mesh's order, major first, as a
    ``PartitionSpec`` tuple does and DTensor shards them. An axis of one
    device replicates (its one shard is the whole tensor; DTensor refuses
    some views of a dim "sharded" one way that it takes replicated)."""
    sizes = axis_sizes(mesh)
    names = list(sizes)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = _axes_of(entry)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"dim {d} is sharded over {axes}, not in the mesh's order {names}")
        for a in axes:
            if sizes[a] > 1:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def shard_shape(mesh, shape: tuple[int, ...], spec: tuple) -> tuple[int, ...]:
    """A device's local shape of a leaf of ``shape`` under ``spec``: the
    reference's ``NamedSharding.shard_shape``."""
    sizes = axis_sizes(mesh)
    return tuple(dim // math.prod(sizes[a] for a in _axes_of(entry))
                 for dim, entry in zip(shape, spec))


def to_placements(mesh, spec_tree):
    """A tree of specs as a tree of placements over ``mesh``."""
    if isinstance(spec_tree, dict):
        return {k: to_placements(mesh, v) for k, v in spec_tree.items()}
    return placements(mesh, spec_tree)


def param_shardings(mesh, abstract_params, cfg: ModelConfig | None = None):
    return to_placements(mesh, param_specs(mesh, abstract_params, cfg))


def opt_state_shardings(mesh, abstract_opt_state, cfg: ModelConfig | None = None):
    return to_placements(mesh, opt_state_specs(mesh, abstract_opt_state, cfg))


def input_shardings(mesh, specs: dict, cfg: ModelConfig | None = None):
    return to_placements(mesh, input_specs(mesh, specs, cfg))


def cache_shardings(mesh, cfg: ModelConfig, abstract_cache):
    return to_placements(mesh, cache_specs(mesh, cfg, abstract_cache))
