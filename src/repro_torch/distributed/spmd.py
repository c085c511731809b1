"""Running the port's model code on DTensors over a mesh.

The reference runs one program over a mesh by ``jax.jit`` with sharded
arguments: GSPMD propagates the shardings and inserts the collectives. The
port runs its model code unchanged on DTensors, whose sharding propagation
does the same op by op, under :func:`sharded`:

* ``implicit_replication``: a plain tensor the code makes (``torch.arange``
  positions, masks, zero accumulators) counts as replicated on the mesh;
* the ambient mesh (:func:`use_mesh`, :func:`ambient_mesh`), which
  ``moe_impl="shard_map"`` reads to run its expert all-to-all, as the
  reference's ``_moe_shard_map`` reads ``jax.sharding.get_abstract_mesh``;
* :class:`ShardedOps`, the rules the port sets where DTensor's own differ
  from GSPMD's or fail, on every op DTensor is given (the backward's and a
  checkpointed layer's recomputation's too):

  1. A bf16 product (``mm``, ``bmm``: ``@`` and the einsums) whose
     contraction dim is split across a mesh axis of more than one device
     sums its partial products in float32, reduces them in float32 and
     rounds to bf16 once, as one device's float32 accumulator does. The
     operands stay bf16: the product is ``mm``/``bmm``'s ``out_dtype``
     overload (cuBLAS's bf16 inputs, float32 accumulator and output; the
     meta kernel in the dry run), to which :func:`_mm_f32_out` and
     :func:`_bmm_f32_out` give DTensor ``mm``'s and ``bmm``'s own
     placements. The CPU, which has no such kernel, multiplies the
     operands converted to float32, exactly.
     DTensor's own rule rounds each device's partial sum to bf16 and
     reduces in bf16, which moves paper-lm-100m's reduced loss past 1e-4
     at a 2-way model axis (``tests/test_torch_distributed.py``). A weight
     gradient's product sums over the tokens, split across the batch
     axes: that reduction is the gradient's across ``data``, and runs in
     bf16 under ``grad_compression="bf16"``.
  2. A view DTensor refuses (qwen2-0.5b's packed ``heads×head_dim`` dim,
     896 = 14 × 64, split 16 ways into 56-wide shards and viewed as heads:
     "Cannot unflatten unevenly sharded tensor"; the MoE gathers' backward,
     whose token dim comes back split 256 ways and is viewed as (B, S))
     runs on the dims it changes gathered, as GSPMD reshards around the
     reference's attention einsum.
  3. A scatter-add (``index_put`` with ``accumulate``: the embedding's
     backward, the MoE dispatch and combine) of rows split across a mesh
     axis scatters locally into a partial sum (:func:`_index_put`; torch
     2.11's own rule fails on the embedding's backward).
  4. ``gather`` along a split dim, or of a partial sum (``Model.loss``'s
     gold logit over vocabulary-sharded or partial logits), reduces and
     gathers first: DTensor's masked partial there fails its own
     reduction (torch 2.13: "too many indices").
  5. An op DTensor has no rule for (``searchsorted``: the MoE dispatch's
     expert starts) runs on its arguments gathered whole (``REPLICATED``
     lists those met).
  6. A constant pad (``F.pad``: the Mamba convolution's causal pad, the
     RWKV token shift) pads each rank's shard, a padded dim that is split
     gathered first (:func:`_pad`). torch 2.11's own rule plans a
     redistribution its planner then fails on ("list index out of
     range") for jamba's pad of a model-split ``in_proj`` half.

On a mesh whose every axis has one device nothing is split
(``sharding.placements`` replicates such an axis): every op runs on the
whole tensor and the numbers are the one-device path's bit for bit.
"""

from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication, register_sharding
from torch.utils._python_dispatch import TorchDispatchMode

_MESH = None
_TRIPS = 1


def trips() -> int:
    """How many times the ops dispatched now run (:func:`traced_once`)."""
    return _TRIPS


@contextlib.contextmanager
def _repeated(n: int):
    """Marks the ops of the ``with`` block as one step of a loop of ``n``
    steps of one shape, traced once on meta tensors: the dry run weights
    them by ``n``, as the reference's HLO analysis weights a while body by
    its trip count."""
    global _TRIPS
    outer, _TRIPS = _TRIPS, _TRIPS * n
    try:
        yield
    finally:
        _TRIPS = outer


def ambient_mesh():
    """The mesh of the innermost :func:`use_mesh`, or None."""
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh):
    """Makes ``mesh`` ambient for the ``with`` block (``jax.set_mesh``)."""
    global _MESH
    outer, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = outer


class _Once(torch.autograd.Function):
    """``fn(*args)`` traced once under :func:`_repeated` ``(n)``, its backward
    too (the graph built in ``forward`` is differentiated in ``backward``
    under the same weight)."""

    @staticmethod
    def forward(ctx, n, fn, *args):
        ctx.n = n
        ctx.inputs = [a.detach().requires_grad_(a.requires_grad) for a in args]
        # the inner graph keeps its own tensors: a checkpointed layer's hooks
        # would recompute the layer inside backward's weight, counting it n² times
        with torch.enable_grad(), _repeated(n), torch.autograd.graph.saved_tensors_hooks(
                lambda t: t, lambda t: t):
            ctx.outputs = fn(*ctx.inputs)
        return tuple(o.detach() for o in ctx.outputs)

    @staticmethod
    def backward(ctx, *grads):
        wanted = [a for a in ctx.inputs if a.requires_grad]
        with _repeated(ctx.n):
            got = iter(torch.autograd.grad(ctx.outputs, wanted, grads, allow_unused=True))
        return (None, None, *(next(got) if a.requires_grad else None for a in ctx.inputs))


def traced_once(n: int, fn, *args) -> tuple:
    """The outputs of one step ``fn(*args)`` of a loop of ``n`` steps of one
    shape, on meta tensors: the dry run counts its ops, and its backward's,
    ``n`` times (:func:`trips`)."""
    return _Once.apply(n, fn, *args)


def _split(t, dim: int) -> bool:
    """Whether DTensor ``t``'s dim ``dim`` is split across a mesh axis of
    more than one device."""
    if not isinstance(t, DTensor) or t.dim() < 1:
        return False
    dim %= t.dim()
    return any(isinstance(p, Shard) and p.dim == dim and n > 1
               for p, n in zip(t.placements, t.device_mesh.shape))


def _replicate_partials(t: DTensor) -> DTensor:
    if not any(p.is_partial() for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, [Replicate() if p.is_partial() else p
                                          for p in t.placements])


def _gathered(x, dim: int):
    """DTensor ``x`` with its dim ``dim`` gathered, its other dims as they are."""
    if not isinstance(x, DTensor):
        return x
    dim %= x.dim()
    return x.redistribute(x.device_mesh, [Replicate() if p.is_shard(dim) else p
                                          for p in x.placements])


def _gather_reshaped(x: DTensor, shape) -> DTensor:
    """``x`` with every dim from the first one a view as ``shape`` changes
    gathered (replicated), the dims before it kept as they are."""
    keep = 0
    while keep < min(x.dim(), len(shape)) and shape[keep] == x.shape[keep]:
        keep += 1
    return x.redistribute(x.device_mesh, [Replicate() if p.is_shard() and p.dim >= keep else p
                                          for p in x.placements])


_PRODUCTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)
_F32_OUT = {torch.ops.aten.mm.default: torch.ops.aten.mm.dtype,
            torch.ops.aten.bmm.default: torch.ops.aten.bmm.dtype}


@register_sharding(torch.ops.aten.mm.dtype)
def _mm_f32_out(a, b, out_dtype):
    """``mm``'s placements a mesh dim, for its ``out_dtype`` overload, which
    DTensor has no rule for: rows, columns, or the contraction split (a
    partial sum)."""
    return [([Replicate()], [Replicate(), Replicate(), None]),
            ([Shard(0)], [Shard(0), Replicate(), None]),
            ([Shard(1)], [Replicate(), Shard(1), None]),
            ([Partial()], [Shard(1), Shard(0), None])]


@register_sharding(torch.ops.aten.bmm.dtype)
def _bmm_f32_out(a, b, out_dtype):
    """``bmm``'s placements a mesh dim, for its ``out_dtype`` overload: the
    batch, rows, columns, or the contraction split."""
    return [([Replicate()], [Replicate(), Replicate(), None]),
            ([Shard(0)], [Shard(0), Shard(0), None]),
            ([Shard(1)], [Shard(1), Replicate(), None]),
            ([Shard(2)], [Replicate(), Shard(2), None]),
            ([Partial()], [Shard(2), Shard(1), None])]
_VIEWS = (torch.ops.aten.view.default, torch.ops.aten._unsafe_view.default)
_BATCH_AXES = ("pod", "data")


def _index_put(func, dest, indices, values, accumulate: bool = False) -> DTensor:
    """``index_put`` (out of place) over DTensors, mesh dim by mesh dim: with
    ``accumulate`` (a scatter-add: the embedding's backward, the MoE
    dispatch and combine), rows split alike across a mesh dim in the
    indices and the values (their leading dim), or values partial there,
    scatter locally into a partial result; anything else is gathered
    first. torch 2.11's own rule fails on the embedding's backward ("Shard
    dim -1 ... must be normalized"); this one moves no values."""
    ref = next(t for t in (dest, values, *indices) if isinstance(t, DTensor))
    mesh = ref.device_mesh
    dest, values = _on_mesh(dest, mesh), _on_mesh(values, mesh)
    indices = [None if i is None else _on_mesh(i, mesh) for i in indices]
    out, want_idx, want_val = [], [], []
    for d in range(mesh.ndim):
        idx = [i.placements[d] for i in indices if i is not None]
        v = values.placements[d]
        if accumulate and v.is_shard(0) and all(p.is_shard(0) for p in idx):
            out.append(Partial()), want_idx.append(Shard(0)), want_val.append(v)
        elif accumulate and v.is_partial() and all(p.is_replicate() for p in idx):
            out.append(Partial()), want_idx.append(Replicate()), want_val.append(v)
        else:
            out.append(Replicate()), want_idx.append(Replicate()), want_val.append(Replicate())
    # the destination counted once: whole on the ranks at coordinate 0 of each
    # partial mesh dim, zeros on the others
    base = dest.redistribute(mesh, [Replicate()] * mesh.ndim).to_local()
    coords = mesh.get_coordinate()
    if any(p.is_partial() and c for p, c in zip(out, coords)):
        base = torch.zeros_like(base)
    local = func(base,
                 [None if i is None else i.redistribute(mesh, want_idx).to_local()
                  for i in indices],
                 values.redistribute(mesh, want_val).to_local(), accumulate)
    return DTensor.from_local(local, mesh, out, run_check=False)


def _pad(func, x: DTensor, pad, value=0) -> DTensor:
    """``constant_pad_nd`` of DTensor ``x`` on each rank's shard: ``pad``
    lists (before, after) pairs from the last dim back, as ``F.pad``; a
    padded dim split across the mesh is gathered first, and a partial
    ``x`` is reduced first (a pad of a sum is not the sum of pads)."""
    padded = {x.dim() - 1 - i // 2 for i, n in enumerate(pad) if n}
    x = _replicate_partials(x)
    x = x.redistribute(x.device_mesh, [Replicate() if p.is_shard() and p.dim in padded else p
                                       for p in x.placements])
    shape = list(x.shape)
    for i, n in enumerate(pad):
        shape[x.dim() - 1 - i // 2] += n
    local = func(x.to_local(), pad, value)
    return DTensor.from_local(local, x.device_mesh, x.placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape, device="meta").stride())


class ShardedOps(TorchDispatchMode):
    """The rules 1-6 of the module's docstring. ``grad_dtype`` is the dtype
    rule 1 reduces a split over a batch axis in (a weight gradient's sum
    over the tokens)."""

    def __init__(self, grad_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.grad_dtype = grad_dtype

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in _PRODUCTS and not kwargs:
            a, b = args
            if (isinstance(a, DTensor) and isinstance(b, DTensor)
                    and a.dtype == b.dtype == torch.bfloat16 and (_split(a, -1) or _split(b, -2))):
                if a.device.type == "cpu":
                    out = func(a.to(torch.float32), b.to(torch.float32))
                else:
                    out = _F32_OUT[func](a, b, torch.float32)
                names = out.device_mesh.mesh_dim_names or ()
                if any(p.is_partial() and names[i] in _BATCH_AXES
                       for i, p in enumerate(out.placements)):
                    out = out.to(self.grad_dtype)
                return _replicate_partials(out).to(torch.bfloat16)
        if (func is torch.ops.aten.index_put.default and not kwargs
                and any(isinstance(t, DTensor) for t in (args[0], args[2], *args[1]))):
            return _index_put(func, *args)
        if func is torch.ops.aten.gather.default and isinstance(args[0], DTensor):
            x, dim, index = args[:3]
            if _split(x, dim) or any(p.is_partial() for p in x.placements):
                x = _gathered(_replicate_partials(x), dim)
                return func(x, dim, _gathered(index, dim), *args[3:], **kwargs)
        if func is torch.ops.aten.constant_pad_nd.default and isinstance(args[0], DTensor):
            return _pad(func, *args, **kwargs)
        if any(isinstance(t, DTensor) for t in args) and func in REPLICATED:
            return _replicated(func, args, kwargs)
        if func in _VIEWS and isinstance(args[0], DTensor) and not kwargs:
            try:
                return func(*args)
            except RuntimeError:  # "Cannot unflatten unevenly sharded tensor", or a
                # local view DTensor lets through that its shard cannot take
                return func(_gather_reshaped(args[0], args[1]), args[1])
        try:
            return func(*args, **kwargs)
        except NotImplementedError as e:
            if "does not have a sharding strategy" not in str(e):
                raise
            REPLICATED.add(func)
            return _replicated(func, args, kwargs)


# ops DTensor has no rule for, met so far in this process: each runs on its
# arguments gathered whole (``aten.searchsorted`` in the MoE dispatch)
REPLICATED: set = set()


def _replicated(func, args, kwargs):
    """``func`` on every DTensor argument gathered whole, on each rank; the
    tensor outputs replicated DTensors."""
    mesh = next(t for t in args if isinstance(t, DTensor)).device_mesh
    whole = [Replicate()] * mesh.ndim

    def local(t):
        return t.redistribute(mesh, whole).to_local() if isinstance(t, DTensor) else t

    out = func(*map(local, args), **{k: local(v) for k, v in kwargs.items()})
    wrap = lambda t: (DTensor.from_local(t, mesh, whole, run_check=False)  # noqa: E731
                      if isinstance(t, torch.Tensor) else t)
    return tuple(map(wrap, out)) if isinstance(out, (tuple, list)) else wrap(out)


@contextlib.contextmanager
def sharded(mesh, grad_dtype: torch.dtype = torch.float32):
    """The context the port's model code runs in on DTensors over ``mesh``
    (the module's docstring); ``grad_dtype`` is the dtype a weight
    gradient's partial sums are reduced across the batch axes in."""
    with use_mesh(mesh), implicit_replication(), ShardedOps(grad_dtype):
        yield mesh


def place(x: torch.Tensor, mesh, placements) -> DTensor:
    """``x`` as a DTensor over ``mesh`` with ``placements``: a tensor every
    rank holds whole is sliced to this rank's shard on the mesh's device
    type, with no communication; a DTensor is gathered whole first (a move
    onto another mesh or other placements)."""
    if isinstance(x, DTensor):
        x = x.full_tensor()
    return distribute_tensor(x.to(mesh.device_type), mesh, placements, src_data_rank=None)


def _on_mesh(t: torch.Tensor, mesh) -> DTensor:
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def shard_local_write(write, buf: DTensor, val, pos, update_mask) -> None:
    """``write(buf, val, pos, update_mask)`` (``layers.masked_cache_write``:
    row ``b`` of ``val`` (B, 1, H, D) into ``buf`` (B, T, H, D) at
    ``pos[b]``) on each rank's shard of a DTensor cache, in place. DTensor
    has no rule for the in-place ``index_put_`` on a cache sharded over the
    batch (or the heads): its rows are indexed by an iota it cannot see
    through. Each rank writes its own rows, ``val``, ``pos`` and the mask
    laid out as the cache's batch and head dims; a cache sharded over its
    sequence (``cache_shard_seq``) is written only by the rank that holds
    each row's position, at its local offset."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    mesh = buf.device_mesh
    rows = [Shard(0) if p.is_shard(0) else Replicate() for p in buf.placements]
    vals = [Replicate() if p.is_shard(1) else p for p in buf.placements]
    local_shape, offset = compute_local_shape_and_global_offset(buf.shape, mesh, buf.placements)
    lv = _on_mesh(val, mesh).redistribute(mesh, vals).to_local()
    lp = _on_mesh(pos, mesh).redistribute(mesh, rows).to_local() - offset[1]
    mask = None if update_mask is None else (
        _on_mesh(update_mask, mesh).redistribute(mesh, rows).to_local())
    if local_shape[1] != buf.shape[1]:  # sequence-sharded: only the owner writes
        own = (lp >= 0) & (lp < local_shape[1])
        mask = own if mask is None else mask & own
        lp = lp.clamp(0, local_shape[1] - 1)
    write(buf.to_local(), lv, lp, mask)
