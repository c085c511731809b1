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
* :func:`constrain`, called at every layer boundary of the model's loops,
  which puts the residual stream at the reference's layout (the batch
  split over the batch dim, the rest whole), as a
  ``with_sharding_constraint`` would;
* :class:`ShardedOps`, the rules the port sets where DTensor's own differ
  from GSPMD's, fail, or differ between torch versions, on every op
  DTensor is given (the backward's and a checkpointed layer's
  recomputation's too). Where two torches placed an op's output apart
  (``launch.dryrun --placements`` under torch 2.11, the H100 machine's,
  and 2.13, the CPU tests', diffed op by op over every cell), a rule here
  places it, so that both run one plan:

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
  2. Every ``view``/``_unsafe_view`` is placed by :func:`_view`: a split
     dim stays split where the view maps it to the outermost dim of the
     run it flattens into or unflattens from, and it divides evenly;
     every other split is gathered first. DTensor refuses some such views
     (qwen2-0.5b's packed ``heads×head_dim`` dim, 896 = 14 × 64, split 16
     ways and viewed as heads: "Cannot unflatten unevenly sharded
     tensor"), and the torches part on others: the attention's flatten of
     (batch, heads) split over ``data`` and ``model`` into one ``bmm``
     batch dim, which torch 2.13 keeps as a ``_StridedShard`` and 2.11
     refuses (then all of it gathered: 547× the model's FLOPs in
     whisper-medium's decode). The rule keeps the batch's split and
     gathers the heads'.
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
  7. ``aten.index`` (``x[i]``: the embedding's lookup, the MoE dispatch's
     gathers) is placed by :func:`_index`: a vocabulary-split table is
     looked up locally into a partial sum, the reference's masked
     gather, where that moves fewer bytes than gathering the table (the
     MoE dispatch's token gathers gather their tokens); a split of an
     unread dim is kept. torch 2.11 gathered the
     whole table (65536 × 4096 for rwkv6-7b, each decode step) and 2.13
     resharded it to the model dim; both placed the MoE gathers' outputs
     apart (2.11 whole, 2.13 split over ``model``).
  8. A pointwise op (``torch.Tag.pointwise``) of DTensors placed unlike
     each other is placed by :func:`_pointwise` and computed on each
     rank's shards: jamba's ``dt + dt_bias`` of a (B, 1) and a
     model-split (d_in,) operand came out whole under torch 2.11 and
     split under 2.13; a product of a replicated and a partial operand
     (the MoE aux loss) stayed partial under 2.13 only. Its redistributions,
     as rules 2 and 7's, start from detached arguments: they run below
     autograd, and a redistribution of a tensor that requires grad, with
     grad mode off (the backward), issues a ``detach_`` torch 2.11 has no
     rule for.

On a mesh whose every axis has one device nothing is split
(``sharding.placements`` replicates such an axis): every op runs on the
whole tensor and the numbers are the one-device path's bit for bit.
Rules 2, 7 and 8 hand an op none of whose arguments is split or partial
there, or anywhere, to the torch's own rule (:func:`_placed`).
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
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


def _placed(t) -> bool:
    """Whether ``t`` is a DTensor split or partial across a mesh dim of
    more than one device: where no argument is, every torch places an op
    alike (all whole) and rules 2, 7 and 8 leave it to the torch's own."""
    return (isinstance(t, DTensor) and not all(p.is_replicate() for p in t.placements)
            and any(not p.is_replicate() and n > 1
                    for p, n in zip(t.placements, t.device_mesh.shape)))


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


def _view_groups(src, dst) -> list[tuple[list[int], list[int]]]:
    """The runs of ``src``'s dims and ``dst``'s whose sizes have equal
    products, in order: what a view of shape ``src`` as ``dst`` flattens
    (several ``src`` dims into one), unflattens (one into several) or
    keeps; trailing dims of one are added to the last run."""
    groups, i, j = [], 0, 0
    while i < len(src) and j < len(dst):
        ins, outs, a, b = [i], [j], src[i], dst[j]
        i, j = i + 1, j + 1
        while a != b:
            if a < b:
                ins.append(i)
                a, i = a * src[i], i + 1
            else:
                outs.append(j)
                b, j = b * dst[j], j + 1
        groups.append((ins, outs))
    if groups:
        groups[-1][0].extend(range(i, len(src)))
        groups[-1][1].extend(range(j, len(dst)))
    return groups


def _outer(dims: list[int], shape) -> int:
    """The outermost of ``dims`` whose size is not 1 (the first, if all are)."""
    return next((d for d in dims if shape[d] != 1), dims[0])


def _view(func, x: DTensor, size) -> DTensor:
    """``view``/``_unsafe_view`` of DTensor ``x`` as ``size``, placed by this
    rule and not by the torch's: a split dim stays split where the view
    maps it, as the outermost dim of a run it flattens or the outermost
    of the dims it unflattens into, and that dim divides evenly across the
    mesh dim; every other split is gathered first; a partial sum stays
    partial. Each rank then views its own shard. Where nothing is split
    or partial (:func:`_placed`), the torch's own view."""
    if not _placed(x):
        return func(x, size)
    x = x.detach()  # below autograd (rule 8)
    shape = list(size)
    if -1 in shape:
        known = math.prod(n for n in shape if n != -1)
        shape[shape.index(-1)] = x.numel() // known if known else 0
    mesh = x.device_mesh
    if 0 in shape or 0 in x.shape:
        return func(x, size)
    where = {}
    for ins, outs in _view_groups(tuple(x.shape), shape):
        for d in ins:
            where[d] = (d == _outer(ins, x.shape), _outer(outs, shape))
    want, out = [], []
    for m, p in enumerate(x.placements):
        n = mesh.size(m)
        if p.is_shard():
            first, to = where[p.dim]
            if first and x.shape[p.dim] % n == 0 and shape[to] % n == 0:
                want.append(p), out.append(Shard(to))
                continue
            p = Replicate()
        want.append(p), out.append(p)
    x = x.redistribute(mesh, want) if tuple(want) != tuple(x.placements) else x
    local_shape, _ = compute_local_shape_and_global_offset(torch.Size(shape), mesh, out)
    local = func(x.to_local(), list(local_shape))
    stride = func(torch.empty_strided(x.shape, x.stride(), device="meta"), shape).stride()
    return DTensor.from_local(local, mesh, out, run_check=False, shape=torch.Size(shape),
                              stride=stride)


def _index(func, x, indices) -> DTensor:
    """``aten.index`` (``x[i]``, ``x[i, j]``: the embedding's lookup, the MoE
    dispatch's gathers) over DTensors, placed by this rule and not by the
    torch's, mesh dim by mesh dim: a split of a dim no index reads stays
    split (the indices gathered there); a split of the one dim an index
    reads is looked up locally, each rank its own rows and zeros for the
    rest, into a partial sum (the reference's masked gather of a
    vocabulary-split embedding), where reducing that sum moves fewer
    bytes than gathering ``x`` (twice the output's local elements against
    ``x``'s whole: the embedding's table, not the MoE dispatch's tokens);
    where ``x`` is whole the output is split as its indices are. Indices
    that read dims apart, or are placed unlike each other, are gathered.
    The choice reads shapes alone, so every torch makes it alike. Where
    nothing is split or partial (:func:`_placed`), the torch's own
    lookup."""
    if not any(_placed(t) for t in (x, *indices)):
        return func(x, indices)
    ref = next(t for t in (x, *indices) if isinstance(t, DTensor))
    mesh = ref.device_mesh
    x = _replicate_partials(_on_mesh(x.detach(), mesh))  # below autograd (rule 8)
    idx = [None if i is None else _on_mesh(i.detach(), mesh) for i in indices]
    dims = [d for d, i in enumerate(idx) if i is not None]
    read = [i for i in idx if i is not None]
    if dims != list(range(dims[0], dims[-1] + 1)) or len({tuple(i.shape) for i in read}) > 1:
        return _replicated(func, (x, indices), {})
    first, nb, k = dims[0], read[0].dim(), len(dims)
    rows = math.prod(x.shape[first + k:])  # the elements an index reads
    local_out = read[0].to_local().numel() * rows
    want_x, want_i, out, masked = [], [], [], False
    for m, p in enumerate(x.placements):
        kept = {i.placements[m] for i in read}
        if p.is_shard() and p.dim not in dims:
            want_x.append(p), want_i.append(Replicate())
            out.append(Shard(p.dim if p.dim < first else p.dim - k + nb))
        elif (p.is_shard() and k == 1 and x.shape[p.dim] % mesh.size(m) == 0
              and 2 * local_out < x.numel()):
            want_x.append(p), want_i.append(Replicate()), out.append(Partial())
            masked = True
        elif len(kept) == 1 and (q := kept.pop()).is_shard():
            want_x.append(Replicate()), want_i.append(q), out.append(Shard(first + q.dim))
        else:
            want_x.append(Replicate()), want_i.append(Replicate()), out.append(Replicate())
    lx = x.redistribute(mesh, want_x).to_local()
    li = [i.redistribute(mesh, want_i).to_local() for i in read]
    if masked:
        local_shape, offset = compute_local_shape_and_global_offset(x.shape, mesh, want_x)
        rows = li[0] - offset[first]
        mine = (rows >= 0) & (rows < local_shape[first])
        got = func(lx, [None] * first + [torch.where(mine, rows, 0)])
        mine = mine.view(*([1] * first), *mine.shape, *([1] * (got.dim() - first - nb)))
        local = torch.where(mine, got, torch.zeros((), dtype=got.dtype, device=got.device))
    else:
        local = func(lx, [None] * first + li)
    shape = torch.Size((*x.shape[:first], *read[0].shape, *x.shape[first + k:]))
    return DTensor.from_local(local, mesh, out, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


def _pointwise(func, args, kwargs):
    """A pointwise op (``torch.Tag.pointwise``) of DTensors placed unlike
    each other, placed by this rule and not by the torch's, mesh dim by
    mesh dim: where the split arguments agree on one dim of the (broadcast)
    output, the others are split alike (a slice, no communication) or
    broadcast along it, and where they disagree every argument is gathered;
    a partial sum is reduced first. Each rank then applies the op to its
    shards. An in-place op keeps its first argument's placements and
    brings the others to them (a partial first argument is left to the
    torch's own rule, as is an op none of whose arguments is split or
    partial, :func:`_placed`)."""
    if not any(_placed(a) for a in args):
        return func(*args, **kwargs)
    ref = next(a for a in args if isinstance(a, DTensor))
    mesh = ref.device_mesh
    inplace = func._schema.name.endswith("_")
    given = args
    args = [_on_mesh(a.detach(), mesh)  # detached: below autograd
            if isinstance(a, DTensor) or isinstance(a, torch.Tensor) and a.dim() else a
            for a in args]
    tensors = [(i, a) for i, a in enumerate(args) if isinstance(a, DTensor)]
    shape = torch.broadcast_shapes(*(a.shape for _, a in tensors))
    n = len(shape)

    def out_dim(a, p):  # the output dim a Shard of ``a`` splits, or None
        return p.dim + n - a.dim() if p.is_shard() else None

    placed = [[(out_dim(a, a.placements[m]), a.placements[m].is_partial()) for _, a in tensors]
              for m in range(mesh.ndim)]
    if all(len(set(got)) == 1 for got in placed):
        return func(*given, **kwargs)  # placed alike: the torch's rule has one choice
    if inplace and any(p.is_partial() for p in args[0].placements):
        return func(*given, **kwargs)
    out, wants = [], {i: [] for i, _ in tensors}
    for m in range(mesh.ndim):
        if inplace:
            target = out_dim(args[0], args[0].placements[m])
        else:
            split = {d for d, _ in placed[m] if d is not None}
            target = split.pop() if len(split) == 1 else None
        out.append(Replicate() if target is None else Shard(target))
        for i, a in tensors:
            d = None if target is None else target - (n - a.dim())
            wants[i].append(Shard(d) if d is not None and d >= 0 and a.shape[d] != 1
                            else Replicate())
    local = [a if not isinstance(a, DTensor) else a.to_local() if inplace and i == 0
             else a.redistribute(mesh, wants[i]).to_local() for i, a in enumerate(args)]
    result = func(*local, **kwargs)
    if inplace:
        return given[0]
    return DTensor.from_local(result, mesh, out, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta").stride())


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
# id of a mesh made by merge() -> (that mesh, the mesh it merges dims of, the
# dims of that mesh each of its dims holds)
_MERGES: dict[int, tuple] = {}


def merge(mesh, dims: tuple[str, ...]):
    """``mesh`` with its neighbouring dims ``dims`` as one dim of the same
    ranks, in order (the first outermost: ``pod`` and ``data`` pod-major),
    the other dims as they are. Made once a ``mesh`` and ``dims`` (its
    process groups are new groups of every rank). The merged dim is
    labelled by joining ``dims`` with ``_``; :func:`onto` and
    :func:`is_batch_dim` read which dims it holds from this module's
    record, never from the label."""
    from torch.distributed.device_mesh import DeviceMesh

    names = list(mesh.mesh_dim_names)
    first = names.index(dims[0])
    if names[first:first + len(dims)] != list(dims):
        raise ValueError(f"the dims {dims} are not neighbours in the mesh {names}")
    groups = [(i,) for i in range(first)] + [tuple(range(first, first + len(dims)))] + \
        [(i,) for i in range(first + len(dims), len(names))]
    for merged, src, held in _MERGES.values():
        if src is mesh and held == groups:
            return merged
    shape = list(mesh.shape)
    shape[first:first + len(dims)] = [math.prod(shape[first:first + len(dims)])]
    names[first:first + len(dims)] = ["_".join(dims)]
    merged = DeviceMesh(mesh.device_type, mesh.mesh.reshape(shape), mesh_dim_names=tuple(names))
    _MERGES[id(merged)] = (merged, mesh, groups)
    return merged


def _merge_of(mesh) -> tuple | None:
    """``(the mesh it merges dims of, the dims each of its dims holds)`` of
    a mesh :func:`merge` made, else None."""
    got = _MERGES.get(id(mesh))
    return got[1:] if got is not None and got[0] is mesh else None


def is_merged(mesh) -> bool:
    """Whether :func:`merge` made ``mesh``."""
    return _merge_of(mesh) is not None


def is_batch_dim(mesh, dim: int) -> bool:
    """Whether ``mesh``'s dim ``dim`` carries the batch: ``pod`` or
    ``data``, or a dim :func:`merge` made of either (``sharding.step_mesh``:
    ``pod`` with ``data``, and ``model`` too under ``pure_dp``)."""
    merged = _merge_of(mesh)
    if merged is not None:
        src, groups = merged
        return any(src.mesh_dim_names[i] in _BATCH_AXES for i in groups[dim])
    names = mesh.mesh_dim_names or ()
    return dim < len(names) and names[dim] in _BATCH_AXES


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
    """The rules 1-8 of the module's docstring. ``grad_dtype`` is the dtype
    rule 1 reduces a split over a batch axis in (a weight gradient's sum
    over the tokens)."""

    def __init__(self, grad_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.grad_dtype = grad_dtype

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _LOG is None:
            return self._dispatch(func, types, args, kwargs or {})
        global _CURRENT
        collective = func.namespace == "_c10d_functional"
        outer, _CURRENT = _CURRENT, _CURRENT if collective else str(func)
        try:
            out = self._dispatch(func, types, args, kwargs or {})
        finally:
            _CURRENT = outer
        if collective or any(isinstance(t, DTensor) for t in _flat(args)):
            _LOG.append(f"{func} {_layouts(args)} -> {_layouts(out)}")
        return out

    def _dispatch(self, func, types, args, kwargs):
        if func in _PRODUCTS and not kwargs:
            a, b = args
            if (isinstance(a, DTensor) and isinstance(b, DTensor)
                    and a.dtype == b.dtype == torch.bfloat16 and (_split(a, -1) or _split(b, -2))):
                if a.device.type == "cpu":
                    out = func(a.to(torch.float32), b.to(torch.float32))
                else:
                    out = _F32_OUT[func](a, b, torch.float32)
                if any(p.is_partial() and is_batch_dim(out.device_mesh, i)
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
            return _view(func, *args)
        if (func is torch.ops.aten.index.Tensor and not kwargs
                and any(isinstance(t, DTensor) for t in (args[0], *args[1]))):
            return _index(func, *args)
        if (torch.Tag.pointwise in func.tags
                and sum(isinstance(t, DTensor) for t in args) > 1):
            return _pointwise(func, args, kwargs)
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

_LOG: list | None = None
_CURRENT: str | None = None


def current_op() -> str | None:
    """Inside :func:`recording`, the op :class:`ShardedOps` is dispatching
    now (``"constrain"`` in :func:`constrain`); else None: what the dry
    run charges each collective to."""
    return _CURRENT


@contextlib.contextmanager
def recording():
    """Yields a list that gets one line for each op :class:`ShardedOps` is
    given on DTensors in the ``with`` block: the op, each DTensor
    argument's placements and each output's (``launch.dryrun
    --placements``): two torches' plans for one cell compare line by
    line."""
    global _LOG
    outer, _LOG = _LOG, []
    try:
        yield _LOG
    finally:
        _LOG = outer


def _flat(args) -> list:
    out = []
    for a in args:
        out.extend(_flat(a) if isinstance(a, (tuple, list)) else [a])
    return out


def _layouts(x) -> str:
    """The placements of each DTensor in ``x`` (a tensor or a nest of
    arguments), as ``S0``/``R``/``P`` a mesh dim, and its shape; a plain
    tensor is ``-`` and its shape."""
    def one(p):
        return f"S{p.dim}" if p.is_shard() else "P" if p.is_partial() else "R"

    def layout(t):
        shape = "x".join(map(str, t.shape))
        if isinstance(t, DTensor):
            return "(" + ",".join(map(one, t.placements)) + ")" + shape
        return "-" + shape

    return " ".join(layout(t) for t in _flat(x if isinstance(x, (tuple, list)) else [x])
                    if isinstance(t, torch.Tensor))


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


def onto(x, mesh):
    """DTensor ``x`` on ``mesh``, a mesh :func:`merge` made of ``x``'s or
    the one ``x``'s was made of (``sharding.step_mesh``: ``pod`` and
    ``data`` as one dim): each rank keeps its local shard, nothing is
    communicated. A merged dim takes the placement its parts share; a
    merged dim's parts each take its placement (a dim sharded over the
    merged ``pod`` and ``data`` is sharded over ``pod`` and then ``data``,
    the same shards where it divides evenly). Parts placed unlike each
    other (a split over ``data`` alone, as ZeRO's optimizer state and
    ``fsdp``'s parameters are) have no placement on the merged dim and
    raise ``ValueError``, as any other pair of meshes does. A plain
    tensor, or one on ``mesh`` already, is returned as it is."""
    if not isinstance(x, DTensor) or x.device_mesh == mesh:
        return x
    src = x.device_mesh
    if (got := _merge_of(mesh)) is not None and got[0] is src:
        merged, groups, placements = mesh, got[1], []
        for name, dims in zip(mesh.mesh_dim_names, groups):
            kept = {x.placements[i] for i in dims}
            if len(kept) > 1:
                raise ValueError(f"{name} merges dims placed {[x.placements[i] for i in dims]}: "
                                 "no one placement of the merged dim holds those shards")
            placements.append(kept.pop())
    elif (got := _merge_of(src)) is not None and got[0] is mesh:
        merged, groups, placements = src, got[1], [None] * mesh.ndim
        for p, dims in zip(x.placements, groups):
            for i in dims:
                placements[i] = p
    else:
        raise ValueError(f"mesh {mesh.mesh_dim_names} does not merge or split "
                         f"{src.mesh_dim_names}")
    on_merged = placements if merged is mesh else x.placements
    for m, (p, dims) in enumerate(zip(on_merged, groups)):
        if p.is_shard() and len(dims) > 1 and x.shape[p.dim] % merged.size(m):
            raise ValueError(f"dim {p.dim} of {tuple(x.shape)} does not split evenly over "
                             f"{merged.mesh_dim_names[m]}")
    return DTensor.from_local(x.to_local(), mesh, placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def move(x, like):
    """``x`` with ``like``'s mesh and placements (a DTensor ``like``;
    otherwise ``x`` as it is): carried onto ``like``'s mesh (:func:`onto`),
    then redistributed there. A gradient on a step's ``pod_data`` mesh so
    reaches its optimizer state on the reference's mesh, split over
    ``data`` alone, with the reduction its ``Partial`` needs."""
    if not isinstance(like, DTensor):
        return x
    return onto(x, like.device_mesh).redistribute(like.device_mesh, like.placements)


def constrain(x):
    """The residual stream between two layers at the reference's layout:
    on a DTensor, dim 0 (the batch) split over the mesh's batch dim
    (:func:`is_batch_dim`) where it divides it, every other dim whole and
    a partial sum reduced. The part a ``with_sharding_constraint`` plays
    in GSPMD: every layer starts from one layout, whatever the placements
    the torch's own rules chose inside the layer before. A plain tensor is
    returned as it is."""
    if not isinstance(x, DTensor):
        return x
    global _CURRENT
    mesh = x.device_mesh
    want = tuple(Shard(0) if is_batch_dim(mesh, i) and n > 1 and x.shape[0] % n == 0
                 else Replicate() for i, n in enumerate(mesh.shape))
    if tuple(x.placements) == want:
        return x
    if _LOG is None:
        return x.redistribute(mesh, want)
    outer, _CURRENT = _CURRENT, "constrain"
    try:
        out = x.redistribute(mesh, want)
    finally:
        _CURRENT = outer
    _LOG.append(f"constrain {_layouts(x)} -> {_layouts(out)}")
    return out


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
