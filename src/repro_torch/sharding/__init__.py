"""Logical-axis sharding policy, as DTensor placements over a ``DeviceMesh``.

A copy of ``repro.sharding``'s policy. One greedy, divisibility-aware
policy maps logical axis names to mesh axes for *both* parameters and
activations:

* ``batch``  → ``('pod','data')`` (hierarchical data parallel)
* ``vocab`` / ``mlp`` / ``tp`` / ``heads`` → ``'model'`` (tensor parallel)
* ``kvseq`` → ``'model'`` (context-parallel KV caches for decode)
* ``embed`` → ``'data'`` (FSDP / ZeRO-3 weight sharding — only claims 'data'
  when no batch dim already did, so the same rule serves weights and
  activations)
* ``seq`` / ``head_dim`` → ``'model'`` *fallbacks*, used when a tensor has no
  dim that can claim the model axis.

Each mesh axis is claimed at most once per tensor and only when it divides
the dim size. :func:`spec_for` gives, per tensor dim, the mesh axes that
shard it (the reference's ``PartitionSpec`` entries, as a tuple);
:func:`placements` turns that into one DTensor placement per mesh dim
(``Shard(d)`` where a mesh axis shards tensor dim ``d``, else
``Replicate()``; a dim sharded over ``('pod', 'data')`` is split over pod
first, as the reference's spec splits it). ``torch.distributed.tensor`` is
imported only where a mesh is in use.

No op of a step may take a ``_StridedShard``: DTensor makes one where a
view merges a sharded dim with a later dim that is sharded too (the
batch with the heads in an attention einsum, the batch with a sequence
sharded over ``model`` in a projection ``bsd,de->bse``), and it then
plans every redistribution of the ops that take it, one for each
candidate layout of each input, by its graph search, whose states grow
with the mesh's dims: on the three-axis multi-pod mesh one projection
took minutes to plan. The model code keeps such merges out:
:func:`seq_whole` before a projection, :func:`local_call` for math that
is local to a batch row and a head.
"""
from __future__ import annotations

import contextlib
import contextvars
import functools
from typing import Sequence

from repro_torch.models.params import tree_map

__all__ = [
    "CANDIDATES",
    "PRIORITY",
    "spec_for",
    "placements",
    "named_sharding",
    "param_specs",
    "set_mesh",
    "current_mesh",
    "constrain",
    "sharded",
    "claimed",
    "gathered",
    "seq_whole",
    "batch_axes",
    "axis_sizes",
    "local_call",
    "dense",
    "grad_as_is",
    "index_write",
    "placed",
    "shard_box",
    "from_shard",
    "contiguous_stride",
    "lay_out",
    "lay_out_tree",
    "placed_like",
    "whole",
]

# logical axis -> ordered candidate mesh-axis tuples
CANDIDATES: dict[str, list[tuple[str, ...]]] = {
    "batch": [("pod", "data"), ("data",)],
    "vocab": [("model",)],
    "mlp": [("model",)],
    "tp": [("model",)],
    "heads": [("model",)],
    "kvseq": [("model",)],
    "embed": [("data",)],
    "seq": [("model",)],
    "head_dim": [("model",)],
}

# greedy claim order; earlier wins a contested mesh axis
PRIORITY = [
    "batch",
    "vocab",
    "mlp",
    "tp",
    "heads",
    "kvseq",
    "embed",
    "seq",
    "head_dim",
]

_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


def current_mesh():
    return _MESH.get()


@contextlib.contextmanager
def set_mesh(mesh):
    tok = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(tok)


def _axis_names(mesh) -> tuple[str, ...]:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names) if names is not None else tuple(mesh.axis_names)


def axis_sizes(mesh) -> dict[str, int]:
    """Axis name → size, of a ``DeviceMesh`` or of anything with the
    reference mesh's ``axis_names`` and ``devices``."""
    # DeviceMesh.shape reads no tensor (mesh.mesh would: ops a counter sees)
    shape = mesh.shape if hasattr(mesh, "mesh_dim_names") \
        else mesh.devices.shape
    return dict(zip(_axis_names(mesh), (int(s) for s in shape)))


def batch_axes(mesh) -> tuple[str, ...]:
    """Mesh axes the global batch is sharded over."""
    return ("pod", "data") if "pod" in _axis_names(mesh) else ("data",)


def spec_for(shape: Sequence[int], logical: Sequence[str], mesh,
             policy: str = "train") -> tuple:
    """Resolve one tensor's logical axes to its spec: per dim ``None``, a
    mesh axis name, or a tuple of them, trailing ``None``s dropped.

    ``policy="serve_replicated"`` drops the 'embed'→data FSDP rule: at decode
    the batch dim already owns 'data', so embed-sharded weights force a
    per-token weight all-gather. Replicating weights across 'data' (keeping
    TP over 'model') removes that collective entirely — used whenever the
    TP-sharded weights fit the HBM budget (weight-stationary serving).
    """
    sizes = axis_sizes(mesh)
    assigned: dict[int, tuple[str, ...]] = {}
    used: set[str] = set()
    order = sorted(
        range(len(shape)),
        key=lambda i: PRIORITY.index(logical[i]) if logical[i] in PRIORITY else 99,
    )
    for i in order:
        name = logical[i]
        if policy == "serve_replicated" and name == "embed":
            continue
        for cand in CANDIDATES.get(name, []):
            axes = tuple(a for a in cand if a in sizes)
            if not axes or any(a in used for a in axes):
                continue
            total = 1
            for a in axes:
                total *= sizes[a]
            if total > 1 and shape[i] % total == 0:
                assigned[i] = axes
                used.update(axes)
                break
    parts = []
    for i in range(len(shape)):
        ax = assigned.get(i)
        parts.append(ax if ax and len(ax) > 1 else (ax[0] if ax else None))
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def placements(spec: tuple, mesh) -> tuple:
    """One DTensor placement per mesh dim for ``spec``."""
    from torch.distributed.tensor import Replicate, Shard

    dim_of = {}
    for d, part in enumerate(spec):
        for axis in ((part,) if isinstance(part, str) else (part or ())):
            dim_of[axis] = d
    return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                 for a in _axis_names(mesh))


def named_sharding(shape, logical, mesh, policy: str = "train") -> tuple:
    """The placements of one tensor under the policy."""
    return placements(spec_for(shape, logical, mesh, policy), mesh)


def param_specs(defs, mesh, policy: str = "train"):
    """A tree of placements mirroring a ParamDef tree."""
    return tree_map(
        lambda d: named_sharding(d.shape, d.logical, mesh, policy), defs)


def constrain(x, *logical: str):
    """Redistribute a DTensor to the policy's placements for its logical
    axes; a no-op with no mesh set, and for a tensor that is not a DTensor
    (a local shard inside ``local_map``, or a step run unsharded)."""
    mesh = current_mesh()
    if mesh is None:
        return x
    if len(logical) != x.ndim:
        raise ValueError(f"rank mismatch: {logical} vs {tuple(x.shape)}")
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    want = named_sharding(x.shape, logical, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def sharded(*ts) -> bool:
    """Whether a mesh is set and any of ``ts`` is a DTensor on it: a step
    of plain tensors (no mesh, or a mesh of one device) takes the plain
    path and counts exactly the ops it counts with no mesh."""
    return current_mesh() is not None and any(
        hasattr(t, "to_local") for t in ts)


def claimed(t, logical: Sequence[str], name: str) -> tuple[str, ...]:
    """The mesh axes that the policy gives the logical axis ``name`` of the
    DTensor ``t``, laid out by ``logical`` (the decode cache's ``kvseq``
    where its heads do not divide 'model'); none for a tensor that is not
    a DTensor."""
    if not hasattr(t, "device_mesh"):
        return ()
    spec = spec_for(t.shape, logical, t.device_mesh)
    i = list(logical).index(name)
    part = spec[i] if i < len(spec) else None
    return (part,) if isinstance(part, str) else tuple(part or ())


def gathered(w, rows: int, width: int, *logical):
    """The weight ``w`` laid out by ``logical`` (its FSDP shard over
    'data' gathered) where the ``rows`` activation rows that meet it
    outnumber its input ``width``; else ``w`` itself. Left to choose,
    DTensor may gather the rows over the batch instead, and their product
    with the weight, then the larger of the two, is whole over the batch
    on every rank (the loss head's logits of a training chunk, the MoE's
    expert activations); a decode step's few rows are cheaper to gather
    than the weight."""
    return constrain(w, *logical) if rows > width else w


def seq_whole(x, feature: str = "embed"):
    """``x`` (batch, seq, ``feature``) in the policy's layout for
    ``("batch", "", feature)``: the sequence whole. An einsum that merges
    the batch and seq dims (a projection ``bsd,de->bse``) takes it so:
    the merge of a batch dim with a sequence sharded over ``model`` is a
    ``_StridedShard`` (module doc)."""
    return constrain(x, "batch", "", feature)


def local_call(fn, args, in_axes, out_axes, partial=(), reduced=()):
    """``fn(*args)`` where its math is local to a shard (the wkv per batch
    row and head): under a mesh, with a DTensor among ``args``, each
    argument is redistributed to the placements of its logical axes
    (``in_axes``, one tuple per argument; a plain tensor is taken as
    replicated) and ``fn`` runs on the local shards by ``local_map``; its
    outputs are DTensors placed by ``out_axes``, each logical name on the
    mesh axes it took in the inputs, and partial sums over the mesh axes
    that the logical names in ``partial`` took (a lookup in a vocab
    slice). An argument replicated over a mesh axis that another argument
    shards feeds a different shard of the work on each rank there: its
    gradient is a partial sum over that axis. Otherwise ``fn(*args)``.

    With ``reduced`` (logical names), ``fn`` also takes ``reduce=``, a
    function ``reduce(t, op)`` of a local tensor that reduces it by ``op``
    ("sum", "max") over the mesh axes those names took (:func:`_reducer`;
    ``t`` itself where they took none, and with no mesh)."""
    def bound(dmesh=None, axes=()):
        return functools.partial(fn, reduce=_reducer(dmesh, axes)) \
            if reduced else fn

    mesh = current_mesh()
    if mesh is None:
        return bound()(*args)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    dts = [a for a in args if isinstance(a, DTensor)]
    if not dts:
        return bound()(*args)
    dmesh = dts[0].device_mesh
    owner: dict[str, str] = {}  # mesh axis -> logical name that took it
    ins, in_pl = [], []
    for a, axes in zip(args, in_axes):
        if not isinstance(a, DTensor):
            a = DTensor.from_local(a, dmesh, [Replicate()] * dmesh.ndim,
                                   run_check=False)
        spec = spec_for(a.shape, axes, dmesh)
        for d, part in enumerate(spec):
            for axis in ((part,) if isinstance(part, str) else (part or ())):
                owner[axis] = axes[d]
        want = placements(spec, dmesh)
        ins.append(a if tuple(a.placements) == want
                   else a.redistribute(dmesh, want))
        in_pl.append(want)
    names = _axis_names(dmesh)
    out_pl = tuple(
        tuple(Partial() if owner.get(a) in partial
              else Shard(axes.index(owner[a])) if owner.get(a) in axes
              else Replicate() for a in names)
        for axes in out_axes)
    grad_pl = tuple(
        tuple(Partial() if a in owner and not q.is_shard() else q
              for a, q in zip(names, pl)) for pl in in_pl)
    run = bound(dmesh, [a for a in names if owner.get(a) in reduced])
    return local_map(run, out_placements=out_pl,
                     in_placements=tuple(in_pl),
                     in_grad_placements=grad_pl, device_mesh=dmesh)(*ins)


def _reducer(dmesh, axes):
    """``reduce(t, op)``: ``t`` reduced by ``op`` over each of the mesh
    axes ``axes`` in turn (a functional collective each, which the dry
    run's counter counts); ``t`` itself for none."""
    def reduce(t, op: str):
        from torch.distributed import _functional_collectives as funcol

        for axis in axes:
            t = funcol.all_reduce(t, op, dmesh.get_group(axis))
            t = t.wait() if hasattr(t, "wait") else t
        return t
    return reduce


def dense(x):
    """Under a mesh, a DTensor ``x`` laid out contiguously, with the
    gradient that flows back into it made contiguous too; otherwise ``x``
    itself. DTensor carries a global stride that its local shards need
    not share (a shard from a reduce-scatter is contiguous where the
    global tensor has an einsum's permuted layout), and an einsum then
    takes a view, forward or backward, that the local shard cannot give
    (the experts' ``g``, ``u`` and ``h`` in ``models/moe.py``)."""
    if current_mesh() is None or not hasattr(x, "to_local"):
        return x
    x = x.contiguous()
    if x.requires_grad:
        x.register_hook(lambda g: g.contiguous())
    return x


def grad_as_is(x):
    """Under a mesh, a DTensor ``x`` whose gradient is laid out as ``x``
    before it flows back into the op that made ``x``; otherwise ``x``
    itself. DTensor's backward may lay a gradient out otherwise (the
    sequence over 'model' where the forward had the features), and the
    einsum that made ``x`` then merges it with the batch: a
    ``_StridedShard`` (module doc)."""
    if current_mesh() is None or not hasattr(x, "to_local"):
        return x
    pl = tuple(x.placements)
    if x.requires_grad:
        x.register_hook(lambda g: g if tuple(g.placements) == pl
                        else g.redistribute(g.device_mesh, pl))
    return x


def index_write(dst, index, value) -> None:
    """``dst[index] = value``, in place: a slice write, or a row write
    ``index = (arange(B), slot)`` of one entry of dim 1 per row (the KV
    cache's). A DTensor has no in-place indexed write that keeps a sharded
    layout: there a slice write must cover ``dst``, and a row write runs on
    each shard, which takes the rows it holds and writes where the slot
    falls inside its part of dim 1 (no gather of ``dst``)."""
    if not hasattr(dst, "to_local"):
        dst[index] = value
        return
    idx = index if isinstance(index, tuple) else (index,)
    if all(isinstance(i, slice) for i in idx):
        if any(slice(*i.indices(n)) != slice(0, n, 1)
               for i, n in zip(idx, dst.shape)):
            raise NotImplementedError(
                "a slice write into part of a sharded tensor")
        dst.copy_(value)
        return
    import torch
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh, pl = dst.device_mesh, tuple(dst.placements)
    shape, off = compute_local_shape_and_global_offset(dst.shape, mesh, pl)

    def laid_out(t, want):
        if not hasattr(t, "to_local"):
            from torch.distributed.tensor import DTensor
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, want).to_local()

    # the value and the slots laid out as dst's rows (dim 1 dropped)
    val = laid_out(value, tuple(
        Replicate() if isinstance(q, Shard) and q.dim == 1
        else Shard(q.dim - 1) if isinstance(q, Shard) and q.dim > 1 else q
        for q in pl))
    slot = laid_out(idx[1], tuple(
        q if isinstance(q, Shard) and q.dim == 0 else Replicate()
        for q in pl)) - off[1]
    local = dst.to_local()
    rows = torch.arange(shape[0], device=local.device)
    inside = ((slot >= 0) & (slot < shape[1])).view(
        -1, *([1] * (val.dim() - 1)))
    slot = slot.clamp(0, shape[1] - 1)
    local[rows, slot] = torch.where(inside, val, local[rows, slot])


def shard_box(shape, pl, mesh) -> tuple[slice, ...]:
    """This rank's shard of a tensor of ``shape`` laid out by the
    placements ``pl`` over ``mesh``: one slice a dim of the whole."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    local, off = compute_local_shape_and_global_offset(shape, mesh, pl)
    return tuple(slice(o, o + n) for o, n in zip(off, local))


def from_shard(local, shape, pl, mesh):
    """The DTensor of global ``shape`` and placements ``pl`` over ``mesh``
    whose shard on this rank is ``local`` (its :func:`shard_box` of the
    whole, contiguous)."""
    import torch
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(local, mesh, tuple(pl), run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def contiguous_stride(shape) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``, worked out (a
    ``torch.empty(shape, device="meta")`` to read them from is an
    allocation of the whole tensor that the dry run's counter, which sees
    the step's meta tensors, would count as the step's own)."""
    stride, n = [], 1
    for size in reversed(tuple(shape)):
        stride.append(n)
        n *= max(size, 1)
    return tuple(reversed(stride))


def placed(d, make, device):
    """A ParamDef's tensor made by ``make(shape, dtype, device)``: under a
    mesh of more than one device a DTensor of the policy's placements
    whose local shard ``make`` fills, else the whole tensor."""
    mesh = current_mesh()
    if mesh is None or mesh.size() == 1:
        return make(d.shape, d.dtype, device)
    pl = named_sharding(d.shape, d.logical, mesh)
    local = tuple(s.stop - s.start for s in shard_box(d.shape, pl, mesh))
    return from_shard(make(local, d.dtype, device), d.shape, pl, mesh)


def lay_out(t, pl, mesh):
    """``t`` as a DTensor of placements ``pl`` over ``mesh``. A whole
    tensor, equal on every rank (a batch every rank reads alike), gives
    each rank its own shard and moves nothing; a DTensor in other
    placements is redistributed; one in ``pl`` is returned as it is. On a
    mesh of one device, ``t`` itself."""
    if mesh.size() == 1:
        return t
    from torch.distributed.tensor import DTensor, distribute_tensor

    pl = tuple(pl)
    if isinstance(t, DTensor):
        return t if tuple(t.placements) == pl else t.redistribute(mesh, pl)
    return distribute_tensor(t, mesh, pl, src_data_rank=None)


def lay_out_tree(tree, placements_tree, mesh):
    """:func:`lay_out` leaf by leaf over nested dicts of the same
    structure (a state and its ``state_shardings``)."""
    return tree_map(lambda t, pl: lay_out(t, pl, mesh), tree,
                    placements_tree)


def placed_like(t, like):
    """``t`` in the placements of the DTensor ``like``, redistributed
    where they differ (a state a step computes, written into its cache's
    layout); ``t`` itself where either is no DTensor."""
    if not (hasattr(t, "to_local") and hasattr(like, "to_local")):
        return t
    pl = tuple(like.placements)
    return t if tuple(t.placements) == pl else t.redistribute(
        like.device_mesh, pl)


def whole(t):
    """A DTensor's whole value on every rank (``full_tensor()``, a
    collective); any other tensor as it is."""
    return t.full_tensor() if hasattr(t, "full_tensor") else t
