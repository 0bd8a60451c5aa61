"""Declarative parameter definitions.

Every model declares its parameters as a nested dict of ``ParamDef``
(shape + logical axis names + dtype), as ``repro.models.params`` does. From
that one declaration come the materialized tensors (:func:`materialize`)
the abstract tensors the dry run counts against (:func:`abstractify`:
meta tensors, no memory allocated) and the analytic parameter count
(:func:`count_params`). The nested dicts
are walked in sorted key order, the order ``jax.tree_util`` flattens them
in.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Iterator

import numpy as np
import torch

__all__ = ["ParamDef", "materialize", "abstractify", "count_params",
           "tree_defs", "tree_map", "UNWRITTEN"]

# the position a KV cache slot holds before anything is written to it (and
# attention's padded key slots): above every real position
UNWRITTEN = 2**30


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative description of one parameter tensor."""

    shape: tuple[int, ...]
    logical: tuple[str, ...]  # logical axis name per dim ("" = never sharded)
    dtype: Any = torch.bfloat16
    init: str = "normal"  # normal | zeros | ones | small | unwritten
    scale: float | None = None  # stddev override for "normal"

    def __post_init__(self):
        if len(self.shape) != len(self.logical):
            raise ValueError(
                f"shape {self.shape} and logical axes {self.logical} rank mismatch"
            )

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


def tree_defs(tree, path: tuple[str, ...] = ()) -> Iterator[tuple[tuple[str, ...], Any]]:
    """``(path, leaf)`` for every leaf of a nested dict, keys sorted."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from tree_defs(tree[key], path + (key,))
    else:
        yield path, tree


def tree_map(fn: Callable, tree, *rest):
    """Apply ``fn`` leaf by leaf over nested dicts of the same structure."""
    if isinstance(tree, dict):
        for other in rest:
            if not isinstance(other, dict) or set(other) != set(tree):
                raise ValueError(f"tree structures differ: {sorted(tree)} vs "
                                 f"{sorted(other) if isinstance(other, dict) else type(other)}")
        return {k: tree_map(fn, tree[k], *(o[k] for o in rest))
                for k in tree}
    return fn(tree, *rest)


def _fan_in(d: ParamDef) -> int:
    if not d.shape:
        return 1
    if len(d.shape) == 1:
        return d.shape[0]
    # weights are stored (in_dims..., out_dims...) by convention; treat all but
    # the final axis as fan-in, skipping a leading stacked-layer axis.
    dims = d.shape[:-1]
    if d.logical and d.logical[0] == "layers":
        dims = dims[1:] or (1,)
    return int(np.prod(dims))


def materialize(defs, generator: torch.Generator, device,
                dtype_override=None):
    """Initialize real parameter tensors for a ParamDef tree on ``device``.

    ``normal`` draws N(0, std²) in float32 from ``generator`` (which must
    live on ``device``) with std = ``scale`` or ``1/sqrt(fan_in)``, ``small``
    draws with std 0.02, ``zeros``/``ones`` fill and ``unwritten`` fills
    with :data:`UNWRITTEN` (a KV cache's free slots); each draw is then
    cast to the leaf's dtype (or ``dtype_override``). A stacked leaf (a
    leading ``layers`` axis) is drawn one layer slice at a time into a
    tensor of its final dtype, so a float32 draw of a whole stack (30 GB
    for mixtral's 16-layer experts) never exists. The numbers differ from
    ``repro``'s ``jax.random`` draws for the same seed; the rules are the
    same.

    Under a sharding mesh of more than one device
    (``sharding.set_mesh``; a real process group, each rank drawing from
    the same seed) every rank draws every leaf as without a mesh and keeps
    only its shard of it (``sharding.shard_box``, by the policy's
    placements) as a DTensor: the values do not depend on the mesh, as the
    reference's sharded init's do not. A stacked leaf's shard is filled one
    drawn layer slice at a time, so no rank holds the whole leaf; a leaf
    without a ``layers`` axis is drawn whole in float32, then cut.
    """
    device = torch.device(device)

    def draw(shape, std: float) -> torch.Tensor:
        arr = torch.randn(shape, generator=generator, dtype=torch.float32,
                          device=device)
        return arr.mul_(std)

    def make(d: ParamDef, box: tuple) -> torch.Tensor:
        """The leaf's values in ``box`` (a slice a dim of the whole)."""
        dtype = dtype_override or d.dtype
        shape = tuple(s.stop - s.start for s in box)
        if d.init == "zeros":
            return torch.zeros(shape, dtype=dtype, device=device)
        if d.init == "ones":
            return torch.ones(shape, dtype=dtype, device=device)
        if d.init == "unwritten":
            return torch.full(shape, UNWRITTEN, dtype=dtype, device=device)
        std = d.scale if d.scale is not None else 1.0 / math.sqrt(max(_fan_in(d), 1))
        if d.init == "small":
            std = 0.02
        if not (d.logical and d.logical[0] == "layers"):
            full = draw(d.shape, std)
            if shape == tuple(d.shape):
                return full.to(dtype)
            return torch.empty(shape, dtype=dtype, device=device).copy_(
                full[box])
        out = torch.empty(shape, dtype=dtype, device=device)
        rows = box[0]
        for i in range(d.shape[0]):  # one layer's slice at a time
            layer = draw(d.shape[1:], std)  # every slice: the same stream
            if rows.start <= i < rows.stop:
                out[i - rows.start] = layer[box[1:]]
        return out

    from repro_torch import sharding as shd

    mesh = shd.current_mesh()
    if mesh is not None and mesh.size() == 1:
        mesh = None
    out: dict = {}
    for path, d in tree_defs(defs):  # sorted order: draws are reproducible
        node = out
        for key in path[:-1]:
            node = node.setdefault(key, {})
        if mesh is None:
            node[path[-1]] = make(d, tuple(slice(0, n) for n in d.shape))
            continue
        pl = shd.named_sharding(d.shape, d.logical, mesh)
        node[path[-1]] = shd.from_shard(
            make(d, shd.shard_box(d.shape, pl, mesh)), d.shape, pl, mesh)
    return out


def abstractify(defs):
    """A tree of meta tensors with each leaf's shape and dtype: no memory
    is allocated."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), defs)


def count_params(defs) -> int:
    return sum(d.size for _, d in tree_defs(defs))
