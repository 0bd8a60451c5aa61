"""Checkpointing with atomic saves and an async writer, a copy of
``repro.train.checkpoint``.

Layout: one directory per step, the reference's —

    ckpt_dir/step_00000123/
        meta.json            # step, leaf paths, shapes, dtypes
        arrays.npz           # one entry per leaf, bf16 as its uint16 bits
    ckpt_dir/LATEST          # atomic pointer

The entry names are the leaves' key paths joined by ``/``, as
``jax.tree_util.tree_flatten_with_path`` names a nested dict's leaves, so
a checkpoint written by either package restores in the other. Writes are
atomic (tmp dir + rename), so a crash mid-save never corrupts the restore
point.

Under a process group a state of DTensors is saved whole by rank 0:
each distinct shard of each leaf goes from the lowest rank that holds it
to rank 0's host memory, leaf by leaf (no device ever holds a whole
leaf), rank 0 writes, and the other ranks wait for it at a barrier. A
checkpoint does not record the mesh it was saved on:
:func:`restore_checkpoint` places every leaf on one ``device`` and, with
``shardings=``, keeps this rank's shard of it by those placements over the
current mesh (the reference's elastic restore), so a state saved on two
ranks restores onto one, four or any other count.

``AsyncCheckpointer`` overlaps serialization with the next train step:
the gather and the device→host copy happen at ``save()``, the disk I/O on
a worker thread (rank 0's), the barrier at ``wait()``.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from repro_torch import sharding as shd
from repro_torch.analysis import racedep
from repro_torch.core.clock import wall_time
from repro_torch.models.params import tree_defs

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer"]

_SEP = "/"


def _ranks() -> tuple[int, int]:
    """(this process's rank, the world size) of the default process group;
    (0, 1) without one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _barrier() -> None:
    """Wait for every rank (nothing to wait for without a group)."""
    if _ranks()[1] > 1:
        import torch.distributed as dist
        dist.barrier()


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # npz has no bf16: store the raw bits; restore views them back
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _raw(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a flat uint8 view (any dtype travels
    through send/recv so)."""
    return t.reshape(-1).view(torch.uint8)


def _gather(tree) -> dict[str, torch.Tensor]:
    """Every DTensor leaf of ``tree`` whole in rank 0's host memory, by
    entry name; an empty dict on the other ranks. Every rank calls it. One
    ``all_gather_object`` tells rank 0 which part of each leaf each rank
    holds; then, leaf by leaf, each distinct shard goes from the lowest
    rank that holds it to rank 0 (``send``/``recv``, one shard's buffer on
    rank 0's device at a time) and into the host copy. The mesh's ranks
    are the default group's."""
    import torch.distributed as dist

    leaves = [(_SEP.join(p), t) for p, t in tree_defs(tree)
              if hasattr(t, "to_local")]
    if not leaves:
        return {}
    rank, world = _ranks()
    boxes = [None] * world
    dist.all_gather_object(boxes, [
        [(b.start, b.stop) for b in shd.shard_box(t.shape, t.placements,
                                                   t.device_mesh)]
        for _, t in leaves])
    out = {}
    for i, (name, t) in enumerate(leaves):
        local = t.to_local().detach().contiguous()
        holder: dict = {}
        for r in range(world):
            holder.setdefault(tuple(map(tuple, boxes[r][i])), r)
        host = (torch.empty(t.shape, dtype=t.dtype) if rank == 0 else None)
        for box, r in holder.items():
            shape = tuple(b - a for a, b in box)
            if 0 in shape:
                continue
            at = tuple(slice(a, b) for a, b in box)
            if r == rank == 0:
                host[at] = local.cpu()
            elif rank == 0:
                buf = torch.empty(shape, dtype=t.dtype, device=local.device)
                dist.recv(_raw(buf), src=r)
                host[at] = buf.cpu()
            elif r == rank:
                dist.send(_raw(local), dst=0)
        if rank == 0:
            out[name] = host
    return out


def _flatten(tree) -> dict[str, np.ndarray] | None:
    """``tree``'s leaves as host arrays by entry name, on rank 0 (every
    rank calls it: :func:`_gather`); None on the other ranks. A CPU leaf
    is cloned: training updates it in place."""
    gathered = _gather(tree)
    if _ranks()[0]:
        return None
    out = {}
    for path, leaf in tree_defs(tree):
        name = _SEP.join(path)
        if name in gathered:
            leaf = gathered[name]
        elif isinstance(leaf, torch.Tensor) and not leaf.is_cuda:
            leaf = leaf.clone()
        out[name] = _to_numpy(leaf)
    return out


def save_checkpoint(ckpt_dir: str | Path, step: int, state, keep: int = 3):
    """Write ``state`` (nested dicts of tensors, DTensors or numpy arrays)
    as step ``step``; keep the newest ``keep`` steps. Under a process
    group every rank calls it: rank 0 gathers the DTensor leaves and
    writes, and the others wait at a barrier."""
    flat = _flatten(state)
    final = Path(ckpt_dir) / f"step_{step:08d}"
    if flat is not None:
        _write(Path(ckpt_dir), step, flat, keep)
    _barrier()
    return final


def _write(ckpt_dir: Path, step: int, flat: dict, keep: int) -> None:
    """One process's write of a flattened state (module doc's layout)."""
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_{step:08d}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    np.savez(tmp / "arrays.npz", **flat)
    meta = {
        "step": step,
        "time": wall_time(),
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in flat.items()},
    }
    (tmp / "meta.json").write_text(json.dumps(meta))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    # atomic LATEST pointer
    ptr = ckpt_dir / ".LATEST.tmp"
    ptr.write_text(final.name)
    ptr.rename(ckpt_dir / "LATEST")
    # retention
    steps = sorted(p for p in ckpt_dir.glob("step_*") if p.is_dir())
    for old in steps[:-keep]:
        shutil.rmtree(old)


def latest_step(ckpt_dir: str | Path) -> int | None:
    ckpt_dir = Path(ckpt_dir)
    ptr = ckpt_dir / "LATEST"
    if not ptr.exists():
        return None
    name = ptr.read_text().strip()
    if not (ckpt_dir / name).is_dir():
        return None
    return int(name.split("_")[1])


def restore_checkpoint(ckpt_dir: str | Path, like_state, *, device="cuda",
                       step: int | None = None, shardings=None):
    """Restore into the structure of ``like_state`` (nested dicts whose
    leaves have ``.shape`` and ``.dtype``: tensors, DTensors or
    ParamDefs), each leaf in that dtype on ``device``. Returns ``(state,
    step)``.

    ``shardings`` (a tree of DTensor placements like ``like_state``, such
    as ``train.state_shardings``) re-shards onto the current ``sharding``
    mesh: every rank reads each leaf into host memory and moves only its
    shard to ``device``, whatever mesh saved it. On a mesh of one device
    the leaves stay whole tensors."""
    if shardings is not None:
        mesh = shd.current_mesh()
        if mesh is None:
            raise ValueError("restore_checkpoint(shardings=) needs a mesh: "
                             "set one (sharding.set_mesh)")
        placements = dict(tree_defs(shardings)) if mesh.size() > 1 else None
    else:
        placements = None
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    out: dict = {}
    with np.load(d / "arrays.npz") as arrays:
        for path, like in tree_defs(like_state):
            key = _SEP.join(path)
            arr = arrays[key]
            if tuple(arr.shape) != tuple(like.shape):
                raise ValueError(f"{key}: shape {arr.shape} != "
                                 f"{tuple(like.shape)}")
            if arr.dtype == np.uint16 and like.dtype == torch.bfloat16:
                t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
            else:
                want = torch.empty((), dtype=like.dtype).numpy().dtype
                t = torch.from_numpy(np.array(arr, dtype=want, order="C"))
            if placements is None:
                t = t.to(device)
            else:
                pl = placements[path]
                t = shd.from_shard(
                    t[shd.shard_box(t.shape, pl, mesh)].contiguous().to(
                        device), t.shape, pl, mesh)
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t
    return out, step


class AsyncCheckpointer:
    """Fire-and-forget saves on a worker thread; ``wait()`` joins the last.

    Under a process group every rank calls ``save`` and ``wait`` at the
    same steps: ``save`` gathers the state to rank 0's host, rank 0's
    worker writes it, and ``wait`` holds every rank at a barrier until it is
    written."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread = None
        self._pending = False
        self.error: Exception | None = None

    def save(self, step: int, state):
        self.wait()
        flat = _flatten(state)  # the gather and D2H now
        self._pending = True
        if flat is None:
            return  # rank 0 writes; this rank waits for it in wait()

        def work():
            try:
                _write(self.ckpt_dir, step, flat, self.keep)
            except Exception as e:  # pragma: no cover
                self.error = e

        # tracked spawn: racedep sees the fork here and the join in wait(),
        # so the flat handoff and self.error are ordered, not racy
        self._thread = racedep.spawn(work, name=f"ckpt-save-{step}")

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            _barrier()
        if self.error:
            raise self.error
