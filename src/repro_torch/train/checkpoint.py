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
point. :func:`restore_checkpoint` places every leaf on one ``device``; the
reference's re-sharding onto another mesh waits for ROADMAP A6.

``AsyncCheckpointer`` overlaps serialization with the next train step:
the device→host copy happens at ``save()``, the disk I/O on a worker
thread.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

from repro_torch.analysis import racedep
from repro_torch.core.clock import wall_time
from repro_torch.models.params import tree_defs, tree_map

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "AsyncCheckpointer"]

_SEP = "/"


def _to_numpy(t) -> np.ndarray:
    if isinstance(t, np.ndarray):
        return t
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        # npz has no bf16: store the raw bits; restore views them back
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_SEP.join(path): _to_numpy(leaf) for path, leaf in tree_defs(tree)}


def save_checkpoint(ckpt_dir: str | Path, step: int, state, keep: int = 3):
    """Write ``state`` (nested dicts of tensors or numpy arrays) as step
    ``step``; keep the newest ``keep`` steps."""
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_{step:08d}_{os.getpid()}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    flat = _flatten(state)
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
    return final


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
    leaves have ``.shape`` and ``.dtype``: tensors or ParamDefs), each
    leaf in that dtype on ``device``. Returns ``(state, step)``.
    ``shardings`` (the reference's re-shard onto another mesh) is refused
    until the port trains on more than one card (ROADMAP A6)."""
    if shardings is not None:
        raise NotImplementedError("restore_checkpoint(shardings=): the "
                                  "re-shard onto another mesh waits for "
                                  "ROADMAP A6")
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
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = t.to(device)
    return out, step


class AsyncCheckpointer:
    """Fire-and-forget saves on a worker thread; ``wait()`` joins the last."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        self.ckpt_dir = Path(ckpt_dir)
        self.keep = keep
        self._thread = None
        self.error: Exception | None = None

    def save(self, step: int, state):
        self.wait()
        # D2H now (a CPU leaf is cloned: training updates it in place)
        host_state = tree_map(
            lambda t: _to_numpy(t if t.is_cuda else t.clone()), state)

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_state, self.keep)
            except Exception as e:  # pragma: no cover
                self.error = e

        # tracked spawn: racedep sees the fork here and the join in wait(),
        # so host_state handoff and self.error are ordered, not racy
        self._thread = racedep.spawn(work, name=f"ckpt-save-{step}")

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.error:
            raise self.error
