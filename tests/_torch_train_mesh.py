"""Jobs on a ``gloo`` process group of N CPU processes, for
``tests/test_torch_train_mesh.py``.

    python tests/_torch_train_mesh.py N PORT JOBS.json OUT.json

Every rank runs the jobs of JOBS.json in order, on the ranks' ``("data",)``
mesh (``launch.mesh.make_local_mesh``); rank 0 writes one result per job
to OUT.json. The jobs:

- ``draw``: ``init_train_state`` from seed 0 under the mesh: whether every
  leaf is a DTensor in ``state_shardings``' placements and, gathered,
  equals the one-device draw bit for bit;
- ``restore``: ``restore_checkpoint(shardings=state_shardings(...))`` of
  a checkpoint step: whether every leaf lies in those placements and,
  gathered, equals the saved arrays bit for bit; with ``save_to`` the
  restored state is then saved there from these ranks;
- ``train``: ``launch.train.run`` on ``argv`` (the launcher takes the
  group's mesh itself): the losses, the step it started from and the mesh;
  with ``"fault": "unreduced"`` under a planted fault (:func:`unreduced`);
- ``dryrun``: ``launch.dryrun.run_cell`` of a local cell on the ranks laid
  out as ``mesh_shape``, under ``CommDebugMode``: the cell's record (its
  collective bytes and op table's collective rows) and the collectives
  ``CommDebugMode`` counted.

Run as a script: each rank is a process started with the ``spawn``
method, on one intra-op thread, with the port's lockdep and racedep armed
(:func:`armed`): a violation, in the checkpoint's rank-0 writer and
barrier or elsewhere, fails the rank.
"""
import json
import sys
from contextlib import contextmanager, nullcontext
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


@contextmanager
def armed():
    """The port's lockdep and racedep armed, as tests/_torch_spine.py's
    fixtures arm them; raises ``AssertionError`` on any violation."""
    from repro_torch.analysis import lockdep, racedep

    lockdep.arm(max_hold=30.0)
    racedep.arm()
    try:
        yield
    finally:
        found = [f"[{v.kind}] {v.message}" for v in lockdep.disarm()]
        found += [v.message for v in racedep.disarm()]
        if found:
            raise AssertionError("port detectors: " + "; ".join(found))


@contextmanager
def unreduced():
    """A planted fault for the loss bounds' power: every rank trains alone
    (no mesh, no collective in the step) on its own rows of each batch, so
    its gradient is never reduced with the other ranks'; only the loss the
    launcher reports is averaged over the ranks. While the ranks'
    parameters agree that average is the whole batch's mean loss, so the
    first step's loss is right and the fault shows from the second step
    on."""
    from repro_torch import sharding as shd
    from repro_torch.data import TokenDataset
    from repro_torch.launch import train as launch

    rank, n = dist.get_rank(), dist.get_world_size()
    shard_batch, group_device, whole = (TokenDataset.shard_batch,
                                        launch._group_device, shd.whole)

    def own_rows(self, shard, batch):
        k = batch // n
        return {key: v[rank * k:(rank + 1) * k]
                for key, v in shard_batch(self, shard, batch).items()}

    def mean_over_ranks(t):
        t = t.detach().clone()
        dist.all_reduce(t)
        return t / n

    TokenDataset.shard_batch = own_rows
    launch._group_device = lambda device: (group_device(device)[0], False)
    shd.whole = mean_over_ranks
    try:
        yield
    finally:
        TokenDataset.shard_batch = shard_batch
        launch._group_device = group_device
        shd.whole = whole


def saved_arrays(ckpt: str, step: int) -> dict:
    """A checkpoint step's arrays as tensors (bf16 from its stored bits)."""
    out = {}
    with np.load(Path(ckpt) / f"step_{step:08d}" / "arrays.npz") as z:
        for k in z.files:
            a = z[k]
            out[k] = (torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
                      if a.dtype == np.uint16 else torch.from_numpy(a))
    return out


def _config(job: dict):
    from repro_torch.configs import get_config
    from repro_torch.train import TrainConfig
    return get_config(job["arch"] + "-smoke"), TrainConfig()


def _laid_out(tree, placements) -> tuple[int, int, list]:
    """(leaves, leaves with a Shard placement, paths whose placements are
    not ``placements``' or that are no DTensor)."""
    from repro_torch.models.params import tree_defs
    want = dict(tree_defs(placements))
    wrong, sharded, n = [], 0, 0
    for path, t in tree_defs(tree):
        n += 1
        pl = tuple(getattr(t, "placements", ()))
        if pl != tuple(want[path]):
            wrong.append("/".join(path))
        sharded += any(p.is_shard() for p in pl)
    return n, sharded, wrong


def _draw(job, mesh) -> dict:
    from repro_torch import sharding as shd
    from repro_torch.models.params import tree_defs
    from repro_torch.train import init_train_state, state_shardings
    cfg, tc = _config(job)
    whole = dict(tree_defs(init_train_state(
        cfg, tc, torch.Generator().manual_seed(0), "cpu")))
    with shd.set_mesh(mesh):
        state = init_train_state(cfg, tc, torch.Generator().manual_seed(0),
                                 "cpu")
    n, sharded, wrong = _laid_out(state, state_shardings(cfg, tc, mesh))
    differ = ["/".join(p) for p, t in tree_defs(state)
              if not torch.equal(t.full_tensor(), whole[p])]
    return dict(leaves=n, sharded=sharded, wrong_placements=wrong,
                differ=differ)


def _restore(job, mesh) -> dict:
    from repro_torch import sharding as shd
    from repro_torch.models.params import tree_defs
    from repro_torch.train import state_shardings, train_state_defs
    from repro_torch.train.checkpoint import (restore_checkpoint,
                                              save_checkpoint)
    cfg, tc = _config(job)
    with shd.set_mesh(mesh):
        state, step = restore_checkpoint(
            job["ckpt"], train_state_defs(cfg, tc), device="cpu",
            step=job["step"], shardings=state_shardings(cfg, tc, mesh))
        if job.get("save_to"):
            save_checkpoint(job["save_to"], step, state)
    saved = saved_arrays(job["ckpt"], step)
    n, sharded, wrong = _laid_out(state, state_shardings(cfg, tc, mesh))
    differ = []
    for path, t in tree_defs(state):
        got, want = t.full_tensor(), saved["/".join(path)]
        if got.dtype != want.dtype or not torch.equal(got, want):
            differ.append("/".join(path))
    return dict(step=step, leaves=n, sharded=sharded,
                wrong_placements=wrong, differ=differ)


def _train(job, mesh) -> dict:
    from repro_torch.launch import train as launch
    with unreduced() if job.get("fault") == "unreduced" else nullcontext():
        out = launch.run(launch.parse_args(job["argv"]))
    return dict(losses=out["losses"], start=out["start"],
                mesh=None if out["mesh"] is None else list(out["mesh"].shape))


def _dryrun(job, mesh) -> dict:
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    comm = CommDebugMode()
    with comm:
        rec = dryrun.run_cell(get_config(job["arch"]),
                              ShapeConfig(*job["shape"]), "local",
                              device="cpu", mesh_shape=job["mesh_shape"])
    counts = {}
    for op, n in comm.get_comm_counts().items():
        name = str(op).split(".")[-1]
        counts[name] = counts.get(name, 0) + n
    return dict(ok=rec["ok"], error=rec.get("error"), chips=rec.get("chips"),
                collectives=rec.get("collectives"),
                op_rows={k: v[0] for k, v in rec.get("ops", {}).items()
                         if "c10d" in k},
                comm_counts=counts)


JOBS = {"draw": _draw, "restore": _restore, "train": _train,
        "dryrun": _dryrun}


def _rank(rank: int, n: int, port: int, jobs_path: str, out: str) -> None:
    from repro_torch.launch.mesh import make_local_mesh

    torch.set_num_threads(1)  # the ranks share the machine's cores
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        mesh = make_local_mesh("cpu")
        with armed():
            results = [JOBS[job["kind"]](job, mesh)
                       for job in json.loads(Path(jobs_path).read_text())]
        if rank == 0:
            Path(out).write_text(json.dumps(results))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    n, port, jobs, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
    mp.start_processes(_rank, args=(n, port, jobs, out), nprocs=n,
                       start_method="spawn")
