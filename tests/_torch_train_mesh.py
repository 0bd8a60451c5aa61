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
  collective bytes, per-device FLOPs and bytes, and op table's collective
  rows), the collectives ``CommDebugMode`` counted, and every rank's
  counted peak of the storage the step held (``temp_bytes_by_rank``),
  the least over ``reps`` runs of the cell (default 1): gloo's worker
  thread lets go of a collective's buffers a moment after the wait
  returns, so one run's peak can exceed the program's own by such a
  buffer (8192 or 24576 B in 5 of 112 rank-runs of a reduced prefill);
- ``logits``: a prefill or decode cell's step on the ranks laid out as
  ``mesh_shape`` (its arguments drawn whole from seed 0 on every rank and
  laid out by the policy, as ``run_cell`` lays them out; a decode's cache
  filled with a history first, :func:`_history`), its logits gathered,
  against the same step run on this rank alone with no mesh: the largest
  absolute difference and logit; ``"window"`` gives the config that
  sliding window; with ``"fault": "misplaced"`` or ``"decode_uncombined"``
  under that planted fault (:func:`misplaced`, :func:`decode_uncombined`);
- ``grads``: ``train.step.loss_and_grads`` of a reduced config on a batch
  of ``batch`` (rows, seq) drawn from seed 1, on the ranks laid out as
  ``mesh_shape`` and on this rank alone: each leaf's largest absolute
  difference over the one process's largest magnitude; with ``"fault":
  "vocab_unreduced"`` under a planted fault (:func:`vocab_unreduced`).

Run as a script: each rank is a process started with the ``spawn``
method, on one intra-op thread, with the port's lockdep and racedep armed
(:func:`armed`): a violation, in the checkpoint's rank-0 writer and
barrier or elsewhere, fails the rank.
"""
import dataclasses
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


@contextmanager
def misplaced():
    """A planted fault for the logits bound's power: every output of
    ``sharding.local_call`` is declared on the wrong mesh axes, its
    placements on 'data' and 'model' swapped. Each rank's shard is
    unchanged, and on a mesh whose two axes are of one size so is the
    global shape: only which rows and heads a rank holds is wrong."""
    from torch.distributed.tensor import DTensor

    from repro_torch import sharding as shd

    call = shd.local_call

    def swapped(o):
        if not isinstance(o, DTensor):
            return o
        pl = list(o.placements)
        i, j = (o.device_mesh.mesh_dim_names.index(a)
                for a in ("data", "model"))
        pl[i], pl[j] = pl[j], pl[i]
        return DTensor.from_local(o.to_local(), o.device_mesh, pl,
                                  run_check=False, shape=o.shape,
                                  stride=o.stride())

    shd.local_call = lambda *a, **k: tuple(swapped(o)
                                           for o in call(*a, **k))
    try:
        yield
    finally:
        shd.local_call = call


@contextmanager
def _reduced_over_no_rank():
    """Every ``reduce`` that ``sharding.local_call`` hands its function
    reduces over no mesh axis: each rank keeps its own partial result."""
    from repro_torch import sharding as shd

    reducer = shd._reducer
    shd._reducer = lambda dmesh, axes: reducer(dmesh, ())
    try:
        yield
    finally:
        shd._reducer = reducer


def vocab_unreduced():
    """A planted fault for the gradient bound's power on the loss head:
    the vocab-parallel cross-entropy reduces nothing over the ranks that
    split the vocab, so each rank's loss is that of its vocab slice."""
    return _reduced_over_no_rank()


def decode_uncombined():
    """A planted fault for the logits bound's power on the context-parallel
    decode: the softmax of each rank's K/V sequence shard is not combined
    over ``kvseq`` (its max, sum of exponentials and weighted values stay
    the rank's own), so each rank attends to its own slots only."""
    return _reduced_over_no_rank()


FAULTS = {"misplaced": misplaced, "vocab_unreduced": vocab_unreduced,
          "decode_uncombined": decode_uncombined}


def _fault(job):
    return FAULTS[job["fault"]]() if job.get("fault") else nullcontext()


def _history(cfg, cache, S: int, gen) -> "torch.Tensor":
    """Fill a dense decode cache (whole tensors, in place) with a history
    and return the step's positions (B,), drawn in [1, S): random K/V
    (int8 and positive scales under ``+kv8``) and, in each row, slots that
    hold earlier positions (slot ``p % W`` under a window, where a slot
    may hold a position the window has passed, else slot ``p``) or stay
    ``UNWRITTEN``. Row 0 decodes at position 1, so every sequence shard
    but the first holds only free slots."""
    from repro_torch.models.params import UNWRITTEN

    B, W = cache["kv_pos"].shape
    pos = torch.randint(1, S, (B,), generator=gen, dtype=torch.int32)
    pos[0] = 1
    slots = torch.arange(W, dtype=torch.int32)
    laps = torch.randint(0, max(S // W, 1), (B, W), generator=gen,
                         dtype=torch.int32)
    p = slots + W * torch.minimum(laps, (pos[:, None] - 1 - slots) // W)
    cache["kv_pos"].copy_(torch.where(slots < pos[:, None], p, UNWRITTEN))
    for key in ("k", "v"):
        t = cache[key]
        t.copy_(torch.randint(-127, 128, t.shape, generator=gen)
                if t.dtype == torch.int8 else
                torch.randn(t.shape, generator=gen))
        if key + "_scale" in cache:
            sc = cache[key + "_scale"]
            sc.copy_(0.005 + 0.01 * torch.rand(sc.shape, generator=gen))
    return pos


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
    def run():
        return dryrun.run_cell(get_config(job["arch"]),
                               ShapeConfig(*job["shape"]), "local",
                               device="cpu", mesh_shape=job["mesh_shape"])

    comm = CommDebugMode()
    with comm:
        rec = run()
    counts = {}
    for op, n in comm.get_comm_counts().items():
        name = str(op).split(".")[-1]
        counts[name] = counts.get(name, 0) + n
    peak = rec.get("memory", {}).get("temp_bytes")
    for _ in range(job.get("reps", 1) - 1):
        peak = min(peak, run()["memory"]["temp_bytes"])
    peaks = [None] * dist.get_world_size()
    dist.all_gather_object(peaks, peak)
    return dict(ok=rec["ok"], error=rec.get("error"), chips=rec.get("chips"),
                temp_bytes_by_rank=peaks,
                collectives=rec.get("collectives"),
                flops_per_device=rec.get("flops_per_device"),
                bytes_per_device=rec.get("bytes_per_device"),
                op_rows={k: v[0] for k, v in rec.get("ops", {}).items()
                         if "c10d" in k},
                comm_counts=counts)


def _logits(job, mesh) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import sharding as shd
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map
    cfg, shape = get_config(job["arch"]), ShapeConfig(*job["shape"])
    if job.get("window"):
        cfg = dataclasses.replace(cfg, sliding_window=job["window"])
    grid = make_local_mesh("cpu", *job["mesh_shape"])
    fn, groups, _ = dryrun._step(cfg, shape, M.param_count(cfg),
                                 shd.axis_sizes(grid)["model"], None)
    args = dryrun._real_args(cfg, shape, groups, torch.device("cpu"), None,
                             0)
    if shape.kind == "decode":
        args[3] = _history(cfg, args[1], shape.seq_len,
                           torch.Generator().manual_seed(1))
    # a decode step writes its cache in place: each run takes its own copy
    laid = [shd.lay_out_tree(tree_map(torch.clone, a), tree_map(
        lambda d, p=p: shd.named_sharding(d.shape, d.logical, grid, p),
        defs), grid) for a, (defs, p) in zip(args, groups)]
    want = fn(*args)[0]
    with shd.set_mesh(grid), implicit_replication(), _fault(job):
        got = fn(*laid)[0].full_tensor()
    return dict(shape=list(got.shape),
                max_abs=float((got - want).abs().max()),
                max_logit=float(want.abs().max()))


def _grads(job, mesh) -> dict:
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_defs, tree_map
    from repro_torch.train.step import batch_defs, loss_and_grads
    cfg, (B, S) = get_config(job["arch"]), job["batch"]
    grid = make_local_mesh("cpu", *job["mesh_shape"])
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    want = dict(tree_defs(loss_and_grads(params, cfg, batch)[1]))
    defs = batch_defs(cfg, B, S)
    laid = shd.lay_out_tree(params, tree_map(
        lambda d: shd.named_sharding(d.shape, d.logical, grid),
        M.model_defs(cfg)), grid)
    lb = {k: shd.lay_out(v, shd.named_sharding(
        defs[k].shape, defs[k].logical, grid), grid) for k, v in batch.items()}
    with shd.set_mesh(grid), implicit_replication(), _fault(job):
        got = loss_and_grads(laid, cfg, lb)[1]
    return {"/".join(p): float((t.full_tensor() - want[p]).abs().max()
                               / want[p].abs().max())
            for p, t in tree_defs(got)}


JOBS = {"draw": _draw, "restore": _restore, "train": _train,
        "dryrun": _dryrun, "logits": _logits, "grads": _grads}


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
