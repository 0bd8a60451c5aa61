"""Training launcher, the port's ``repro.launch.train``.

    python -m repro_torch.launch.train --arch <id> [--smoke] [--steps N]
        [--batch B] [--seq S] [--microbatches K] [--lr LR] [--compress]
        [--ckpt DIR] [--resume] [--ckpt-every N] [--device cuda]
        [--multi-pod]
    torchrun --nproc-per-node N -m repro_torch.launch.train ...

Alone it trains one model on one device (``cuda`` unless ``--device
cpu``). Under a process group (``torchrun``, which sets ``WORLD_SIZE``:
the group is initialised here, ``nccl`` for ``cuda`` and ``gloo`` for the
CPU; or one the caller initialised) it trains on
``launch.mesh.make_local_mesh()``, every rank on the ``("data",)`` axis,
each on its own card (``LOCAL_RANK``) or the CPU: the state is laid out by
``train.state_shardings``, each batch by ``train.batch_shardings``, and
the step runs on DTensors, as the reference's ``--smoke`` path runs on its
local mesh. ``--multi-pod`` trains on the ``(2, 32, 8)`` production mesh
over a group of exactly 512 ranks and is refused on any other.

The parameters are random, from a ``torch.Generator`` seeded with 0 on the
device (drawn whole on every rank, then sharded: the same values on any
mesh); the batches are ``data.TokenDataset``'s shards (seed 0, shard =
step), the vlm and audio families conditioned on zeros as the reference
feeds them. The loop is the reference's: the train step
(``train.make_train_step``), async checkpoints every ``--ckpt-every``
steps and at the end (rank 0 writes), restore-on-start with ``--resume``
(re-sharded onto this run's mesh, whatever mesh saved it). :func:`run`
returns the per-step losses and times and the final state to a caller;
:func:`main` prints them.
"""
import argparse
import contextlib
import os
import sys

from repro_torch.core.clock import wall_time

#: ranks the --multi-pod production mesh (2, 32, 8) takes
MULTI_POD_RANKS = 512


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (2, 32, 8) production mesh over a process "
                         f"group of {MULTI_POD_RANKS} ranks")
    args = ap.parse_args(argv)
    if args.multi_pod:
        import torch.distributed as dist
        # the group's size, or torchrun's before the group exists
        world = dist.get_world_size() if dist.is_initialized() else int(
            os.environ.get("WORLD_SIZE", "1"))
        if world != MULTI_POD_RANKS:
            ap.error(f"--multi-pod: the (2, 32, 8) production mesh needs a "
                     f"process group of {MULTI_POD_RANKS} ranks (torchrun); "
                     f"this one has world size {world}")
    return args


def _group_device(device: str):
    """This process's device, after initialising the process group that
    ``torchrun``'s ``WORLD_SIZE`` asks for (``nccl`` on cards, ``gloo`` on
    the CPU) if none exists. Under a group a CUDA device is this rank's
    card (``LOCAL_RANK``, else the rank modulo the visible cards). Returns
    ``(device, grouped)``."""
    import torch
    import torch.distributed as dist

    from repro_torch.wsi.jpeg import resolve_device

    dev = resolve_device(device)
    if not dist.is_initialized() and int(os.environ.get("WORLD_SIZE",
                                                        "1")) > 1:
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    grouped = dist.is_initialized() and dist.get_backend() != "fake"
    if grouped and dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                                   % torch.cuda.device_count()))
        torch.cuda.set_device(local)
        dev = torch.device("cuda", local)
    return dev, grouped


def run(args: argparse.Namespace, on_step=None) -> dict:
    """Train as ``args`` says. ``on_step(step, state, metrics)``, if given,
    is called after each step (``step`` counted from 1). Returns ``cfg``,
    ``tc``, ``mesh`` (``None`` alone), the final ``state`` (DTensors under
    a mesh of several ranks), ``start`` (the step resumed from),
    ``losses`` and ``step_s`` (host seconds of each step, synchronised)."""
    import torch

    from repro_torch import sharding as shd
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_local_mesh
    from repro_torch.train import (TrainConfig, batch_shardings,
                                   init_train_state, make_train_step,
                                   state_shardings)
    from repro_torch.train.checkpoint import (AsyncCheckpointer,
                                              latest_step,
                                              restore_checkpoint)

    dev, grouped = _group_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    tc = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                     total_steps=args.steps,
                     microbatches=args.microbatches,
                     compress="int8_ef" if args.compress else "none")
    mesh = None
    if args.multi_pod:  # parse_args saw a group of MULTI_POD_RANKS
        mesh = make_local_mesh(dev, *PRODUCTION_SHAPES["multi"])
    elif grouped:
        mesh = make_local_mesh(dev)
    sharded = mesh is not None and mesh.size() > 1
    with contextlib.ExitStack() as stack:
        if mesh is not None:
            stack.enter_context(shd.set_mesh(mesh))
            print(f"arch={cfg.name} device={dev} mesh="
                  f"{dict(shd.axis_sizes(mesh))}")
        else:
            print(f"arch={cfg.name} device={dev}")
        if sharded:
            # plain tensors a step makes (positions, masks, zero states)
            # count as replicated, as in the dry run
            from torch.distributed.tensor.experimental import \
                implicit_replication
            stack.enter_context(implicit_replication())
        step_fn = make_train_step(cfg, tc)
        state = init_train_state(
            cfg, tc, torch.Generator(device=dev).manual_seed(0), dev)
        start = 0
        ck = AsyncCheckpointer(args.ckpt, keep=3) if args.ckpt else None
        if args.resume and args.ckpt and latest_step(args.ckpt) is not None:
            state, start = restore_checkpoint(
                args.ckpt, state, device=dev, shardings=(
                    state_shardings(cfg, tc, mesh) if mesh is not None
                    else None))
            print(f"resumed from step {start}")

        ds = TokenDataset(cfg.vocab_size, args.seq, seed=0)
        batch_pl = (batch_shardings(cfg, args.batch, args.seq, mesh)
                    if sharded else None)
        losses, step_s = [], []
        for i in range(start, args.steps):
            batch = {k: torch.as_tensor(v, device=dev)
                     for k, v in ds.shard_batch(i, args.batch).items()}
            if cfg.family in ("vlm", "audio"):
                batch["cond"] = torch.zeros(
                    (args.batch, cfg.n_cross_tokens, cfg.d_model),
                    dtype=cfg.dtype, device=dev)
            if sharded:
                batch = shd.lay_out_tree(batch, batch_pl, mesh)
            t0 = wall_time()
            state, m = step_fn(state, batch)
            losses.append(float(shd.whole(m["loss"])))  # waits for the step
            step_s.append(wall_time() - t0)
            if on_step is not None:
                on_step(i + 1, state, m)
            if (i + 1) % 10 == 0:
                print(f"step {i+1:5d} loss {losses[-1]:.4f} "
                      f"({sum(step_s) / len(step_s):.2f}s/step)")
            if ck and (i + 1) % args.ckpt_every == 0:
                ck.save(i + 1, state)
        if ck:
            ck.save(args.steps, state)
            ck.wait()
    return dict(cfg=cfg, tc=tc, mesh=mesh, state=state, start=start,
                losses=losses, step_s=step_s)


def main(argv=None) -> int:
    import torch.distributed as dist

    args = parse_args(argv)
    ours = not dist.is_initialized()  # a group run() starts, main ends
    try:
        out = run(args)
    finally:
        if ours and dist.is_initialized():
            dist.destroy_process_group()
    loss = out["losses"][-1] if out["losses"] else float("nan")
    print(f"finished at loss {loss:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
