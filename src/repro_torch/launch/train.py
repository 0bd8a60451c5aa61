"""Training launcher, the port's ``repro.launch.train``.

    python -m repro_torch.launch.train --arch <id> [--smoke] [--steps N]
        [--batch B] [--seq S] [--microbatches K] [--lr LR] [--compress]
        [--ckpt DIR] [--resume] [--ckpt-every N] [--device cuda]

Trains one model on one device (``cuda`` unless ``--device cpu``): the
parameters are random, from a ``torch.Generator`` seeded with 0 on the
device; the batches are ``data.TokenDataset``'s shards (seed 0, shard =
step), the vlm and audio families conditioned on zeros as the reference
feeds them. The loop is the reference's: the train step
(``train.make_train_step``), async checkpoints every ``--ckpt-every``
steps and at the end, restore-on-start with ``--resume``. Training on
the production mesh (``--multi-pod``) needs more than one card (ROADMAP
A6) and is refused. :func:`run` returns the per-step losses and times
and the final state to a caller; :func:`main` prints them.
"""
import argparse
import sys

from repro_torch.core.clock import wall_time


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
                    help="the production mesh: not in the port yet")
    args = ap.parse_args(argv)
    if args.multi_pod:
        ap.error("--multi-pod: the port trains on one device; training "
                 "under the production mesh's sharding waits for ROADMAP "
                 "A6")
    return args


def run(args: argparse.Namespace, on_step=None) -> dict:
    """Train as ``args`` says. ``on_step(step, state, metrics)``, if given,
    is called after each step (``step`` counted from 1). Returns ``cfg``,
    ``tc``, the final ``state``, ``start`` (the step resumed from),
    ``losses`` and ``step_s`` (host seconds of each step, synchronised)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)
    from repro_torch.train.checkpoint import (AsyncCheckpointer,
                                              latest_step,
                                              restore_checkpoint)
    from repro_torch.wsi.jpeg import resolve_device

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    tc = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                     total_steps=args.steps,
                     microbatches=args.microbatches,
                     compress="int8_ef" if args.compress else "none")
    print(f"arch={cfg.name} device={dev}")
    step_fn = make_train_step(cfg, tc)
    state = init_train_state(
        cfg, tc, torch.Generator(device=dev).manual_seed(0), dev)
    start = 0
    ck = AsyncCheckpointer(args.ckpt, keep=3) if args.ckpt else None
    if args.resume and args.ckpt and latest_step(args.ckpt) is not None:
        state, start = restore_checkpoint(args.ckpt, state, device=dev)
        print(f"resumed from step {start}")

    ds = TokenDataset(cfg.vocab_size, args.seq, seed=0)
    losses, step_s = [], []
    for i in range(start, args.steps):
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in ds.shard_batch(i, args.batch).items()}
        if cfg.family in ("vlm", "audio"):
            batch["cond"] = torch.zeros(
                (args.batch, cfg.n_cross_tokens, cfg.d_model),
                dtype=cfg.dtype, device=dev)
        t0 = wall_time()
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))  # waits for the step
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
    return dict(cfg=cfg, tc=tc, state=state, start=start, losses=losses,
                step_s=step_s)


def main(argv=None) -> int:
    args = parse_args(argv)
    out = run(args)
    loss = out["losses"][-1] if out["losses"] else float("nan")
    print(f"finished at loss {loss:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
