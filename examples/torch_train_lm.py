"""End-to-end training on the PyTorch/CUDA port: event-driven data shards
→ train steps → async checkpoints → crash → elastic restore → continue.

    PYTHONPATH=src python examples/torch_train_lm.py [--arch gemma-2b]
        [--steps 200] [--batch 8] [--seq 64] [--full] [--compress]
        [--device cuda]

The port's ``examples/train_lm.py``. Uses the reduced config of the chosen
arch by default so a few hundred steps run in minutes (pass --full for
the published config). Demonstrates the full substrate: the pub/sub shard
queue (at-least-once data delivery), AdamW with grad accumulation, async
checkpointing, and a simulated mid-run crash at ``steps // 2`` + restore
(the restored step must be the crash step). The parameters are random,
from a ``torch.Generator`` seeded with 0 on the device. Everything runs on
the card unless ``--device cpu`` is passed; without a card the default
fails rather than running on the CPU. Ends with "train_lm OK".
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch

from repro_torch.configs import get_config
from repro_torch.core import SimScheduler, Topic
from repro_torch.core.clock import monotonic
from repro_torch.data import ShardQueue, TokenDataset
from repro_torch.train import TrainConfig, init_train_state, make_train_step
from repro_torch.train.checkpoint import AsyncCheckpointer, restore_checkpoint
from repro_torch.wsi.jpeg import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--full", action="store_true",
                    help="published config (needs a card with the memory)")
    ap.add_argument("--compress", action="store_true",
                    help="int8 error-feedback gradient compression")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)  # no card: raise, never the CPU

    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    tc = TrainConfig(lr=3e-3, warmup_steps=10, total_steps=args.steps,
                     compress="int8_ef" if args.compress else "none")
    print(f"arch={cfg.name} d_model={cfg.d_model} L={cfg.num_layers} "
          f"steps={args.steps} compress={tc.compress} device={dev}")

    step_fn = make_train_step(cfg, tc)
    state = init_train_state(cfg, tc,
                             torch.Generator(device=dev).manual_seed(0), dev)
    ds = TokenDataset(cfg.vocab_size, args.seq, seed=0)

    # event-driven shard dispatch (the paper's pattern at the data layer)
    sched = SimScheduler()
    topic = Topic("train-shards", sched)
    queue = ShardQueue(topic)
    queue.publish_epoch(n_shards=args.steps)
    sched.run()

    ckpt_dir = Path(tempfile.mkdtemp(prefix="repro_torch_ckpt_"))
    ck = AsyncCheckpointer(ckpt_dir, keep=2)
    t0 = monotonic()
    crash_at = args.steps // 2
    i = 0
    while True:
        item = queue.poll()
        if item is None:
            sched.run()
            if queue.poll() is None:
                break
            continue
        shard, ack = item
        batch = {k: torch.as_tensor(v, device=dev)
                 for k, v in ds.shard_batch(shard["shard"], args.batch).items()}
        if cfg.family in ("vlm", "audio"):
            batch["cond"] = torch.zeros(
                (args.batch, cfg.n_cross_tokens, cfg.d_model),
                dtype=cfg.dtype, device=dev)
        state, m = step_fn(state, batch)
        ack()  # shard consumed — at-least-once bookkeeping
        i += 1
        if i % 20 == 0 or i == 1:
            print(f"step {i:4d} loss {float(m['loss']):.4f} "
                  f"lr {float(m['lr']):.2e} gnorm {float(m['grad_norm']):.2f} "
                  f"({(monotonic() - t0) / i:.2f}s/step)")
        if i % 50 == 0:
            ck.save(i, state)
        if i == crash_at:
            ck.save(i, state)
            ck.wait()
            print(f"-- simulated crash at step {i}; elastic restore --")
            state, restored_step = restore_checkpoint(ckpt_dir, state,
                                                      device=dev)
            if restored_step != i:
                raise RuntimeError(f"restored step {restored_step}, crashed "
                                   f"at {i}")
        if i >= args.steps:
            break
    ck.wait()
    print(f"done: {i} steps, final loss {float(m['loss']):.4f} "
          f"({(monotonic() - t0) / i:.2f}s/step), checkpoints in {ckpt_dir}")
    print("train_lm OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
