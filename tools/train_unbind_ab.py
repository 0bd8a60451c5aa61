"""What the stacked-layer split saves on a training step of ``rwkv6-3b``.

One training step of ``chip_smoke.TRAIN_ARGV``'s configuration (full
width and depth, ``--batch 4 --seq 1024 --microbatches 2``) with each
parameter stack split once by ``torch.unbind``
(``repro_torch.models.model._unstack``, the training forward) and with a
per-layer ``a[i]`` slice (``_layer``, whose backward writes a zero-filled
gradient of the whole stack per layer; patched in for the call). For each:
the host wall time of 2 steps, the peak memory, and one profiled step
(device time, kernel count, the four largest kernels). Needs one CUDA
card; run from the root of a checkout:

    python3 tools/train_unbind_ab.py

Prints one JSON object and the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def train_unbind_ab(seed: int = 0) -> dict:
    import torch

    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.launch import train as launch
    from repro_torch.models import model as M
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step)

    args = launch.parse_args(cs.TRAIN_ARGV)
    cfg = get_config(args.arch)
    tc = TrainConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 2),
                     total_steps=args.steps, microbatches=args.microbatches)
    dev = torch.device("cuda")
    box = [init_train_state(
        cfg, tc, torch.Generator(device=dev).manual_seed(seed), dev)]
    b = TokenDataset(cfg.vocab_size, args.seq, seed=0).shard_batch(
        0, args.batch)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
    step = make_train_step(cfg, tc)

    def one():
        box[0] = step(box[0], batch)[0]
        torch.cuda.synchronize()

    unstack, out = M._unstack, {}
    try:
        for name, split in (("unbind", unstack), ("slices", lambda tree, n: [
                M._layer(tree, i) for i in range(n)])):
            M._unstack = split
            one()
            torch.cuda.reset_peak_memory_stats()
            walls = []
            for _ in range(2):
                t0 = time.perf_counter()
                one()
                walls.append(time.perf_counter() - t0)
            peak = torch.cuda.max_memory_allocated() / 1e9
            prof = cs._profile_range(one, 1e3 * min(walls), *cs.TRAIN_RANGES)
            out[name] = dict(step_s=walls, peak_gb=peak,
                             device_ms=prof["device_ms"],
                             kernels=prof["kernels"], top=prof["top"][:4])
    finally:
        M._unstack = unstack
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_unbind_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from repro_torch.kernels import _build
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(train_unbind_ab()))
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
