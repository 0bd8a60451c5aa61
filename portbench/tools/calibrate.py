"""Readings the output check's limits are set from, on the card.

    python3 portbench/tools/calibrate.py --workload <cell> --seeds 1 2 3
        [--seconds 20]

For each seed, in one process: a run of the cell as ``run.py`` makes it
(the same set-up, traffic and sample, a window of ``--seconds``), the
program's widest gap over the sample, and the float8 control's widest
gap over the same prompts and served tokens (``harness.check``). Prints
one JSON line a seed. The limit lies between the largest program reading
and the smallest control reading (PERF.md gives both and the limit).
"""
import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
os.environ["OMP_NUM_THREADS"] = "1"  # as run.py
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)  # as run.py
    torch.set_num_interop_threads(1)

    from portbench.harness.main import run_cell

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        t0 = time.perf_counter()
        result, checks, notes = run_cell(args.workload, seed, args.seconds,
                                         False, root=ROOT, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          **notes[-1], "attempted": result["attempted"],
                          "metrics": result["metrics"],
                          "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
