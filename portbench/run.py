"""Run one cell of the benchmark on this machine's card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Run from the root of a checkout that holds ``BENCHMARK.json``,
``portbench/`` and the program (``src/repro_torch``). Prints the compared
numbers beside their limits as the last lines of standard error, and one
JSON object as the last line of standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` last. Exits non-zero and prints no result
when there is no card, when the program is not in the checkout, or when
JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache the program or torch could write stays in the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                 ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(ROOT / "build" / "portbench-cache" / sub)
os.environ["USE_FLAX"] = "0"
# one process with few threads: torch's CPU pool, idle in a serving loop,
# otherwise spins beside the host thread that launches the card's work
os.environ["OMP_NUM_THREADS"] = "1"
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    torch.set_num_interop_threads(1)

    from portbench.harness import isolation
    from portbench.harness.main import run_cell
    from portbench.harness.registry import resolve

    chips = resolve(args.workload, ROOT).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); this "
              f"machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: the program is not in this checkout ({e})",
              file=sys.stderr)
        return 2
    result, checks, notes = run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), root=ROOT,
                                     t_start=T_START)
    found = isolation.loaded_jax()
    if found:
        print(f"portbench: the process loaded {sorted(found)}; the port "
              "must run without JAX and the JAX package", file=sys.stderr)
        return 3
    for line in notes:
        print(f"portbench: {line}", file=sys.stderr)
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
