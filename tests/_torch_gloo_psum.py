"""``compressed_psum`` over a ``gloo`` process group of N CPU processes.

    python tests/_torch_gloo_psum.py N PORT OUT.npy

Rank r sums row r of the seeded (N, 128) normal matrix that
``tests/test_torch_compress.py`` and ``repro``'s shard_map recipe use;
rank 0 saves the result to OUT.npy. Run as a script: each rank is a
process started with the ``spawn`` method.
"""
import sys

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rows(n: int) -> np.ndarray:
    return np.random.default_rng(0).normal(0, 1, (n, 128)).astype(np.float32)


def _rank(rank: int, n: int, port: int, out: str) -> None:
    from repro_torch.comms.compress import compressed_psum

    torch.set_num_threads(1)  # eight ranks share the machine's cores
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=n, rank=rank)
    try:
        total = compressed_psum(torch.from_numpy(rows(n)[rank]))
        if rank == 0:
            np.save(out, total.numpy())
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    n, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    mp.start_processes(_rank, args=(n, port, out), nprocs=n,
                       start_method="spawn")
