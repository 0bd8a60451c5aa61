"""Data pipeline: deterministic synthetic LM streams + elastic shard queue."""
from repro_torch.data.pipeline import (ShardQueue, TokenDataset,  # noqa: F401
                                       make_lm_batch)
