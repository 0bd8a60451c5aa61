"""Carry ``repro``'s parameter and cache trees into the port.

``repro`` keeps its trees as nested dicts of jax arrays; a caller hands
them over as nested dicts of numpy arrays. numpy has no bfloat16, so bf16
leaves travel as float32 (``np.asarray(a.astype(jnp.float32))``) and are
cast back here to their ``ParamDef`` dtype: bf16 → f32 → bf16 is exact.
Integer leaves (an int8 KV cache, the int32 ``kv_pos``) travel as they are
and must arrive in their own dtype. The tree's keys must be the
definition's: a tied model has no ``head``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import model as M
from repro_torch.models.params import ParamDef, tree_map

__all__ = ["params_from_numpy", "cache_from_numpy"]


def _from_numpy(defs, tree, device):
    def leaf(d: ParamDef, a):
        a = np.asarray(a)
        if tuple(a.shape) != tuple(d.shape):
            raise ValueError(f"shape {a.shape} does not match the "
                             f"definition's {d.shape}")
        if not d.dtype.is_floating_point:
            want = torch.empty((), dtype=d.dtype).numpy().dtype
            if a.dtype != want:
                raise ValueError(f"an integer leaf of {d.dtype} arrived as "
                                 f"{a.dtype}, not {want}")
        return torch.from_numpy(np.array(a, order="C")).to(
            device=device, dtype=d.dtype)

    return tree_map(leaf, defs, tree)


def params_from_numpy(tree, cfg, device="cuda"):
    """``repro``'s parameters for ``cfg`` (nested dicts of numpy arrays) →
    the port's, each leaf in its ``ParamDef`` dtype on ``device``."""
    return _from_numpy(M.model_defs(cfg), tree, device)


def cache_from_numpy(tree, cfg, batch: int, max_len: int, device="cuda"):
    """``repro``'s decode cache for ``cfg`` at (``batch``, ``max_len``) →
    the port's, each leaf in its ``ParamDef`` dtype on ``device``."""
    return _from_numpy(M.cache_defs(cfg, batch, max_len), tree, device)
