"""Weights from the seed, on the device, in a few large calls.

Every leaf of a reference's layout (``reference.<family>.layout``) is a
view into one buffer of the served dtype: the normal leaves are drawn by
one ``randn`` over their region and scaled leaf by leaf, the uniform ones
by one ``uniform_`` and mapped to their ranges, the constants filled.
Each leaf starts on a 128-byte boundary. The same seed gives the same
tensors on the same kind of device; the program and the reference read
these same tensors.
"""
from __future__ import annotations

import torch

from portbench.reference.common import Leaf

__all__ = ["make_params"]

_ALIGN = 64  # elements: 128 bytes of bf16


def _round_up(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


def make_params(layout: list[Leaf], seed: int, device, dtype) -> dict:
    """The nested parameter dict of ``layout`` drawn from ``seed``."""
    device = torch.device(device)
    kinds = ("normal", "uniform", "const")
    bad = {leaf.init for leaf in layout} - set(kinds)
    if bad:
        raise ValueError(f"unknown leaf rules {sorted(bad)}")
    offsets, regions, at = {}, {}, 0
    for kind in kinds:
        start = at
        for leaf in layout:
            if leaf.init == kind:
                offsets[leaf.path] = at
                at += _round_up(leaf.numel)
        regions[kind] = (start, at)
    flat = torch.empty(at, dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed & (2**63 - 1))
    lo, hi = regions["normal"]
    if hi > lo:
        flat[lo:hi].normal_(0.0, 1.0, generator=gen)
    lo, hi = regions["uniform"]
    if hi > lo:
        flat[lo:hi].uniform_(0.0, 1.0, generator=gen)
    out: dict = {}
    for leaf in layout:
        off = offsets[leaf.path]
        t = flat[off:off + leaf.numel].view(leaf.shape)
        if leaf.init == "normal":
            t.mul_(leaf.a)
        elif leaf.init == "uniform":
            t.mul_(leaf.b - leaf.a).add_(leaf.a)
        else:
            t.fill_(leaf.a)
        node = out
        for key in leaf.path[:-1]:
            node = node.setdefault(key, {})
        node[leaf.path[-1]] = t
    return out
