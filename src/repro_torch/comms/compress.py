"""Error-feedback int8 gradient compression, a copy of
``repro.comms.compress``.

At 1000+ node scale the inter-pod (slow-link) all-reduce of fp32/bf16
gradients dominates step time; quantizing the reduced payload to int8 with
a per-tensor scale cuts that traffic 4× (vs fp32). Plain quantization
biases the update, so the quantization residual is carried forward (error
feedback, as in 1-bit Adam / EF-SGD): the compressed gradient stream
converges to the true one.

Inside one process the all-reduce is implicit, so the quantize→dequantize
pair models exactly the payload that would cross the slow link;
:func:`compressed_psum` is the explicit form over a ``torch.distributed``
process group. ``torch.round`` rounds half to even, as ``jnp.round`` does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.models.params import tree_map

__all__ = [
    "int8_quantize",
    "int8_dequantize",
    "ef_init",
    "ef_compress",
    "compressed_psum",
]


def int8_quantize(x: torch.Tensor):
    """Per-tensor symmetric int8. Returns (q, scale), scale a 0-d float32.
    (The largest magnitude is the infinity norm, which is exact and needs
    no temporary; one float32 temporary holds ``x / scale`` while it is
    rounded and clipped in place.)"""
    x = x.float()
    amax = torch.linalg.vector_norm(x, float("inf"))
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.div(x, scale).round_().clamp_(-127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float().mul_(scale)


def ef_init(params):
    """Zero error-feedback residual tree (float32)."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def ef_compress(grads, ef):
    """Quantize (grads + residual); return (dequantized grads, new residual).

    The residual is written into ``ef``'s leaves in place and ``ef`` is
    returned (a second residual tree would be 12.4 GB at ``rwkv6-3b``)."""

    def one(g, e):
        tot = g.float() + e
        q, s = int8_quantize(tot)
        deq = int8_dequantize(q, s)
        e.copy_(tot.sub_(deq))
        return deq.to(g.dtype)

    return tree_map(one, grads, ef), ef


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-payload sum of ``x`` across ``group`` (every rank calls it).

    Each participant quantizes its tensor; the largest scale is shared
    (``all_reduce(MAX)``), each rank requantizes against it so that the
    integer sum is meaningful, the int32 payloads are summed exactly
    (``all_reduce(SUM)``) and dequantized with the shared scale."""
    _, s = int8_quantize(x)
    s_max = s.clone()
    dist.all_reduce(s_max, op=dist.ReduceOp.MAX, group=group)
    q = torch.clamp(torch.round(x.float() / s_max), -127, 127)
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.float() * s_max
