"""The yardstick: the chip's peaks and the work the models need.

Everything is counted from the published shapes, never from what an
implementation does: a kernel that computes more reads lower against it,
and one that computes less than the work needs cannot read above 100 %.

- ``PEAK``: one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates).
- :func:`wkv_work`: RWKV6's wkv recurrence, frozen from the program's
  ``roofline/work.py::wkv_chunk_work`` (float32 operations).
- :func:`attention_work`: causal attention of a prompt, its QKᵀ and PV
  products over the pairs a causal mask keeps, its bytes at the
  configuration's dtype (``DTYPE_BYTES``), whatever dtype an
  implementation computes in.
- :func:`prefill_flops` / :func:`decode_flops`: the model FLOPs the
  tokens need, summed from each family's ``token_flops`` (beside its
  reference, ``reference/<family>.py``: 2 per weight a token multiplies
  and the work at its context), with the head only where the logits are
  used (a prefill's last position, every decoded token).
"""
from __future__ import annotations

import numpy as np

__all__ = ["PEAK", "DTYPE_BYTES", "bound_s", "wkv_work", "attention_work",
           "head_flops", "prefill_flops", "decode_flops"]

PEAK = {
    "bf16_flops": 989e12,
    "f32_flops": 67e12,  # outside the tensor cores
    "hbm_bytes_s": 3.35e12,
}

#: bytes of an element of each dtype a configuration may state
DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def bound_s(flops: float, nbytes: float, flops_peak: float) -> float:
    """The least time: the larger of the operations at ``flops_peak`` and
    the bytes at the memory rate."""
    return max(flops / flops_peak, nbytes / PEAK["hbm_bytes_s"])


def wkv_work(B: int, S: int, H: int, K: int) -> tuple[float, float]:
    """(float32 operations, bytes) of one wkv call at (B, S, H, K): per
    token and head 5 K² + 6 K operations (r·S, the state's decay and
    increment, the bonus, exp(logw)); r, k, v, logw read and the output
    written once, u, the state in and out."""
    nbytes = 4 * (5 * B * S * H * K + H * K + 2 * B * H * K * K)
    return B * S * H * (5.0 * K * K + 6.0 * K), float(nbytes)


def attention_work(B: int, S: int, H: int, KV: int, D: int,
                   elem: int) -> tuple[float, float]:
    """(operations, bytes) of causal self-attention over S positions:
    4·D operations per head and (query, key) pair the mask keeps, S(S+1)/2
    pairs; q, k, v read and the output written once at ``elem`` bytes
    an element (the configuration's dtype)."""
    pairs = S * (S + 1) / 2
    flops = 4.0 * D * H * B * pairs
    nbytes = elem * B * S * D * (2 * H + 2 * KV)
    return flops, float(nbytes)


def head_flops(m: dict) -> float:
    return 2.0 * m["vocab_size"] * m["d_model"]


def _summed(ref, m: dict, ctx: np.ndarray) -> float:
    """``ref.token_flops`` over every context in ``ctx``."""
    per = np.broadcast_to(ref.token_flops(m, ctx), ctx.shape)
    return float(np.sum(per, dtype=np.float64))


def prefill_flops(ref, m: dict, S: int) -> float:
    """A prompt of S tokens through family ``ref`` (its ``token_flops``):
    position i at context i + 1, the head at the last."""
    return _summed(ref, m, np.arange(1, S + 1)) + head_flops(m)


def decode_flops(ref, m: dict, ctx) -> float:
    """Decoded tokens at the contexts ``ctx``, each with the head."""
    ctx = np.asarray(ctx, dtype=np.int64)
    return _summed(ref, m, ctx) + ctx.size * head_flops(m)
