"""The work of each ported kernel, counted the same whatever implements it.

Each ``*_work`` function returns ``(ops, nbytes)`` for one call at its
shapes: the operations the function needs (float32, outside the tensor
cores) and the bytes it must move, each input read once and each output
written once. :func:`bound_s` turns them into the least time the card
could take; ``chip_smoke.py`` reports every kernel's ``bound_ms`` from
these.

While a counter (:class:`repro_torch.roofline.counters.Counter`) is active
on the calling thread, each ``kernels.ops`` wrapper records its formula
once per call (:func:`kernel_work`) and hides the aten ops of its body
from the counter, so a step counts the same work on the card (the
kernel) and on the CPU or fake tensors (the plain version).
"""
from __future__ import annotations

import contextlib
import threading

from repro_torch.roofline.terms import HW

__all__ = ["jpeg_transform_work", "jpeg_inverse_work", "downsample2x2_work",
           "rgb2ycbcr_work", "dct8x8_quant_work", "entropy_decode_work",
           "wkv_chunk_work", "bound_s", "kernel_work", "active_counter"]


def jpeg_transform_work(shape) -> tuple[float, int]:
    """(N, 3, H, W) float32 RGB → int32 coefficients: 12 B in and 12 B out
    a pixel, ~112 operations a pixel."""
    n = _numel(shape)
    return n // 3 * 112.0, n * 4 * 2


def jpeg_inverse_work(shape) -> tuple[float, int]:
    """(N, 3, H, W) int32 coefficients → uint8 RGB: 12 B in and 3 B out a
    pixel, ~111 operations a pixel."""
    n = _numel(shape)
    return n // 3 * 111.0, n * 4 + n


def downsample2x2_work(shape) -> tuple[float, int]:
    """(C, H, W) float32 → (C, H//2, W//2): every input read, every output
    written, 7 operations an output (four adds, a scale, round, clip)."""
    C, H, W = shape
    n_out = C * (H // 2) * (W // 2)
    return n_out * 7.0, _numel(shape) * 4 + n_out * 4


def rgb2ycbcr_work(shape) -> tuple[float, int]:
    """(3, H, W) float32 → (3, H, W) float32: 16 operations a pixel."""
    n = _numel(shape)
    return n * (16 / 3), n * 8


def dct8x8_quant_work(shape) -> tuple[float, int]:
    """(H, W) float32 plane → int32 coefficients: 32 operations a sample
    (two 8-point passes and the quantiser)."""
    n = _numel(shape)
    return n * 32.0, n * 8


def entropy_decode_work(n_tiles: int, H: int, W: int, scan_bytes: int,
                        lut_entries: int) -> tuple[float, int]:
    """Huffman decode of ``n_tiles`` scans: the int32 coefficients written,
    the scan bytes and the lookup table read, per tile its offset, bit
    count, stop and error kind; the operations are not counted (integer
    table walks)."""
    return 0.0, (n_tiles * 3 * H * W * 4 + scan_bytes
                 + n_tiles * (8 + 4 + 4 + 4) + lut_entries * 2)


def wkv_chunk_work(B: int, S: int, H: int, K: int) -> tuple[float, int]:
    """RWKV6's wkv at (B, S, H, K). Bytes: r, k, v, logw read and out
    written once, u, the state in and out; operations: the least the
    recurrence needs per token and head, 5 K² + 6 K: r·S (K² multiply-adds),
    S ← w S + kᵀv (K² multiplies, K² multiply-adds), the u bonus (r u k
    summed, times v added to the output: 5 K) and exp(logw) (K)."""
    nbytes = 4 * (5 * B * S * H * K + H * K + 2 * B * H * K * K)
    return B * S * H * (5.0 * K * K + 6.0 * K), nbytes


def bound_s(ops: float, nbytes: float, hw: HW = HW()) -> tuple[float, str]:
    """The least time for ``ops`` float32 operations and ``nbytes`` bytes:
    the larger of bytes over the memory rate and operations over the
    float32 rate, and which of the two it is."""
    t_bytes = nbytes / hw.hbm_bw
    t_ops = ops / hw.peak_f32_flops
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _numel(shape) -> int:
    n = 1
    for d in shape:
        n *= int(d)
    return n


_STATE = threading.local()


def active_counter():
    """The innermost counter active on this thread, or None."""
    stack = getattr(_STATE, "stack", None)
    return stack[-1] if stack else None


def _push(counter) -> None:
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    _STATE.stack.append(counter)


def _pop(counter) -> None:
    if _STATE.stack.pop() is not counter:
        raise RuntimeError("counters must exit in the order they entered")


@contextlib.contextmanager
def kernel_work(name: str, work: tuple[float, int]):
    """Around a kernel wrapper's body: with a counter active, record
    ``work`` (``(ops, nbytes)``) once under ``name`` and count none of the
    body's aten ops; otherwise nothing."""
    counter = active_counter()
    if counter is None:
        yield
        return
    counter.record_kernel(name, *work)
    with counter.hidden():
        yield
