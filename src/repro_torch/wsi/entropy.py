"""Whole-level JPEG entropy decode on the device: one CTA per tile.

The counterpart of ``repro.wsi.entropy_jax``. The reference compiles the
numpy lockstep automaton (all tiles of a level advance one symbol per step)
into one ``lax.while_loop``; here every tile's scan is decoded by one CTA
of the ``entropy_decode`` kernel, with no lockstep across tiles: its
threads split the scan into subsequences, synchronise them by Huffman
self-synchronisation, and each writes the 8×8 blocks whose DC symbol lies
in its subsequence. ``decode_scans`` packs the unstuffed scans with guard
bytes, launches the kernel (its plain version on the CPU) and replays the
errors.

Contract with the numpy engine (``jpeg._entropy_decode_batch``, the
differential oracle):

* coefficient-exact equality on every decodable stream;
* identical ``ValueError("corrupt JPEG …")`` strings on any batch. The
  lockstep raises at the first step at which any tile fails, with priority
  invalid Huffman code > AC run past the block > truncation; step s is each
  live tile's s-th symbol. Each kernel lane records the index and kind of
  its own first failure, so the host takes the minimum index over lanes
  and the highest-priority kind among the lanes that failed there.

The scan buffer is indexed with an int64 base offset per tile and an int32
bit cursor relative to it, so unlike the reference (int32 cursors over the
whole buffer, batches capped at 2^27 bytes) no batch is too large.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from repro_torch.kernels import entropy_decode
from repro_torch.kernels.ref import ERR_INVALID, ERR_RUN, ERR_TRUNC

__all__ = ["decode_scans", "pack_scans"]

#: zero bytes after each scan: one symbol can carry a corrupt tile's cursor
#: ≤ 27 bits past its end before the truncation check stops it, and the
#: numpy engine's 64-bit window reads ≤ 8 bytes ahead of a cursor inside
#: the scan (the kernel's bit buffer loads whole 4-byte words a few bytes
#: further, never past buf's end, and decodes none of those bits)
_GUARD = 8

_MESSAGES = {
    ERR_INVALID: "corrupt JPEG stream: invalid Huffman code",
    ERR_RUN: "corrupt JPEG stream: AC run past end of block",
    ERR_TRUNC: "corrupt JPEG stream: truncated scan data",
}


@lru_cache(maxsize=None)
def _device_lut(device: torch.device) -> torch.Tensor:
    """The four 16-bit lookahead tables, packed ``symbol | length << 8``."""
    from repro_torch.wsi import jpeg
    packed = jpeg._LUT_SYM.astype(np.int16) | (jpeg._LUT_LEN << 8)
    return torch.from_numpy(packed.reshape(-1).astype(np.int16)).to(device)


def _raise_first_error(stop: np.ndarray, err_kind: np.ndarray) -> None:
    """Raise the error the lockstep engine raises for these lanes, if any."""
    failed = err_kind > 0
    if not failed.any():
        return
    first = stop[failed].min()
    kind = int(err_kind[failed & (stop == first)].min())
    raise ValueError(_MESSAGES[kind])


def pack_scans(scans: list[np.ndarray]):
    """Concatenate N unstuffed scans, each followed by ``_GUARD`` zero bytes.

    Returns ``(buf, offs, nbits)``: the (B,) uint8 buffer, each scan's int64
    byte offset in it and its int32 length in bits — the layout both
    decoders read.
    """
    sizes = np.array([s.size for s in scans], np.int64)
    offs = np.concatenate(([0], np.cumsum(sizes + _GUARD)[:-1])) \
        if scans else np.zeros(0, np.int64)
    buf = np.zeros(int(sizes.sum()) + _GUARD * max(len(scans), 1), np.uint8)
    for o, scan in zip(offs, scans):
        buf[o:o + scan.size] = scan
    return buf, offs.astype(np.int64), (sizes * 8).astype(np.int32)


def decode_scans(scans: list[np.ndarray], H: int, W: int,
                 device: torch.device) -> torch.Tensor:
    """N unstuffed scans of H×W tiles → (N, 3, H, W) int32 coefficients.

    Blocks in place and DC integrated — the layout ``jpeg_inverse`` reads —
    on ``device``, in one ``entropy_decode`` launch. Raises the numpy
    engine's ``ValueError`` on a corrupt batch.
    """
    buf, offs, nbits = (torch.from_numpy(a).to(device)
                        for a in pack_scans(scans))
    coef, stop, err_kind = entropy_decode(buf, offs, nbits,
                                          _device_lut(device), H, W)
    _raise_first_error(stop.cpu().numpy(), err_kind.cpu().numpy())
    return coef
