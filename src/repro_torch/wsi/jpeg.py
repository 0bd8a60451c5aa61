"""JPEG baseline codec: the port's kernels for the transforms, host numpy
for the bitstream's container and (encode side) its entropy coder.

The codec of ``repro.wsi.jpeg``, copied (the port imports nothing of
``repro``) and moved onto the port's kernels. Produces and consumes real
JFIF bytes (SOI/APP0/DQT/SOF0/DHT/SOS/EOI, standard Annex-K tables, 4:4:4,
byte stuffing), byte-identical to the reference's for equal coefficients.

Two encoder paths, byte-identical to each other:

- ``encode_tiles_batch``: the whole-level path — one ``jpeg_transform``
  launch for every tile of a level, then the numpy-vectorized symbol-stream
  entropy coder (``encode_coef_batch``), whose cost scales with the emitted
  symbols, not the coefficients.
- ``encode_tile``: the per-tile path — one ``rgb2ycbcr`` and three
  ``dct8x8_quant`` launches per tile and the per-coefficient Python Huffman
  loop. Kept as the A/B baseline.

And two decoder paths, pixel-identical to each other:

- ``decode_tiles_batch``: the whole-level path — the JFIF containers are
  parsed and unstuffed on the host, then one ``entropy_decode`` launch
  decodes every tile's scan (one thread per tile, ``wsi/entropy.py``) into
  the coefficient planes on the card, and one ``jpeg_inverse`` launch turns
  them into RGB.
- ``decode_tile``: the per-tile path — the per-symbol Python Huffman loop,
  then ``jpeg_inverse`` on a batch of one.

The numpy lockstep decoder (``_entropy_decode_batch``, ``engine="numpy"``)
stays as the differential oracle of the kernel, as in the reference.
Truncated or garbage input raises ``ValueError("corrupt JPEG …")`` from
every decode entry point, with the reference's strings.

Every public entry point that touches the card takes ``device=`` (default
``"cuda"``; ``"cpu"`` runs the kernels' plain versions; a CUDA device on a
machine without one raises). The only module-level caches are
``lru_cache``s, so the codec is thread-safe.
"""
from __future__ import annotations

import struct
from functools import lru_cache

import numpy as np
import torch

from repro_torch.kernels import (dct8x8_quant, jpeg_inverse, jpeg_transform,
                                 rgb2ycbcr)
from repro_torch.kernels.ref import JPEG_CHROMA_Q, JPEG_LUMA_Q
from repro_torch.kernels.ref import ZIGZAG as _ZIGZAG
from repro_torch.wsi.dicom import TS_EXPLICIT_LE, TS_JPEG_BASELINE
from repro_torch.wsi.entropy import decode_scans, pack_scans

__all__ = ["encode_tile", "encode_tiles_batch", "encode_coef_batch",
           "decode_tile", "decode_tiles_batch", "decode_coef_batch",
           "decode_frames", "psnr", "resolve_device"]


def resolve_device(device: str | torch.device | None) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r}: no CUDA device is available — pass "
            "device='cpu' to run on the CPU")
    return dev


# --------------------------------------------------------------------------
# Annex-K Huffman tables
# --------------------------------------------------------------------------
_DC_L_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]
_DC_L_VALS = list(range(12))
_DC_C_BITS = [0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0]
_DC_C_VALS = list(range(12))
_AC_L_BITS = [0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D]
_AC_L_VALS = [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]
_AC_C_BITS = [0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77]
_AC_C_VALS = [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA,
]


def _build_codes(bits, vals):
    """Canonical Huffman: symbol -> (code, length)."""
    codes = {}
    code = 0
    k = 0
    for ln in range(1, 17):
        for _ in range(bits[ln - 1]):
            codes[vals[k]] = (code, ln)
            code += 1
            k += 1
        code <<= 1
    return codes

_ENC = {
    ("dc", 0): _build_codes(_DC_L_BITS, _DC_L_VALS),
    ("dc", 1): _build_codes(_DC_C_BITS, _DC_C_VALS),
    ("ac", 0): _build_codes(_AC_L_BITS, _AC_L_VALS),
    ("ac", 1): _build_codes(_AC_C_BITS, _AC_C_VALS),
}
_DEC = {
    k: {v: sym for sym, v in table.items()} for k, table in _ENC.items()
}


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def put(self, code: int, length: int):
        self.acc = (self.acc << length) | (code & ((1 << length) - 1))
        self.nbits += length
        while self.nbits >= 8:
            byte = (self.acc >> (self.nbits - 8)) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0x00)  # byte stuffing
            self.nbits -= 8
        self.acc &= (1 << self.nbits) - 1

    def flush(self):
        if self.nbits:
            pad = 8 - self.nbits
            self.put((1 << pad) - 1, pad)
        return bytes(self.out)


class _BitReader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def _fill(self):
        if self.pos >= len(self.data):
            raise ValueError("corrupt JPEG stream: truncated scan data")
        b = self.data[self.pos]
        self.pos += 1
        if b == 0xFF and self.pos < len(self.data) \
                and self.data[self.pos] == 0x00:
            self.pos += 1  # unstuff
        self.acc = (self.acc << 8) | b
        self.nbits += 8

    def get(self, n: int) -> int:
        while self.nbits < n:
            self._fill()
        v = (self.acc >> (self.nbits - n)) & ((1 << n) - 1)
        self.nbits -= n
        self.acc &= (1 << self.nbits) - 1
        return v

    def huff(self, table: dict) -> int:
        code, ln = 0, 0
        while ln < 16:
            code = (code << 1) | self.get(1)
            ln += 1
            sym = table.get((code, ln))
            if sym is not None:
                return sym
        raise ValueError("corrupt JPEG stream: invalid Huffman code")


def _category(v: int) -> int:
    return int(v).bit_length() if v > 0 else int(-v).bit_length()


def _encode_blocks(bw: _BitWriter, planes: list[np.ndarray]):
    """planes: 3 × (H, W) int coefficient planes (blocks in place), 4:4:4."""
    H, W = planes[0].shape
    bh, bwid = H // 8, W // 8
    zz = [
        p.reshape(bh, 8, bwid, 8).transpose(0, 2, 1, 3)
        .reshape(bh, bwid, 64)[:, :, _ZIGZAG]
        for p in planes
    ]
    pred = [0, 0, 0]
    for r in range(bh):
        for c in range(bwid):
            for comp in range(3):
                tid = 0 if comp == 0 else 1
                blk = zz[comp][r, c]
                dc = int(blk[0])
                diff = dc - pred[comp]
                pred[comp] = dc
                s = _category(diff)
                code, ln = _ENC[("dc", tid)][s]
                bw.put(code, ln)
                if s:
                    bw.put(diff if diff >= 0 else diff + (1 << s) - 1, s)
                run = 0
                ac = blk[1:]
                nz = np.nonzero(ac)[0]
                last = nz[-1] if len(nz) else -1
                for i in range(last + 1):
                    v = int(ac[i])
                    if v == 0:
                        run += 1
                        continue
                    while run > 15:
                        code, ln = _ENC[("ac", tid)][0xF0]
                        bw.put(code, ln)
                        run -= 16
                    s = _category(v)
                    code, ln = _ENC[("ac", tid)][(run << 4) | s]
                    bw.put(code, ln)
                    bw.put(v if v >= 0 else v + (1 << s) - 1, s)
                    run = 0
                if last < 62:
                    code, ln = _ENC[("ac", tid)][0x00]  # EOB
                    bw.put(code, ln)


def _decode_blocks(br: _BitReader, H: int, W: int) -> list[np.ndarray]:
    bh, bwid = H // 8, W // 8
    out = [np.zeros((bh, bwid, 64), np.int32) for _ in range(3)]
    pred = [0, 0, 0]
    inv_zz = np.argsort(_ZIGZAG)
    for r in range(bh):
        for c in range(bwid):
            for comp in range(3):
                tid = 0 if comp == 0 else 1
                blk = np.zeros(64, np.int32)
                s = br.huff(_DEC[("dc", tid)])
                diff = 0
                if s:
                    bits = br.get(s)
                    diff = bits if bits >= (1 << (s - 1)) else bits - (1 << s) + 1
                pred[comp] += diff
                blk[0] = pred[comp]
                k = 1
                while k < 64:
                    sym = br.huff(_DEC[("ac", tid)])
                    if sym == 0x00:
                        break
                    run, s = sym >> 4, sym & 0xF
                    if sym == 0xF0:
                        k += 16
                        continue
                    k += run
                    if k > 63:
                        raise ValueError(
                            "corrupt JPEG stream: AC run past end of block")
                    bits = br.get(s)
                    v = bits if bits >= (1 << (s - 1)) else bits - (1 << s) + 1
                    blk[k] = v
                    k += 1
                out[comp][r, c] = blk
    planes = []
    for comp in range(3):
        zz = out[comp][:, :, inv_zz].reshape(bh, bwid, 8, 8)
        planes.append(zz.transpose(0, 2, 1, 3).reshape(H, W))
    return planes

# --------------------------------------------------------------------------
# Vectorized entropy coder (the batched path)
# --------------------------------------------------------------------------
def _code_table_arrays(table: dict, nsym: int):
    codes = np.zeros(nsym, np.uint32)
    lens = np.zeros(nsym, np.int64)
    for sym, (code, ln) in table.items():
        codes[sym] = code
        lens[sym] = ln
    return codes, lens

_DC_ARR = [_code_table_arrays(_ENC[("dc", t)], 12) for t in (0, 1)]
_AC_ARR = [_code_table_arrays(_ENC[("ac", t)], 256) for t in (0, 1)]

# entry-order key: ((block*3 + comp)*65 + slot)*8 + sub — slot is the zigzag
# position (DC=0, AC z∈[1,63], EOB=64); sub orders ZRLs (0..2) before the
# Huffman code (4) before the magnitude bits (5) of the same coefficient.
_SUB_HUFF, _SUB_MAG = 4, 5


def _category_vec(v: np.ndarray) -> np.ndarray:
    """Vectorized bit_length(|v|): frexp's exponent is exact for integers."""
    return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)


def _magnitude_vec(v: np.ndarray, s: np.ndarray) -> np.ndarray:
    """JPEG magnitude bits: v if v ≥ 0 else v + 2^s - 1 (fits in s bits)."""
    return np.where(v >= 0, v, v + (1 << s) - 1).astype(np.uint32)


def _comp_symbols(zz: np.ndarray, comp: int, nb_tile: int):
    """One component's symbol stream: (key, code, length) int64/uint32/int64.

    zz: (n_tiles · nb_tile, 64) zigzagged coefficients — all tiles of a
    level concatenated, blocks in scan (row-major) order within each tile.
    Emits exactly the symbols of the reference's per-coefficient loop
    (``repro.wsi.jpeg._encode_blocks``) for every tile, each tagged with its bitstream-order
    key (global block index keeps tiles contiguous and ordered; the DC
    predictor resets at tile boundaries since each tile is its own scan).
    """
    tid = 0 if comp == 0 else 1
    dc_codes, dc_lens = _DC_ARR[tid]
    ac_codes, ac_lens = _AC_ARR[tid]
    nb = zz.shape[0]
    base = (np.arange(nb, dtype=np.int64) * 3 + comp) * 65  # key / 8, slot 0

    keys, codes, lens = [], [], []

    # DC: differential against the previous block of the same component,
    # predictor reset to 0 on the first block of every tile
    dc = zz[:, 0].astype(np.int64).reshape(-1, nb_tile)
    prev = np.empty_like(dc)
    prev[:, 0] = 0
    prev[:, 1:] = dc[:, :-1]
    diff = (dc - prev).reshape(-1)
    s_dc = _category_vec(diff)
    if (s_dc > 11).any():  # baseline DC table has categories 0..11
        raise ValueError(
            "DC difference out of range for the baseline Huffman table "
            f"(max |diff|={int(np.abs(diff).max())})")
    keys.append(base * 8 + 0)
    codes.append(dc_codes[s_dc])
    lens.append(dc_lens[s_dc])
    has_mag = s_dc > 0
    keys.append(base[has_mag] * 8 + 1)
    codes.append(_magnitude_vec(diff[has_mag], s_dc[has_mag]))
    lens.append(s_dc[has_mag])

    # AC: run-length between nonzeros within each block
    ac = zz[:, 1:]
    bi, pz = np.nonzero(ac)  # ordered: block-major, position-minor
    vals = ac[bi, pz].astype(np.int64)
    first = np.ones(bi.size, bool)
    first[1:] = bi[1:] != bi[:-1]
    prevpos = np.concatenate(([0], pz[:-1]))
    run = np.where(first, pz, pz - prevpos - 1).astype(np.int64)
    nzrl, rem = run >> 4, run & 15
    slot_key = ((bi * 3 + comp) * 65 + (pz + 1)) * 8

    # ZRL (0xF0) emitted ⌊run/16⌋ times just before the coefficient's symbol
    if nzrl.any():
        rep = np.repeat(np.arange(bi.size), nzrl)
        j = np.arange(rep.size) - np.repeat(np.cumsum(nzrl) - nzrl, nzrl)
        keys.append(slot_key[rep] + j)
        codes.append(np.full(rep.size, ac_codes[0xF0], np.uint32))
        lens.append(np.full(rep.size, ac_lens[0xF0], np.int64))

    s_ac = _category_vec(vals)
    if (s_ac > 10).any():  # baseline AC table has categories 1..10; a
        # larger category would alias into the run nibble of sym below
        raise ValueError(
            "AC coefficient magnitude out of range for the baseline "
            f"Huffman table (max |v|={int(np.abs(vals).max())})")
    sym = (rem << 4) | s_ac
    ac_l = ac_lens[sym]
    keys.append(slot_key + _SUB_HUFF)
    codes.append(ac_codes[sym])
    lens.append(ac_l)
    keys.append(slot_key + _SUB_MAG)
    codes.append(_magnitude_vec(vals, s_ac))
    lens.append(s_ac)

    # EOB for every block whose last nonzero AC sits before position 62
    lastpos = np.full(nb, -1, np.int64)
    lastpos[bi] = pz  # later (= larger pz) assignments win
    eob = lastpos < 62
    keys.append((base[eob] + 64) * 8)
    codes.append(np.full(int(eob.sum()), ac_codes[0x00], np.uint32))
    lens.append(np.full(int(eob.sum()), ac_lens[0x00], np.int64))

    return (np.concatenate(keys), np.concatenate(codes).astype(np.uint32),
            np.concatenate(lens))


@lru_cache(maxsize=None)
def _zigzag_gather_index(H: int, W: int) -> np.ndarray:
    """Flat (H·W,) index map: plane → row-major 8×8 blocks in zigzag order.

    Cached per tile geometry; callers only read it.
    """
    idx = np.arange(H * W).reshape(H // 8, 8, W // 8, 8)
    idx = idx.transpose(0, 2, 1, 3).reshape(-1, 64)[:, _ZIGZAG]
    return np.ascontiguousarray(idx.reshape(-1))



def _stuff(packed: np.ndarray) -> bytes:
    """0xFF byte stuffing over one tile's packed scan bytes."""
    ff = packed == 0xFF
    if ff.any():
        out = np.zeros(packed.size + int(ff.sum()), np.uint8)
        out[np.arange(packed.size) + (np.cumsum(ff) - ff)] = packed
        packed = out  # gaps after each 0xFF stay 0x00 (stuffing)
    return packed.tobytes()


def _pack_bits_tiled(codes: np.ndarray, lens: np.ndarray,
                     tile_ids: np.ndarray, n_tiles: int) -> list[bytes]:
    """MSB-first bit-pack of all tiles' symbol streams in one pass.

    Symbols are sorted, so each tile's run is contiguous. Every tile's
    stream is flush-padded with 1-bits to a byte boundary (as the
    reference's bit writer flushes) inside one flat bit array, packed with a
    single ``np.packbits``, then split per tile and 0xFF-stuffed.
    """
    totals = np.bincount(tile_ids, weights=lens,
                         minlength=n_tiles).astype(np.int64)
    pads = (-totals) % 8
    padded = totals + pads
    tile_start = np.cumsum(padded) - padded  # bit offset of each tile

    cum = np.cumsum(lens) - lens  # global unpadded bit offsets
    first = np.searchsorted(tile_ids, np.arange(n_tiles))
    offs = tile_start[tile_ids] + (cum - cum[first][tile_ids])

    # scatter each symbol into its ≤3 bytes: align the ≤16-bit code inside
    # a 24-bit window starting at its byte, split into byte lanes, and sum
    # per byte with bincount — bits are disjoint, so the sum is the OR
    byte_pos = offs >> 3
    shifted = (codes.astype(np.int64)
               << (24 - (offs & 7) - lens)).astype(np.uint32)
    n_bytes = int(padded.sum()) >> 3
    pos = np.concatenate([byte_pos, byte_pos + 1, byte_pos + 2])
    val = np.concatenate([(shifted >> 16) & 0xFF, (shifted >> 8) & 0xFF,
                          shifted & 0xFF])
    packed = np.bincount(pos, weights=val,
                         minlength=n_bytes)[:n_bytes].astype(np.uint8)

    byte_start = tile_start >> 3
    byte_end = (tile_start + padded) >> 3
    # flush: each tile's trailing pad bits are 1s (as the reference's bit writer)
    packed[byte_end - 1] |= ((1 << pads) - 1).astype(np.uint8)
    return [_stuff(packed[byte_start[t]:byte_end[t]])
            for t in range(n_tiles)]


def _entropy_encode_batch(coef: np.ndarray) -> list[bytes]:
    """Vectorized per-coefficient Huffman coding of a whole level at once.

    coef: (N, 3, H, W) int coefficient planes (blocks in place, 4:4:4) →
    N entropy-coded scan byte strings, each byte-identical to the
    reference's per-coefficient loop output for that tile.
    """
    N, _, H, W = coef.shape
    bh, bwid = H // 8, W // 8
    nb_tile = bh * bwid
    zz_idx = _zigzag_gather_index(H, W)
    flat = coef.reshape(N, 3, H * W)
    parts = []
    for comp in range(3):
        # one gather: (H, W) plane → (nb, 64) blocks already in zigzag order
        zz = flat[:, comp].take(zz_idx, axis=1).reshape(N * nb_tile, 64)
        parts.append(_comp_symbols(zz, comp, nb_tile))
    keys = np.concatenate([p[0] for p in parts])
    codes = np.concatenate([p[1] for p in parts])
    lens = np.concatenate([p[2] for p in parts])
    order = np.argsort(keys)  # keys are unique → scan order, tiles grouped
    tile_ids = (keys[order] // (8 * 65 * 3)) // nb_tile
    return _pack_bits_tiled(codes[order], lens[order], tile_ids, N)


# --------------------------------------------------------------------------
# Vectorized entropy decoder: the numpy oracle, and the kernel's tables
# --------------------------------------------------------------------------
# 16-bit-lookahead Huffman tables: LUT[peek] = (symbol, code length). Codes
# are ≤ 16 bits, so every 16-bit window starting at a code boundary resolves
# the symbol in one gather; windows matching no code have length 0 (corrupt).
def _huff_lut(table: dict) -> tuple[np.ndarray, np.ndarray]:
    sym = np.zeros(1 << 16, np.int16)
    ln = np.zeros(1 << 16, np.int16)
    for s, (code, length) in table.items():
        lo = code << (16 - length)
        sym[lo:lo + (1 << (16 - length))] = s
        ln[lo:lo + (1 << (16 - length))] = length
    return sym, ln

# stacked [dc-luma, dc-chroma, ac-luma, ac-chroma]: a decoder lane selects
# a row from its (DC/AC phase, component) state
_LUTS = [_huff_lut(_ENC[(kind, tid)])
         for kind in ("dc", "ac") for tid in (0, 1)]
_LUT_SYM = np.stack([s for s, _ in _LUTS])
_LUT_LEN = np.stack([ln for _, ln in _LUTS])
del _LUTS

# magnitude decode, tabulated per category s: value = bits if bits ≥ 2^(s-1)
# else bits - (2^s - 1)   (s = 0 ⇒ no bits, value 0)
_MAG_MASK = np.array([(1 << s) - 1 for s in range(16)], np.uint64)
_MAG_HALF = np.array([1 << max(s - 1, 0) for s in range(16)], np.int64)
_MAG_EXT = np.array([(1 << s) - 1 for s in range(16)], np.int64)

def _unstuff(scan: np.ndarray) -> np.ndarray:
    """Drop the stuffed 0x00 after every 0xFF (vectorized per tile)."""
    if scan.size < 2:
        return scan
    stuffed = (scan[:-1] == 0xFF) & (scan[1:] == 0x00)
    if not stuffed.any():
        return scan
    keep = np.ones(scan.size, bool)
    keep[1:][stuffed] = False
    return scan[keep]


def _window64(buf: np.ndarray) -> np.ndarray:
    """``w[p]`` = bytes ``p..p+7`` of ``buf`` as one big-endian uint64.

    Built once per batch with 8 vectorized passes, so the lockstep loop
    reads each tile's next 57+ lookahead bits with a *single* gather: a
    Huffman code (≤ 16 bits) plus its magnitude bits (≤ 11) plus the ≤ 7
    sub-byte phase is ≤ 34 bits, comfortably inside the window.
    """
    pad = np.concatenate([buf, np.zeros(8, np.uint8)])
    w = np.zeros(buf.size, np.uint64)
    for i in range(8):
        w |= pad[i:i + buf.size].astype(np.uint64) << np.uint64(56 - 8 * i)
    return w


def _entropy_decode_batch(scans: list[np.ndarray], H: int,
                          W: int) -> np.ndarray:
    """Lockstep twin of ``_decode_blocks`` over N independent scans (numpy).

    The differential oracle of the ``entropy_decode`` kernel, as in the
    reference: all N tiles advance one symbol per vectorized step, and the
    first step at which any tile fails raises, invalid Huffman code before
    AC overrun before truncation. DC slots hold differentials during the
    loop and are integrated with one cumsum at the end. Returns
    (N, nb, 3, 64) int32 zigzag coefficients, exactly the symbols the
    per-tile loop decodes.
    """
    N = len(scans)
    nb = (H // 8) * (W // 8)
    nu = nb * 3  # block-component units per tile, in bitstream order

    buf, offs, nbits = pack_scans(scans)
    ends = offs * 8 + nbits  # exclusive bit end of each tile's stream
    w64 = _window64(buf)

    pos = offs * 8
    u = np.zeros(N, np.int64)  # unit index: block * 3 + component
    k = np.zeros(N, np.int64)  # next zigzag slot; 0 ⇒ the DC symbol is next
    zzf = np.zeros(N * nu * 64, np.int32)  # flat (tile, block, comp, slot)
    base = np.arange(N, dtype=np.int64) * (nu * 64)
    active = u < nu
    chroma = (np.arange(nu + 1) % 3 > 0).astype(np.int64)  # unit → table
    _c48, _c64 = np.uint64(48), np.uint64(64)
    _m16 = np.uint64(0xFFFF)

    while active.any():
        w = w64[pos >> 3]
        sh = (pos & 7).astype(np.uint64)
        code = ((w >> (_c48 - sh)) & _m16).astype(np.int64)
        is_dc = k == 0
        tbl = np.where(is_dc, 0, 2) + chroma[u]
        sym = _LUT_SYM[tbl, code]
        ln = _LUT_LEN[tbl, code]
        # EOB (0x00) and ZRL (0xF0) have zero magnitude bits by construction
        s = np.where(is_dc, sym, sym & 0xF)
        su = s.astype(np.uint64)
        bits = ((w >> (_c64 - sh - ln.astype(np.uint64) - su))
                & _MAG_MASK[s]).astype(np.int64)
        v = np.where(bits >= _MAG_HALF[s], bits, bits - _MAG_EXT[s])
        pos = np.where(active, pos + ln + s, pos)

        is_eob = ~is_dc & (sym == 0x00)
        is_zrl = ~is_dc & (sym == 0xF0)
        is_coef = ~(is_dc | is_eob | is_zrl)
        # sym >> 4 is 0 for every valid DC category and for EOB; ZRL's
        # junk value is never read (its k-update uses k + 16 directly)
        knew = k + (sym >> 4)
        bad = active & ((ln == 0) | (is_coef & (knew > 63)))
        if bad.any():
            if (active & (ln == 0)).any():
                raise ValueError("corrupt JPEG stream: invalid Huffman code")
            raise ValueError("corrupt JPEG stream: AC run past end of block")

        # one scatter: the DC differential at slot 0, AC values at slot knew
        rows = np.flatnonzero(active & (is_dc | is_coef))
        zzf[base[rows] + u[rows] * 64
            + np.where(is_dc, 0, knew)[rows]] = v[rows]

        # next slot: DC → 1; ZRL skips 16; a written value advances past
        # itself; EOB leaves k to be reset below. A run past slot 63 ends
        # the unit, as in the per-tile loop's `while k < 64` recheck.
        k = np.where(is_dc, 1,
                     np.where(is_zrl, k + 16,
                              np.where(is_coef, knew + 1, k)))
        adv = active & (is_eob | (k >= 64))  # k ≥ 64 implies an AC phase
        u = u + adv
        k = np.where(adv, 0, k)
        active = u < nu
        if (active & (pos > ends)).any():
            raise ValueError("corrupt JPEG stream: truncated scan data")

    zz = zzf.reshape(N, nb, 3, 64)
    # integrate the DC differentials (predictor resets at tile boundaries)
    zz[:, :, :, 0] = np.cumsum(zz[:, :, :, 0], axis=1)
    return zz


def _parse_jfif(jpg: bytes) -> tuple[int, int, int, int]:
    """Parse one tile's JFIF container → (H, W, scan start, scan end).

    Accepts what ``encode_tile``/``encode_coef_batch`` emit (baseline,
    4:4:4, standard tables), plus DICOM's even-length convention of one
    trailing 0x00 pad byte after the EOI marker (encapsulated fragments).
    Truncated or malformed containers raise ``ValueError("corrupt JPEG
    …")`` — never ``IndexError``/``struct.error``.
    """
    if len(jpg) < 4 or jpg[:2] != b"\xff\xd8":
        raise ValueError("corrupt JPEG stream: missing SOI marker")
    end = len(jpg)
    if jpg[end - 1] == 0x00 and jpg[end - 3:end - 1] == b"\xff\xd9":
        end -= 1  # DICOM even-length fragment pad
    if jpg[end - 2:end] != b"\xff\xd9":
        raise ValueError("corrupt JPEG stream: missing EOI marker")
    pos = 0
    H = W = None
    while pos + 2 <= end:
        if jpg[pos] != 0xFF:
            raise ValueError(
                f"corrupt JPEG stream: expected a marker at offset {pos}")
        code = jpg[pos + 1]
        pos += 2
        if code in (0xD8, 0xD9):
            continue
        if pos + 2 > end:
            raise ValueError("corrupt JPEG stream: truncated marker segment")
        ln = struct.unpack_from(">H", jpg, pos)[0]
        if ln < 2 or pos + ln > end:
            raise ValueError(
                "corrupt JPEG stream: marker segment overruns container")
        if code == 0xC0:
            if ln < 9:
                raise ValueError("corrupt JPEG stream: short SOF segment")
            _, H, W, _ = struct.unpack_from(">BHHB", jpg, pos + 2)
            if not H or not W or H % 8 or W % 8:
                raise ValueError(
                    f"corrupt JPEG stream: unsupported frame size {H}x{W}")
        if code == 0xDA:
            if H is None:
                raise ValueError("corrupt JPEG stream: SOS before SOF")
            start = pos + ln
            if start > end - 2:
                raise ValueError("corrupt JPEG stream: no scan data")
            return H, W, start, end - 2
        pos += ln
    raise ValueError("corrupt JPEG stream: no SOS marker")


def _scans(jpgs: list[bytes]) -> tuple[list[np.ndarray], int, int]:
    """Parse N JFIF tiles of one geometry → (unstuffed scans, H, W)."""
    geom = [_parse_jfif(j) for j in jpgs]
    H, W = geom[0][:2]
    if any((h, w) != (H, W) for h, w, _, _ in geom):
        raise ValueError(
            "corrupt JPEG stream: mixed tile geometries in one batch "
            f"({sorted({(h, w) for h, w, _, _ in geom})})")
    scans = [_unstuff(np.frombuffer(jpg, np.uint8, end - start, start))
             for jpg, (_, _, start, end) in zip(jpgs, geom)]
    return scans, H, W


def decode_coef_batch(jpgs: list[bytes], *, device="cuda",
                      engine: str = "kernel") -> torch.Tensor:
    """N baseline JFIF tiles → (N, 3, H, W) int32 quantized coefficients.

    The entropy stage of the batched decode path, on ``device`` — the exact
    inverse of ``encode_coef_batch`` (only the transform stage is lossy).
    ``engine="kernel"`` (default) is one ``entropy_decode`` launch (its
    plain version on the CPU); ``engine="numpy"`` is the host lockstep
    oracle. All tiles of a batch must share one geometry, as a pyramid
    level's frames do. Raises ``ValueError("corrupt JPEG …")`` on
    truncated/garbage input, with the reference's strings.
    """
    dev = resolve_device(device)
    if engine not in ("kernel", "numpy"):
        raise ValueError(f"engine must be 'kernel' or 'numpy': {engine!r}")
    jpgs = list(jpgs)
    if not jpgs:
        return torch.zeros((0, 3, 0, 0), dtype=torch.int32, device=dev)
    scans, H, W = _scans(jpgs)
    if engine == "kernel":
        return decode_scans(scans, H, W, dev)
    zz = _entropy_decode_batch(scans, H, W)  # (N, nb, 3, 64)
    N, nb = zz.shape[:2]
    out = np.empty((N, 3, H * W), np.int32)
    # scatter back through the encoder's zigzag gather index (its inverse)
    out[:, :, _zigzag_gather_index(H, W)] = \
        zz.transpose(0, 2, 1, 3).reshape(N, 3, nb * 64)
    return torch.from_numpy(out.reshape(N, 3, H, W)).to(dev)


def _rgb_to_host(rgb: torch.Tensor) -> np.ndarray:
    """(N, 3, H, W) uint8 on any device → (N, H, W, 3) host array."""
    return rgb.permute(0, 2, 3, 1).contiguous().cpu().numpy()


def decode_tiles_batch(jpgs: list[bytes], *, device="cuda") -> np.ndarray:
    """N baseline JFIF tiles → (N, H, W, 3) uint8 RGB.

    The whole-level batched decode path: one ``entropy_decode`` launch
    (``decode_coef_batch``), then one ``jpeg_inverse`` launch, both on
    ``device``. Output is pixel-identical to ``[decode_tile(j) for j in
    jpgs]``: both paths share the one ``jpeg_inverse`` transform, so
    identity reduces to the (exact, integer) coefficients matching.
    """
    coef = decode_coef_batch(jpgs, device=device)
    if coef.shape[0] == 0:
        return np.zeros((0, 0, 0, 3), np.uint8)
    return _rgb_to_host(jpeg_inverse(coef))


def decode_frames(frames: list[bytes], *, transfer_syntax: str,
                  rows: int, cols: int, device="cuda") -> np.ndarray:
    """WADO frame bytes of one WSM instance → (n, rows, cols, 3) uint8 RGB.

    The single transfer-syntax dispatch of every store consumer (the
    export service, the ML-inference subscriber): JPEG-baseline frames go
    through the batched decode path (one ``entropy_decode`` and one
    ``jpeg_inverse`` launch), a single frame included; native
    explicit-VR-LE frames are reshaped directly. Geometry mismatches and
    unknown syntaxes raise ``ValueError``.
    """
    dev = resolve_device(device)
    frames = list(frames)
    if rows <= 0 or cols <= 0:
        raise ValueError(f"bad frame geometry {rows}x{cols}")
    if not frames:
        return np.zeros((0, rows, cols, 3), np.uint8)
    if transfer_syntax == TS_JPEG_BASELINE:
        rgb = decode_tiles_batch(frames, device=dev)
        if rgb.shape[1:3] != (rows, cols):
            raise ValueError(
                f"frames decode to {rgb.shape[1]}x{rgb.shape[2]}, "
                f"expected {rows}x{cols}")
        return rgb
    if transfer_syntax == TS_EXPLICIT_LE:
        if any(len(f) != rows * cols * 3 for f in frames):
            raise ValueError(
                f"native frame size mismatch (expected {rows * cols * 3} "
                "bytes)")
        return np.stack([np.frombuffer(f, np.uint8).reshape(rows, cols, 3)
                         for f in frames])
    raise ValueError(
        f"unsupported transfer syntax {transfer_syntax} (JPEG baseline "
        "and explicit-VR-LE native are decodable)")


# --------------------------------------------------------------------------
# JFIF container
# --------------------------------------------------------------------------
def _marker(buf: bytearray, code: int, payload: bytes = b""):
    buf += struct.pack(">BB", 0xFF, code)
    if payload:
        buf += struct.pack(">H", len(payload) + 2) + payload


def _dqt_payload(tid: int, table: np.ndarray) -> bytes:
    return bytes([tid]) + bytes(
        int(v) for v in table.reshape(64)[_ZIGZAG]
    )


def _dht_payload(cls: int, tid: int, bits, vals) -> bytes:
    return bytes([cls << 4 | tid]) + bytes(bits) + bytes(vals)


def _jfif_header(H: int, W: int) -> bytearray:
    """SOI…SOS for a 4:4:4 baseline scan with the standard Annex-K tables."""
    buf = bytearray()
    _marker(buf, 0xD8)  # SOI
    _marker(buf, 0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    _marker(buf, 0xDB, _dqt_payload(0, JPEG_LUMA_Q))
    _marker(buf, 0xDB, _dqt_payload(1, JPEG_CHROMA_Q))
    sof = struct.pack(">BHHB", 8, H, W, 3)
    for cid, tq in ((1, 0), (2, 1), (3, 1)):
        sof += bytes([cid, 0x11, tq])  # h=v=1 (4:4:4)
    _marker(buf, 0xC0, sof)
    _marker(buf, 0xC4, _dht_payload(0, 0, _DC_L_BITS, _DC_L_VALS))
    _marker(buf, 0xC4, _dht_payload(1, 0, _AC_L_BITS, _AC_L_VALS))
    _marker(buf, 0xC4, _dht_payload(0, 1, _DC_C_BITS, _DC_C_VALS))
    _marker(buf, 0xC4, _dht_payload(1, 1, _AC_C_BITS, _AC_C_VALS))
    sos = bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    _marker(buf, 0xDA, sos)
    return buf


def encode_tile(tile_rgb: np.ndarray, *, device="cuda") -> bytes:
    """RGB (H, W, 3) uint8 → baseline JFIF bytes (4:4:4).

    The per-tile path: one ``rgb2ycbcr`` and three ``dct8x8_quant``
    launches on ``device``, then the per-coefficient Python Huffman loop.
    Kept as the A/B baseline for ``encode_tiles_batch`` (byte-identical
    output).
    """
    dev = resolve_device(device)
    H, W, _ = tile_rgb.shape
    if H % 8 or W % 8:
        raise ValueError(f"tile {H}x{W} is not a multiple of 8")
    chw = torch.from_numpy(np.ascontiguousarray(
        np.transpose(tile_rgb, (2, 0, 1)), np.float32)).to(dev)
    ycc = rgb2ycbcr(chw)  # level-shifted
    qs = (JPEG_LUMA_Q, JPEG_CHROMA_Q, JPEG_CHROMA_Q)
    planes = torch.stack([dct8x8_quant(ycc[i], qs[i])
                          for i in range(3)]).cpu().numpy()

    buf = _jfif_header(H, W)
    bw = _BitWriter()
    _encode_blocks(bw, list(planes))
    buf += bw.flush()
    _marker(buf, 0xD9)  # EOI
    return bytes(buf)


def encode_coef_batch(coef: np.ndarray) -> list[bytes]:
    """(N, 3, H, W) int quantized YCbCr DCT coefficients → N JFIF tiles.

    The host entropy stage of the batched path: vectorized symbol-stream
    encoding (scales with emitted symbols, not coefficients).
    """
    coef = np.asarray(coef)
    N, _, H, W = coef.shape
    if N == 0:
        return []
    header = bytes(_jfif_header(H, W))
    eoi = bytes((0xFF, 0xD9))
    return [header + scan + eoi for scan in _entropy_encode_batch(coef)]


def encode_tiles_batch(tiles_rgb: np.ndarray, *,
                       device="cuda") -> list[bytes]:
    """RGB (N, H, W, 3) uint8 → N baseline JFIF byte strings (4:4:4).

    The whole-level batched path: all N tiles transform-coded in one
    ``jpeg_transform`` launch on ``device``, then the vectorized entropy
    coder. Output is byte-identical to ``[encode_tile(t) for t in
    tiles_rgb]``.
    """
    dev = resolve_device(device)
    tiles = np.asarray(tiles_rgb)
    N, H, W, _ = tiles.shape
    if H % 8 or W % 8:
        raise ValueError(f"tiles {H}x{W} are not a multiple of 8")
    chw = torch.from_numpy(np.ascontiguousarray(
        np.transpose(tiles, (0, 3, 1, 2)), np.float32)).to(dev)
    return encode_coef_batch(jpeg_transform(chw).cpu().numpy())


def decode_tile(jpg: bytes, *, device="cuda") -> np.ndarray:
    """Baseline JFIF (as produced by ``encode_tile``) → RGB (H, W, 3) uint8.

    The per-tile decode path: the per-symbol Python Huffman loop, then the
    shared ``jpeg_inverse`` kernel on a batch of one on ``device`` — the A/B
    baseline for ``decode_tiles_batch`` (pixel-identical output).
    Truncated/garbage input raises ``ValueError("corrupt JPEG …")``.
    """
    dev = resolve_device(device)
    H, W, data_start, data_end = _parse_jfif(jpg)
    br = _BitReader(jpg[data_start:data_end])
    planes = _decode_blocks(br, H, W)
    coef = torch.from_numpy(np.stack(planes)[None].astype(np.int32)).to(dev)
    return _rgb_to_host(jpeg_inverse(coef))[0]


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return float(10 * np.log10(255.0**2 / max(mse, 1e-12)))
