"""JPEG baseline encoder, host half: the vectorized entropy coder + JFIF.

The encode half of ``repro.wsi.jpeg``, copied as host numpy (the port
imports nothing of ``repro``). The transform (color conversion, 8×8 DCT,
quantization) runs on the card in ``repro_torch.kernels.jpeg_transform``;
Huffman coding is a sequential, branchy bitstream operation, so it stays on
the host, vectorized over a whole level (``encode_coef_batch``): one
gather/sort/bincount-bitpack pass whose cost scales with the emitted
symbols, not the coefficients. Output is byte-identical to the reference's
for equal coefficients.

Produces real JFIF bytes (SOI/APP0/DQT/SOF0/DHT/SOS/EOI, standard Annex-K
tables, 4:4:4, byte stuffing). The only module-level cache (the zigzag
gather index) is an ``lru_cache``, so the coder is thread-safe and the
heavy numpy regions release the GIL.
"""
from __future__ import annotations

import struct
from functools import lru_cache

import numpy as np

from repro_torch.kernels.ref import JPEG_CHROMA_Q, JPEG_LUMA_Q

__all__ = ["encode_coef_batch"]

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

_ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])


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
