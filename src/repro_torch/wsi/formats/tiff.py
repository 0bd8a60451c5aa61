"""Tiled TIFF — the SVS-shaped archive container, read and written in pure
Python.

This is the layout real slide archives hold: a classic (non-Big) TIFF whose
baseline image is carved into fixed-size tiles —

    header  'II' (or 'MM') | u16 42 | u32 IFD offset
    IFD     u16 n_entries | n × (u16 tag, u16 type, u32 count, u32 value/off)
    tags    ImageWidth/ImageLength, BitsPerSample 8,8,8, Compression 8
            (Deflate), Photometric RGB, SamplesPerPixel 3, TileWidth/
            TileLength, TileOffsets, TileByteCounts, ImageDescription

— which is exactly how Aperio ``.svs`` lays out its pyramid levels (an SVS
file *is* a tiled TIFF; its vendor metadata rides in ``ImageDescription``
as ``Aperio …|Key = Value|…`` pairs, which the reader parses into
``metadata``). The writer emits little-endian by default (what every
scanner ships) but both byte orders round-trip; the reader accepts either.

Unsupported-but-recognizable containers fail with *actionable* errors
(striped layout, JPEG/LZW compression, non-RGB), and every tile extent is
bounds-checked against the container at open time so a truncated file is a
clear ``ValueError`` rather than a mid-conversion explosion.
"""
from __future__ import annotations

import io
import struct
import zlib

import numpy as np

from repro_torch.wsi.formats.base import SlideFormat

__all__ = ["TiffSlideReader", "write_tiff", "TIFF_FORMAT"]

# the tags we read/write (TIFF 6.0 baseline + tiled extension)
_IMAGE_WIDTH = 256
_IMAGE_LENGTH = 257
_BITS_PER_SAMPLE = 258
_COMPRESSION = 259
_PHOTOMETRIC = 262
_IMAGE_DESCRIPTION = 270
_STRIP_OFFSETS = 273
_SAMPLES_PER_PIXEL = 277
_ROWS_PER_STRIP = 278
_PLANAR_CONFIG = 284
_TILE_WIDTH = 322
_TILE_LENGTH = 323
_TILE_OFFSETS = 324
_TILE_BYTE_COUNTS = 325

_ASCII, _SHORT, _LONG = 2, 3, 4
_TYPE_SIZE = {1: 1, _ASCII: 1, _SHORT: 2, _LONG: 4}

_COMP_NONE = 1
_COMP_DEFLATE_ADOBE = 8  # what Adobe/Aperio write
_COMP_DEFLATE_OLD = 32946  # the original libtiff Deflate code
_DEFLATE = (_COMP_DEFLATE_ADOBE, _COMP_DEFLATE_OLD)
_COMP_NAMES = {2: "CCITT RLE", 3: "CCITT G3", 4: "CCITT G4", 5: "LZW",
               6: "old-style JPEG", 7: "JPEG", 33003: "Aperio JPEG2000 YCbCr",
               33005: "Aperio JPEG2000 RGB", 34712: "JPEG2000"}


def _grid(H: int, W: int, tile: int) -> tuple[int, int]:
    return -(-H // tile), -(-W // tile)  # ceil: TIFF tiles pad the edges


# --------------------------------------------------------------------------
# writer
# --------------------------------------------------------------------------
def write_tiff(tiles: dict[tuple[int, int], np.ndarray], H: int, W: int,
               tile: int, *, description: str = "", byteorder: str = "<",
               level: int = 6) -> bytes:
    """Serialize RGB tiles as a classic tiled TIFF (Deflate-compressed).

    ``tiles`` maps (row, col) → (tile, tile, 3) uint8 arrays covering the
    full ceil(H/tile) × ceil(W/tile) grid (edge tiles pre-padded, as the
    TIFF spec requires). ``description`` lands in ``ImageDescription`` —
    use ``Vendor …|Key = Value`` pairs for SVS-style metadata. Output is
    deterministic for identical input, so bucket content-hashing (and
    therefore idempotent re-ingestion) works on TIFF slides exactly as it
    does on PSV.
    """
    if byteorder not in ("<", ">"):
        raise ValueError("byteorder must be '<' (II) or '>' (MM)")
    e = byteorder
    bh, bw = _grid(H, W, tile)
    want = {(r, c) for r in range(bh) for c in range(bw)}
    if set(tiles) != want:
        raise ValueError(
            f"tile grid mismatch: need all of {bh}x{bw} row-major tiles, "
            f"got {len(tiles)}")
    blobs = []
    for r in range(bh):
        for c in range(bw):
            arr = np.ascontiguousarray(tiles[(r, c)], np.uint8)
            if arr.shape != (tile, tile, 3):
                raise ValueError(
                    f"tile ({r},{c}) shape {arr.shape}, expected "
                    f"({tile}, {tile}, 3) — pad edge tiles to full size")
            blobs.append(zlib.compress(arr.tobytes(), level))

    buf = io.BytesIO()
    buf.write(b"II" if e == "<" else b"MM")
    buf.write(struct.pack(e + "HI", 42, 0))  # IFD offset patched at the end
    offsets = []
    for b in blobs:
        offsets.append(buf.tell())
        buf.write(b)
        if buf.tell() % 2:
            buf.write(b"\0")  # keep everything word-aligned

    entries: list[tuple[int, int, object]] = [
        (_IMAGE_WIDTH, _LONG, [W]),
        (_IMAGE_LENGTH, _LONG, [H]),
        (_BITS_PER_SAMPLE, _SHORT, [8, 8, 8]),
        (_COMPRESSION, _SHORT, [_COMP_DEFLATE_ADOBE]),
        (_PHOTOMETRIC, _SHORT, [2]),  # RGB
        (_IMAGE_DESCRIPTION, _ASCII, description.encode() + b"\0"),
        (_SAMPLES_PER_PIXEL, _SHORT, [3]),
        (_PLANAR_CONFIG, _SHORT, [1]),  # chunky RGBRGB…
        (_TILE_WIDTH, _LONG, [tile]),
        (_TILE_LENGTH, _LONG, [tile]),
        (_TILE_OFFSETS, _LONG, offsets),
        (_TILE_BYTE_COUNTS, _LONG, [len(b) for b in blobs]),
    ]
    if not description:
        entries = [en for en in entries if en[0] != _IMAGE_DESCRIPTION]

    packed = []
    for tag, typ, vals in entries:  # already in ascending tag order
        if typ == _ASCII:
            count, payload = len(vals), bytes(vals)
        else:
            count = len(vals)
            payload = struct.pack(
                f"{e}{count}{'H' if typ == _SHORT else 'I'}", *vals)
        if len(payload) <= 4:
            value = payload.ljust(4, b"\0")
        else:
            if buf.tell() % 2:
                buf.write(b"\0")
            value = struct.pack(e + "I", buf.tell())
            buf.write(payload)
        packed.append(struct.pack(e + "HHI", tag, typ, count) + value)

    if buf.tell() % 2:
        buf.write(b"\0")
    ifd_off = buf.tell()
    buf.write(struct.pack(e + "H", len(packed)))
    for en in packed:
        buf.write(en)
    buf.write(struct.pack(e + "I", 0))  # no next IFD
    out = bytearray(buf.getvalue())
    out[4:8] = struct.pack(e + "I", ifd_off)
    return bytes(out)


# --------------------------------------------------------------------------
# reader
# --------------------------------------------------------------------------
def _parse_description(desc: str) -> dict:
    """Aperio-style ``Vendor header|Key = Value|…`` → metadata dict."""
    meta: dict = {}
    if not desc:
        return meta
    meta["description"] = desc
    parts = desc.split("|")
    meta["vendor"] = parts[0].strip()
    for p in parts[1:]:
        if "=" in p:
            k, v = p.split("=", 1)
            meta[k.strip()] = v.strip()
    return meta


class TiffSlideReader:
    """Streaming tile reader over a classic tiled TIFF/SVS container.

    Indexes the first IFD once (both byte orders accepted), validates the
    layout it can serve — tiled, 8-bit chunky RGB, Deflate or uncompressed
    — with actionable errors for everything else, bounds-checks every tile
    extent against the container size, and inflates tiles on demand.
    """

    def __init__(self, data: bytes):
        data = bytes(data)
        if len(data) < 8:
            raise ValueError("truncated TIFF container: shorter than the "
                             "8-byte header")
        if data[:2] == b"II":
            e = "<"
        elif data[:2] == b"MM":
            e = ">"
        else:
            raise ValueError("not a TIFF container (no II/MM byte-order mark)")
        self._e = e
        magic, ifd_off = struct.unpack_from(e + "HI", data, 2)
        if magic != 42:
            raise ValueError(
                f"unsupported TIFF: magic {magic} (classic TIFF is 42; "
                "BigTIFF (43) is not supported)")
        tags = self._read_ifd(data, ifd_off)

        if _IMAGE_WIDTH not in tags or _IMAGE_LENGTH not in tags:
            raise ValueError("corrupt TIFF: missing ImageWidth/ImageLength")
        self.W = int(tags[_IMAGE_WIDTH][0])
        self.H = int(tags[_IMAGE_LENGTH][0])
        if _TILE_OFFSETS not in tags or _TILE_WIDTH not in tags:
            if _STRIP_OFFSETS in tags or _ROWS_PER_STRIP in tags:
                raise ValueError(
                    "unsupported TIFF: striped layout (StripOffsets) — this "
                    "pipeline streams tiles; re-save with TileWidth/"
                    "TileLength (tiled TIFF / SVS)")
            raise ValueError("unsupported TIFF: no TileOffsets — not a "
                             "tiled container")
        if self.H <= 0 or self.W <= 0:
            raise ValueError(
                f"corrupt TIFF: image dimensions {self.H}x{self.W}")
        tw = int(tags[_TILE_WIDTH][0])
        th = int(tags.get(_TILE_LENGTH, tags[_TILE_WIDTH])[0])
        if tw != th:
            raise ValueError(
                f"unsupported TIFF: non-square {tw}x{th} tiles (the "
                "converter's pyramid assumes square tiles)")
        if tw <= 0:
            raise ValueError(f"corrupt TIFF: tile size {tw}")
        self.tile = tw

        comp = int(tags.get(_COMPRESSION, [_COMP_NONE])[0])
        if comp not in (_COMP_NONE, *_DEFLATE):
            name = _COMP_NAMES.get(comp, f"code {comp}")
            raise ValueError(
                f"unsupported TIFF compression: {name} — this reader "
                "handles Deflate (8/32946) and uncompressed (1); "
                "re-encode the slide with Deflate tiles")
        self._comp = comp
        photo = int(tags.get(_PHOTOMETRIC, [2])[0])
        spp = int(tags.get(_SAMPLES_PER_PIXEL, [1])[0])
        bps = [int(b) for b in tags.get(_BITS_PER_SAMPLE, [8])]
        if photo != 2 or spp != 3 or any(b != 8 for b in bps):
            raise ValueError(
                f"unsupported TIFF: photometric={photo} samples={spp} "
                f"bits={bps} — need 8-bit chunky RGB (photometric 2, "
                "3 samples of 8 bits)")
        if int(tags.get(_PLANAR_CONFIG, [1])[0]) != 1:
            raise ValueError("unsupported TIFF: planar (separate-plane) "
                             "configuration — need chunky RGB")

        bh, bw = _grid(self.H, self.W, self.tile)
        offsets = [int(o) for o in tags[_TILE_OFFSETS]]
        counts = [int(n) for n in tags.get(_TILE_BYTE_COUNTS, [])]
        if len(offsets) != bh * bw or len(counts) != len(offsets):
            raise ValueError(
                f"corrupt TIFF: {len(offsets)} tile offsets / {len(counts)} "
                f"byte counts for a {bh}x{bw} tile grid")
        for i, (o, n) in enumerate(zip(offsets, counts)):
            if o + n > len(data):
                raise ValueError(
                    f"truncated TIFF container: tile {i} data runs to byte "
                    f"{o + n}, container is {len(data)} bytes")
        self._offsets, self._counts = offsets, counts
        self._data = data
        self.metadata = _parse_description(tags.get(_IMAGE_DESCRIPTION, ""))

    def _read_ifd(self, data: bytes, off: int) -> dict:
        e = self._e
        if off + 2 > len(data):
            raise ValueError(
                f"truncated TIFF container: IFD offset {off} past EOF")
        (n,) = struct.unpack_from(e + "H", data, off)
        if off + 2 + 12 * n + 4 > len(data):
            raise ValueError(
                f"truncated TIFF container: IFD with {n} entries at byte "
                f"{off} past EOF")
        tags: dict = {}
        for i in range(n):
            tag, typ, count = struct.unpack_from(e + "HHI", data,
                                                 off + 2 + 12 * i)
            size = _TYPE_SIZE.get(typ)
            if size is None:
                continue  # rational/float tags: nothing we need
            nbytes = size * count
            pos = off + 2 + 12 * i + 8
            if nbytes > 4:
                (pos,) = struct.unpack_from(e + "I", data, pos)
                if pos + nbytes > len(data):
                    raise ValueError(
                        f"truncated TIFF container: tag {tag} values at "
                        f"byte {pos} past EOF")
            if typ == _ASCII:
                tags[tag] = data[pos:pos + count].split(b"\0")[0] \
                    .decode("latin-1")
            else:
                fmt = {1: "B", _SHORT: "H", _LONG: "I"}[typ]
                tags[tag] = list(struct.unpack_from(f"{e}{count}{fmt}",
                                                    data, pos))
        return tags

    @property
    def grid(self) -> tuple[int, int]:
        return _grid(self.H, self.W, self.tile)

    def read_tile(self, r: int, c: int) -> np.ndarray:
        bh, bw = self.grid
        if not (0 <= r < bh and 0 <= c < bw):
            raise KeyError((r, c))
        i = r * bw + c
        raw = self._data[self._offsets[i]:self._offsets[i] + self._counts[i]]
        if self._comp in _DEFLATE:
            try:
                raw = zlib.decompress(raw)
            except zlib.error as exc:
                raise ValueError(f"corrupt TIFF tile ({r},{c}): {exc}") \
                    from None
        t = self.tile
        if len(raw) != t * t * 3:
            raise ValueError(
                f"corrupt TIFF tile ({r},{c}): {len(raw)} bytes after "
                f"decompression, expected {t * t * 3}")
        return np.frombuffer(raw, np.uint8).reshape(t, t, 3)

    def tiles(self):
        bh, bw = self.grid
        for r in range(bh):
            for c in range(bw):
                yield (r, c), self.read_tile(r, c)


TIFF_FORMAT = SlideFormat(
    name="tiff",
    description="classic tiled TIFF / SVS (Deflate RGB tiles)",
    extensions=(".tiff", ".tif", ".svs"),
    # match on the byte-order mark alone so recognizable-but-unsupported
    # variants (BigTIFF, striped, JPEG-compressed) reach the reader's
    # *specific* error instead of the generic unknown-container one
    matches=lambda data: bytes(data[:2]) in (b"II", b"MM"),
    reader=TiffSlideReader,
)
