"""Minimal DICOM Part-10 writer/parser — VL Whole Slide Microscopy IOD.

Writes standards-shaped files: 128-byte preamble + 'DICM', explicit-VR-LE
file-meta group (its own group length), explicit-VR-LE dataset with the WSM
module subset (tiled TILED_FULL organization), and multi-frame PixelData —
either native (uncompressed, defined length) or encapsulated JPEG baseline
(undefined length, basic offset table + one fragment per frame). The parser
reads back everything the tests need (tags, frames, encapsulation).
"""
from __future__ import annotations

import struct
import uuid

__all__ = [
    "Dataset", "Part10Index", "write_part10", "read_part10",
    "SOP_CLASS_VL_WSM", "TS_EXPLICIT_LE", "TS_JPEG_BASELINE", "new_uid",
]

SOP_CLASS_VL_WSM = "1.2.840.10008.5.1.4.1.1.77.1.6"
TS_EXPLICIT_LE = "1.2.840.10008.1.2.1"
TS_JPEG_BASELINE = "1.2.840.10008.1.2.4.50"
_IMPL_UID = "2.25.4242424242424242"

_LONG_VRS = {"OB", "OW", "OF", "SQ", "UT", "UN"}


def new_uid() -> str:
    return "2.25." + str(uuid.uuid4().int)[:32]


def _pad(value: bytes, even_pad: bytes = b" ") -> bytes:
    return value + (even_pad if len(value) % 2 else b"")


class Dataset:
    """Ordered (group, element) → (VR, raw value) map with typed helpers."""

    def __init__(self):
        self.elements: dict[tuple[int, int], tuple[str, bytes]] = {}

    def put(self, group: int, elem: int, vr: str, value):
        if isinstance(value, str):
            raw = value.encode()
            raw = _pad(raw, b"\x00" if vr == "UI" else b" ")
        elif isinstance(value, int):
            if vr == "US":
                raw = struct.pack("<H", value)
            elif vr == "UL":
                raw = struct.pack("<I", value)
            else:  # IS / DS etc. as string
                raw = _pad(str(value).encode())
        elif isinstance(value, bytes):
            raw = _pad(value, b"\x00")
        else:
            raise TypeError(type(value))
        self.elements[(group, elem)] = (vr, raw)

    def get(self, group: int, elem: int):
        return self.elements.get((group, elem))

    def get_str(self, group: int, elem: int) -> str | None:
        v = self.get(group, elem)
        return v[1].decode(errors="replace").rstrip(" \x00") if v else None

    def get_int(self, group: int, elem: int) -> int | None:
        v = self.get(group, elem)
        if v is None:
            return None
        vr, raw = v
        if vr == "US":
            return struct.unpack("<H", raw[:2])[0]
        if vr == "UL":
            return struct.unpack("<I", raw[:4])[0]
        return int(raw.decode().strip() or 0)

    def encode(self) -> bytes:
        out = bytearray()
        for (g, e) in sorted(self.elements):
            vr, raw = self.elements[(g, e)]
            out += struct.pack("<HH", g, e) + vr.encode()
            if vr in _LONG_VRS:
                out += b"\x00\x00" + struct.pack("<I", len(raw))
            else:
                out += struct.pack("<H", len(raw))
            out += raw
        return bytes(out)


def _encapsulate(frames: list[bytes]) -> bytes:
    """Encapsulated pixel data: basic offset table + one fragment per frame."""
    out = bytearray()
    offsets = []
    off = 0
    frags = []
    for f in frames:
        f = _pad(f, b"\x00")
        offsets.append(off)
        frags.append(f)
        off += 8 + len(f)
    bot = b"".join(struct.pack("<I", o) for o in offsets)
    out += struct.pack("<HHI", 0xFFFE, 0xE000, len(bot)) + bot
    for f in frags:
        out += struct.pack("<HHI", 0xFFFE, 0xE000, len(f)) + f
    out += struct.pack("<HHI", 0xFFFE, 0xE0DD, 0)
    return bytes(out)


def write_part10(
    *,
    frames: list[bytes],
    rows: int,
    cols: int,
    total_rows: int,
    total_cols: int,
    transfer_syntax: str = TS_JPEG_BASELINE,
    sop_instance_uid: str | None = None,
    study_uid: str | None = None,
    series_uid: str | None = None,
    instance_number: int = 1,
    patient_id: str = "ANON",
    metadata: dict | None = None,
) -> bytes:
    """Build one WSM instance (one pyramid level) as Part-10 bytes."""
    sop_uid = sop_instance_uid or new_uid()
    encapsulated = transfer_syntax != TS_EXPLICIT_LE

    meta = Dataset()
    meta.put(0x0002, 0x0001, "OB", b"\x00\x01")
    meta.put(0x0002, 0x0002, "UI", SOP_CLASS_VL_WSM)
    meta.put(0x0002, 0x0003, "UI", sop_uid)
    meta.put(0x0002, 0x0010, "UI", transfer_syntax)
    meta.put(0x0002, 0x0012, "UI", _IMPL_UID)
    meta_bytes = meta.encode()

    ds = Dataset()
    ds.put(0x0008, 0x0016, "UI", SOP_CLASS_VL_WSM)
    ds.put(0x0008, 0x0018, "UI", sop_uid)
    ds.put(0x0008, 0x0020, "DA", "20220101")
    ds.put(0x0008, 0x0030, "TM", "000000")
    ds.put(0x0008, 0x0060, "CS", "SM")
    ds.put(0x0010, 0x0010, "PN", "Synthetic^Slide")
    ds.put(0x0010, 0x0020, "LO", patient_id)
    ds.put(0x0020, 0x000D, "UI", study_uid or new_uid())
    ds.put(0x0020, 0x000E, "UI", series_uid or new_uid())
    ds.put(0x0020, 0x0011, "IS", 1)
    ds.put(0x0020, 0x0013, "IS", instance_number)
    ds.put(0x0020, 0x9311, "CS", "TILED_FULL")
    ds.put(0x0028, 0x0002, "US", 3)
    ds.put(0x0028, 0x0004, "CS",
           "YBR_FULL" if encapsulated else "RGB")
    ds.put(0x0028, 0x0006, "US", 0)
    ds.put(0x0028, 0x0008, "IS", len(frames))
    ds.put(0x0028, 0x0010, "US", rows)
    ds.put(0x0028, 0x0011, "US", cols)
    ds.put(0x0028, 0x0100, "US", 8)
    ds.put(0x0028, 0x0101, "US", 8)
    ds.put(0x0028, 0x0102, "US", 7)
    ds.put(0x0028, 0x0103, "US", 0)
    ds.put(0x0048, 0x0006, "UL", total_cols)
    ds.put(0x0048, 0x0007, "UL", total_rows)
    for k, v in (metadata or {}).items():  # private vendor block
        ds.put(0x0009, 0x1000 + k, "LO", str(v))
    body = ds.encode()

    out = bytearray()
    out += b"\x00" * 128 + b"DICM"
    # group length element for file meta
    gl = Dataset()
    gl.put(0x0002, 0x0000, "UL", len(meta_bytes))
    out += gl.encode() + meta_bytes
    out += body
    # pixel data
    if encapsulated:
        out += struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00"
        out += struct.pack("<I", 0xFFFFFFFF)
        out += _encapsulate(frames)
    else:
        blob = b"".join(frames)
        blob = _pad(blob, b"\x00")
        out += struct.pack("<HH", 0x7FE0, 0x0010) + b"OB\x00\x00"
        out += struct.pack("<I", len(blob)) + blob
    return bytes(out)


def read_part10(data: bytes) -> tuple[Dataset, list[bytes]]:
    """Parse a Part-10 file produced by ``write_part10``.

    Returns (dataset incl. file meta, pixel-data frames), materializing
    every frame — a thin wrapper over :class:`Part10Index`, which owns the
    single structural pass (and therefore the single copy of the
    corruption checks: truncated/malformed input raises
    ``ValueError("corrupt Part-10 …")`` from the scan).
    """
    idx = Part10Index(data)
    ds = Dataset()
    for (g, e), (vr, off, ln) in idx.elements.items():
        ds.elements[(g, e)] = (vr, data[off : off + ln])
    return ds, [idx.read_frame(i) for i in range(idx.n_frames)]


class Part10Index:
    """Offset index over a Part-10 byte stream — parse once, seek forever.

    One scan over ``data`` records every element's (VR, value offset, value
    length) and the pixel-data frame geometry — encapsulated fragment
    extents cross-checked against the basic offset table, or the native
    frame stride — **without materializing any frame**. After construction,
    ``read_element`` and ``read_frame(i)`` are single slices of the raw
    bytes: a frame fetch costs O(frame size), not O(file size) as with
    ``read_part10``, which is what makes frame-level WADO on a cached index
    cheap (see ``DicomStoreService.retrieve_frame``).

    Malformed input raises ``ValueError("corrupt Part-10 …")`` exactly like
    ``read_part10``; additionally a basic offset table whose length is not a
    multiple of 4, or whose entries disagree with the actual fragment
    positions, is rejected.

    Thread-safety (PR 8 lockdep audit): the index is **immutable after
    construction** — ``__init__`` does the whole scan and readers only
    slice ``self.data`` — so one instance is safely shared across threads
    with no lock of its own. The mutable state around it (the store's LRU
    of these, ``DicomStoreService._frame_cache``) is what gets the
    ``TrackedLock``.
    """

    def __init__(self, data: bytes):
        if len(data) < 132 or data[128:132] != b"DICM":
            raise ValueError("corrupt Part-10 stream: missing DICM magic")
        self.data = data
        # (group, elem) -> (vr, value offset, value length)
        self.elements: dict[tuple[int, int], tuple[str, int, int]] = {}
        self.frames: list[tuple[int, int]] = []  # (offset, length)
        self.encapsulated = False
        try:
            self._scan()
        except (struct.error, UnicodeDecodeError) as exc:
            raise ValueError(f"corrupt Part-10 stream: {exc}") from None

    # ---- the single structural pass --------------------------------------
    def _scan(self) -> None:
        data, n = self.data, len(self.data)
        pos = 132
        while pos < n:
            g, e = struct.unpack_from("<HH", data, pos)
            pos += 4
            vr = data[pos : pos + 2].decode("ascii")
            if not (vr.isalpha() and vr.isupper()):
                raise ValueError(
                    f"corrupt Part-10 stream: invalid VR {vr!r} at "
                    f"offset {pos}")
            if vr in _LONG_VRS:
                ln = struct.unpack_from("<I", data, pos + 4)[0]
                pos += 8
            else:
                ln = struct.unpack_from("<H", data, pos + 2)[0]
                pos += 4
            if (g, e) == (0x7FE0, 0x0010):
                pos = self._scan_pixel_data(pos, ln)
                continue
            if pos + ln > n:
                raise ValueError(
                    f"corrupt Part-10 stream: element ({g:04x},{e:04x}) "
                    "value truncated")
            self.elements[(g, e)] = (vr, pos, ln)
            pos += ln

    def _scan_pixel_data(self, pos: int, ln: int) -> int:
        data, n = self.data, len(self.data)
        if ln != 0xFFFFFFFF:  # native: frames are a fixed stride into blob
            if pos + ln > n:
                raise ValueError(
                    "corrupt Part-10 stream: pixel data truncated")
            nf = self.get_int(0x0028, 0x0008) or 1
            rows = self.get_int(0x0028, 0x0010)
            cols = self.get_int(0x0028, 0x0011)
            spp = self.get_int(0x0028, 0x0002) or 1
            if not rows or not cols:
                raise ValueError(
                    "corrupt Part-10 stream: native pixel data without "
                    "Rows/Columns")
            fsize = rows * cols * spp
            if nf * fsize > ln:
                raise ValueError(
                    "corrupt Part-10 stream: native pixel data shorter "
                    f"than {nf} frames of {fsize} bytes")
            self.frames = [(pos + i * fsize, fsize) for i in range(nf)]
            return pos + ln
        # encapsulated: basic offset table item, then one fragment per frame
        self.encapsulated = True
        ig, ie, il = struct.unpack_from("<HHI", data, pos)
        pos += 8
        if (ig, ie) != (0xFFFE, 0xE000) or pos + il > n:
            raise ValueError(
                "corrupt Part-10 stream: missing basic offset table item")
        if il % 4:
            raise ValueError(
                "corrupt Part-10 stream: basic offset table length "
                f"{il} is not a multiple of 4")
        bot = list(struct.unpack_from(f"<{il // 4}I", data, pos))
        pos += il
        offsets = []  # of each fragment's item header, relative to the first
        first = pos
        while True:
            ig, ie, il = struct.unpack_from("<HHI", data, pos)
            pos += 8
            if (ig, ie) == (0xFFFE, 0xE0DD):
                break
            if (ig, ie) != (0xFFFE, 0xE000) or pos + il > n:
                raise ValueError(
                    "corrupt Part-10 stream: bad pixel-data item at "
                    f"offset {pos - 8}")
            offsets.append(pos - 8 - first)
            self.frames.append((pos, il))
            pos += il
        if bot and bot != offsets:
            raise ValueError(
                "corrupt Part-10 stream: basic offset table disagrees "
                f"with fragment positions ({bot} != {offsets})")
        return pos

    # ---- seeks -------------------------------------------------------------
    @property
    def n_frames(self) -> int:
        return len(self.frames)

    def read_element(self, group: int, elem: int) -> bytes | None:
        """Raw value bytes of one element (None if absent) — a single slice."""
        v = self.elements.get((group, elem))
        if v is None:
            return None
        _, off, ln = v
        return self.data[off : off + ln]

    def get_str(self, group: int, elem: int) -> str | None:
        raw = self.read_element(group, elem)
        return raw.decode(errors="replace").rstrip(" \x00") \
            if raw is not None else None

    def get_int(self, group: int, elem: int) -> int | None:
        v = self.elements.get((group, elem))
        if v is None:
            return None
        vr, off, ln = v
        raw = self.data[off : off + ln]
        if vr == "US":
            return struct.unpack("<H", raw[:2])[0]
        if vr == "UL":
            return struct.unpack("<I", raw[:4])[0]
        return int(raw.decode().strip() or 0)

    def read_frame(self, i: int) -> bytes:
        """Frame ``i``'s bytes — byte-identical to ``read_part10(...)[1][i]``
        but O(frame size): one slice at the indexed offset."""
        if not 0 <= i < len(self.frames):
            raise IndexError(
                f"frame {i} out of range (instance has {len(self.frames)})")
        off, ln = self.frames[i]
        return self.data[off : off + ln]

    # ---- integrity ---------------------------------------------------------
    def verify(self) -> None:
        """Deep integrity checks beyond the structural scan.

        Raises ``ValueError("corrupt Part-10 …")`` if the declared frame
        count disagrees with the indexed frames, identity elements are
        missing, or (encapsulated JPEG) a frame does not start with an SOI
        marker — the bit-rot class the validation subscriber quarantines.
        """
        for g, e, what in ((0x0008, 0x0018, "SOP instance UID"),
                           (0x0020, 0x000D, "study UID"),
                           (0x0020, 0x000E, "series UID")):
            if not self.get_str(g, e):
                raise ValueError(f"corrupt Part-10 stream: missing {what}")
        declared = self.get_int(0x0028, 0x0008)
        if declared is not None and declared != len(self.frames):
            raise ValueError(
                f"corrupt Part-10 stream: {declared} frames declared, "
                f"{len(self.frames)} indexed")
        if self.encapsulated:
            for i, (off, ln) in enumerate(self.frames):
                if ln < 2 or self.data[off : off + 2] != b"\xff\xd8":
                    raise ValueError(
                        f"corrupt Part-10 stream: frame {i} lacks a JPEG "
                        "SOI marker")
