"""PSV ("pretend-SVS"): the synthetic proprietary tiled container.

    magic 'PSV1' | u32 H | u32 W | u32 tile | u32 n_tiles
    per tile: u32 row | u32 col | u32 nbytes | zlib(RGB uint8 tile)

Kept as the simplest possible ``SlideReader`` implementation — the vendor
format a scanner emits before anything standard exists. Real archives are
tiled TIFF/SVS (see ``repro_torch.wsi.formats.tiff``).
"""
from __future__ import annotations

import io
import struct
import zlib

import numpy as np

from repro_torch.wsi.formats.base import SlideFormat

__all__ = ["PSVReader", "write_psv", "PSV_FORMAT"]

_MAGIC = b"PSV1"


def write_psv(tiles: dict[tuple[int, int], np.ndarray], H: int, W: int,
              tile: int) -> bytes:
    buf = io.BytesIO()
    buf.write(_MAGIC)
    buf.write(struct.pack("<IIII", H, W, tile, len(tiles)))
    for (r, c), arr in sorted(tiles.items()):
        raw = zlib.compress(np.ascontiguousarray(arr, np.uint8).tobytes(), 6)
        buf.write(struct.pack("<III", r, c, len(raw)))
        buf.write(raw)
    return buf.getvalue()


class PSVReader:
    """Streaming tile reader; indexes the container once, inflates on demand."""

    def __init__(self, data: bytes):
        if data[:4] != _MAGIC:
            raise ValueError("not a PSV container")
        if len(data) < 20:
            raise ValueError("truncated PSV container: missing header")
        self.H, self.W, self.tile, n = struct.unpack_from("<IIII", data, 4)
        if self.H <= 0 or self.W <= 0 or self.tile <= 0:
            raise ValueError(
                f"corrupt PSV container: dimensions {self.H}x{self.W}, "
                f"tile {self.tile}")
        self.metadata: dict = {}  # PSV carries no vendor metadata
        self._data = data
        self._index: dict[tuple[int, int], tuple[int, int]] = {}
        off = 20
        for _ in range(n):
            if off + 12 > len(data):
                raise ValueError(
                    f"truncated PSV container: tile directory ends at byte "
                    f"{len(data)}, expected {n} tile records")
            r, c, nb = struct.unpack_from("<III", data, off)
            off += 12
            if off + nb > len(data):
                raise ValueError(
                    f"truncated PSV container: tile ({r},{c}) data runs to "
                    f"byte {off + nb}, container is {len(data)} bytes")
            self._index[(r, c)] = (off, nb)
            off += nb

    @property
    def grid(self) -> tuple[int, int]:
        return self.H // self.tile, self.W // self.tile

    def read_tile(self, r: int, c: int) -> np.ndarray:
        off, nb = self._index[(r, c)]
        raw = zlib.decompress(self._data[off : off + nb])
        t = self.tile
        return np.frombuffer(raw, np.uint8).reshape(t, t, 3)

    def tiles(self):
        for (r, c) in sorted(self._index):
            yield (r, c), self.read_tile(r, c)


PSV_FORMAT = SlideFormat(
    name="psv",
    description="synthetic proprietary tiled container (PSV1)",
    extensions=(".psv",),
    matches=lambda data: bytes(data[:4]) == _MAGIC,
    reader=PSVReader,
)
