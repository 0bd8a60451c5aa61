"""Synthetic whole-slide scanner (a numpy copy of ``repro.wsi.slide``).

Real WSIs are gigapixel images in vendor containers that cannot be loaded
whole; the readers that stream them tile-by-tile live in
``repro_torch.wsi.formats`` (PSV and tiled TIFF/SVS).

``SyntheticScanner`` procedurally renders H&E-like content — smooth eosin
background + scattered hematoxylin "nuclei" — deterministically from a
seed, so tests and benchmarks get realistic, compressible, reproducible
pixel data at any size. It can emit the *same pixels* in either container
(``scan`` → PSV, ``scan_tiff`` → SVS-shaped tiled TIFF), which is what the
cross-format byte-identity assertions are built on.
"""
from __future__ import annotations

import numpy as np

# PSVReader and write_psv are re-exported for existing callers
from repro_torch.wsi.formats.psv import PSVReader, write_psv  # noqa: F401
from repro_torch.wsi.formats.tiff import write_tiff

__all__ = ["SyntheticScanner", "PSVReader", "write_psv"]


class SyntheticScanner:
    """Renders deterministic H&E-like slides into PSV or tiled-TIFF bytes."""

    def __init__(self, seed: int = 0):
        self.seed = seed

    def _render_tile(self, y0: int, x0: int, h: int, w: int,
                     rng_grid: np.ndarray) -> np.ndarray:
        yy = (np.arange(y0, y0 + h, dtype=np.float32))[:, None]
        xx = (np.arange(x0, x0 + w, dtype=np.float32))[None, :]
        # smooth eosin-pink stroma
        base = (
            0.5
            + 0.22 * np.sin(yy / 97.0 + self.seed)
            + 0.18 * np.cos(xx / 131.0 - self.seed * 0.7)
            + 0.10 * np.sin((xx + yy) / 53.0)
        )
        r = 230 - 40 * base
        g = 170 - 70 * base
        b = 200 - 30 * base
        # hematoxylin nuclei: pseudo-random blobs from a hash lattice
        cell = 48
        gy, gx = yy // cell, xx // cell
        hash_ = np.sin(gy * 12.9898 + gx * 78.233 + self.seed) * 43758.5453
        frac = hash_ - np.floor(hash_)
        cy = (gy + 0.2 + 0.6 * frac) * cell
        cx = (gx + 0.2 + 0.6 * (frac * 7 % 1)) * cell
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        radius2 = (6 + 8 * (frac * 3 % 1)) ** 2
        nucleus = (d2 < radius2) & (frac > 0.35)
        r = np.where(nucleus, 80 + 30 * frac, r)
        g = np.where(nucleus, 60 + 20 * frac, g)
        b = np.where(nucleus, 140 + 40 * frac, b)
        img = np.stack([r, g, b], axis=-1)
        return np.clip(img, 0, 255).astype(np.uint8)

    def _render_tiles(self, H: int, W: int,
                      tile: int) -> dict[tuple[int, int], np.ndarray]:
        assert H % tile == 0 and W % tile == 0
        return {(r, c): self._render_tile(r * tile, c * tile, tile, tile,
                                          None)
                for r in range(H // tile) for c in range(W // tile)}

    def scan(self, H: int = 1024, W: int = 1024, tile: int = 256) -> bytes:
        """Produce a PSV slide of the given dimensions."""
        return write_psv(self._render_tiles(H, W, tile), H, W, tile)

    def scan_tiff(self, H: int = 1024, W: int = 1024, tile: int = 256,
                  description: str | None = None) -> bytes:
        """Produce the same pixels as ``scan`` in an SVS-shaped tiled TIFF.

        The default ``ImageDescription`` carries Aperio-style ``Key =
        Value`` vendor metadata, which ``TiffSlideReader`` parses back into
        its ``metadata`` dict.
        """
        if description is None:
            description = (f"repro SyntheticScanner v1 {W}x{H} "
                           f"|AppMag = 20|MPP = 0.5|seed = {self.seed}")
        return write_tiff(self._render_tiles(H, W, tile), H, W, tile,
                          description=description)
