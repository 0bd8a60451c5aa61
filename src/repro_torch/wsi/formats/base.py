"""The slide-ingestion abstraction: ``SlideReader`` + the format registry.

The paper's institutional-adoption claim is *format* interoperability —
"compatibility with existing scanners, microscopes, and data archives" —
and the durable interface for that is not any one container but the reader
protocol: a tiled, streaming view of a gigapixel image. Every concrete
container (our synthetic PSV, tiled TIFF/SVS, …) plugs in as one
``SlideFormat`` entry; the converter and the event-driven pipeline consume
only the protocol, so adding a format is a reader drop-in, never a
converter fork.

``sniff(data)`` resolves a container by magic bytes (never by filename —
the landing bucket receives whatever key the scanner chose) and raises an
actionable ``ValueError`` naming the supported formats for anything it
does not recognize, which is exactly the string that ends up as the
``dlq_reason`` when garbage lands in the bucket.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Protocol, runtime_checkable

import numpy as np

__all__ = ["SlideReader", "SlideFormat", "register_format", "formats",
           "sniff", "open_slide"]


@runtime_checkable
class SlideReader(Protocol):
    """A tiled, streaming view of one slide level (the scan resolution).

    Implementations index the container once at construction and inflate
    pixel data on demand — never materializing the full image (the
    HBM→VMEM discipline of the converters). ``read_tile`` always returns a
    full ``(tile, tile, 3)`` uint8 array (edge tiles are padded, as in
    TIFF); ``tiles()`` streams them in row-major order. ``metadata`` holds
    whatever vendor key/values the container carries (e.g. the parsed
    Aperio ``ImageDescription``) — empty for formats without any.
    """

    H: int
    W: int
    tile: int
    metadata: dict

    @property
    def grid(self) -> tuple[int, int]: ...

    def read_tile(self, r: int, c: int) -> np.ndarray: ...

    def tiles(self) -> Iterator[tuple[tuple[int, int], np.ndarray]]: ...


@dataclasses.dataclass(frozen=True)
class SlideFormat:
    """One registry entry: how to recognize and open a container."""

    name: str  # short id ("psv", "tiff") — also the pipeline format metric
    description: str
    extensions: tuple[str, ...]  # conventional suffixes, for error messages
    matches: Callable[[bytes], bool]  # magic-byte check on the raw container
    reader: Callable[[bytes], SlideReader]


_REGISTRY: dict[str, SlideFormat] = {}


def register_format(fmt: SlideFormat) -> None:
    """Add (or replace) a container format. Match order = registration order."""
    _REGISTRY[fmt.name] = fmt


def formats() -> dict[str, SlideFormat]:
    """The registered formats, by name."""
    return dict(_REGISTRY)


def sniff(data: bytes) -> str:
    """Resolve a container's format name from its magic bytes.

    Raises an actionable ``ValueError`` for unknown containers — this
    string is what a dead-lettered landing object carries as its
    ``dlq_reason``, so it names every supported format.
    """
    for fmt in _REGISTRY.values():
        if fmt.matches(data):
            return fmt.name
    known = ", ".join(f"{f.name} ({'/'.join(f.extensions)})"
                      for f in _REGISTRY.values())
    head = bytes(data[:8]).hex() or "<empty>"
    raise ValueError(
        f"unknown slide container (leading bytes {head}): supported "
        f"formats are {known}; register new ones with "
        "repro_torch.wsi.formats.register_format")


def open_slide(data: bytes) -> SlideReader:
    """Sniff ``data`` and construct the matching reader."""
    return _REGISTRY[sniff(data)].reader(data)
