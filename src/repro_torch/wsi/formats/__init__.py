"""Multi-format slide ingestion: ``SlideReader`` protocol + container registry.

A numpy-only copy of ``repro.wsi.formats`` (the port imports nothing of
``repro``).

    from repro_torch.wsi.formats import open_slide
    rd = open_slide(blob)          # sniffs PSV / tiled-TIFF / SVS by magic
    for (r, c), tile in rd.tiles():
        ...

See DESIGN.md, "Format ingestion", for the TIFF layout and how to add a
reader (~150 lines: implement ``SlideReader``, register a ``SlideFormat``).
"""
from repro_torch.wsi.formats.base import (  # noqa: F401
    SlideFormat, SlideReader, formats, open_slide, register_format, sniff)
from repro_torch.wsi.formats.psv import (  # noqa: F401
    PSV_FORMAT, PSVReader, write_psv)
from repro_torch.wsi.formats.tiff import (  # noqa: F401
    TIFF_FORMAT, TiffSlideReader, write_tiff)

register_format(PSV_FORMAT)
register_format(TIFF_FORMAT)
