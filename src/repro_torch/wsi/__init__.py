"""WSI→DICOM conversion on PyTorch/CUDA: synthetic slides, containers, the
device pyramid, the JPEG codec (encode, and the read side's batched decode
on the card), DICOM Part-10, the study tar, and the services that hang off
the DICOM store (STOW/QIDO/WADO, validation, ML inference, tiled-TIFF
export)."""
from repro_torch.wsi.convert import (ConvertOptions,  # noqa: F401
                                     convert_wsi_to_dicom, study_levels)
from repro_torch.wsi.dicom import (Part10Index, read_part10,  # noqa: F401
                                   write_part10)
from repro_torch.wsi.export import ExportService  # noqa: F401
from repro_torch.wsi.formats import (PSVReader, SlideFormat,  # noqa: F401
                                     SlideReader, TiffSlideReader,
                                     open_slide, register_format, sniff,
                                     write_psv, write_tiff)
from repro_torch.wsi.jpeg import (decode_coef_batch,  # noqa: F401
                                  decode_frames, decode_tile,
                                  decode_tiles_batch, encode_coef_batch,
                                  encode_tile, encode_tiles_batch, psnr)
from repro_torch.wsi.slide import SyntheticScanner  # noqa: F401
from repro_torch.wsi.store_service import DicomStoreService  # noqa: F401
from repro_torch.wsi.subscribers import (InferenceSubscriber,  # noqa: F401
                                         ValidationService)
