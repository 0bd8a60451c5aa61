"""WSI→DICOM conversion on PyTorch/CUDA: synthetic slides, containers, the
device pyramid, the JPEG codec (encode, and the read side's batched decode
on the card), DICOM Part-10 and the study tar."""
from repro_torch.wsi.convert import (ConvertOptions,  # noqa: F401
                                     convert_wsi_to_dicom, study_levels)
from repro_torch.wsi.formats import open_slide  # noqa: F401
from repro_torch.wsi.jpeg import (decode_coef_batch,  # noqa: F401
                                  decode_frames, decode_tile,
                                  decode_tiles_batch, encode_tile,
                                  encode_tiles_batch, psnr)
from repro_torch.wsi.slide import SyntheticScanner  # noqa: F401
