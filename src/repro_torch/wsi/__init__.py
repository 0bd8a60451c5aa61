"""WSI→DICOM conversion on PyTorch/CUDA: synthetic slides, containers, the
device pyramid, host JPEG entropy coding, DICOM Part-10 and the study tar."""
from repro_torch.wsi.convert import (ConvertOptions,  # noqa: F401
                                     convert_wsi_to_dicom, study_levels)
from repro_torch.wsi.formats import open_slide  # noqa: F401
from repro_torch.wsi.slide import SyntheticScanner  # noqa: F401
