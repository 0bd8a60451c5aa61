"""Roofline analysis for the H100: the three-term derivation, the eager
program's counters, and each ported kernel's work formula."""
from repro_torch.roofline.counters import (Counter,  # noqa: F401
                                           analyze_step, collective_traffic,
                                           tensor_bytes)
from repro_torch.roofline.terms import HW, derive_terms  # noqa: F401
from repro_torch.roofline.work import (bound_s,  # noqa: F401
                                       dct8x8_quant_work, downsample2x2_work,
                                       entropy_decode_work,
                                       jpeg_inverse_work, jpeg_transform_work,
                                       rgb2ycbcr_work, wkv_chunk_work)
