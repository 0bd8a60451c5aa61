"""Hand-written CUDA kernels for Hopper (+ their plain PyTorch versions).

``csrc/<name>.cu`` holds each kernel and its C entry point, ``_build.py``
compiles and loads them, ``ops.py`` the public wrappers (impl dispatch,
checks, launch counts) and ``ref.py`` the plain versions.
"""
from repro_torch.kernels.ops import (dct8x8_quant,  # noqa: F401
                                     downsample2x2, entropy_decode,
                                     idct8x8_dequant, jpeg_inverse,
                                     jpeg_transform, rgb2ycbcr, wkv_chunk)
