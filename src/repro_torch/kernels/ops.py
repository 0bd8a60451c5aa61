"""Public wrappers over the port's CUDA kernels: impl dispatch and launch.

``impl`` selects the backend per call:

- ``"auto"`` (default) — a CUDA tensor launches the hand-written kernel
  (``csrc/*.cu``); a CPU tensor runs the plain PyTorch version in
  ``ref.py``. The choice follows the tensor's device only: on a CUDA tensor
  the wrapper launches the kernel or raises, and never falls back. On
  either device ``auto`` takes only what the kernel takes (float32,
  contiguous), so a CPU run fails where the card would.
- ``"ref"`` — the plain version on whatever device the tensor is on (the
  tests and ``chip_smoke.py`` compare kernels against it).

Each wrapper counts its kernel launches in ``<wrapper>.launches`` (a plain
integer, incremented only where the kernel is launched), so a run can show
that its main path went through the kernels.

Unlike ``repro.kernels.ops`` there is no power-of-two bucketing of the
batch: eager PyTorch has no jit cache to keep small, so a level of any
size is one launch at its own shape.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ref
from repro_torch.kernels._build import library

__all__ = ["jpeg_transform", "downsample2x2"]


def _launches_kernel(x: torch.Tensor, name: str, ndim: int,
                     impl: str) -> bool:
    """Whether this call launches the kernel (``auto`` on a CUDA tensor).

    For ``auto`` it first checks the kernel's input contract on any device.
    """
    if impl == "ref":
        return False
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'ref': {impl!r}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name}: the CUDA kernel takes float32, got "
                        f"{x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-d tensor, got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes a contiguous tensor")
    return x.is_cuda


def _raise_on_error(err: int, name: str) -> None:
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def jpeg_transform(tiles: torch.Tensor, qluma=None, qchroma=None,
                   impl: str = "auto") -> torch.Tensor:
    """(N, 3, H, W) RGB tiles → (N, 3, H, W) int32 quantized YCbCr DCT coefs.

    The whole-level dispatch: one launch transform-codes every tile of a
    pyramid level (level-shifted YCbCr, per-channel 8×8 DCT, ``round(y/q)``
    with the luma table for Y and the chroma table for Cb/Cr). H and W must
    be multiples of 8 (the pyramid's tiles are square, T × T). ``N == 0`` (a level smaller than one tile) launches
    nothing and returns an empty int32 tensor. ``qluma``/``qchroma`` default
    to the Annex-K tables.
    """
    if tiles.dim() != 4 or tiles.shape[1] != 3 or tiles.shape[2] % 8 \
            or tiles.shape[3] % 8:
        raise ValueError("jpeg_transform: expected (N, 3, H, W) tiles with "
                         f"H, W multiples of 8, got {tuple(tiles.shape)}")
    if not _launches_kernel(tiles, "jpeg_transform", 4, impl):
        return ref.jpeg_transform_ref(tiles, qluma, qchroma)
    N, _, H, W = tiles.shape
    out = torch.empty(tiles.shape, dtype=torch.int32, device=tiles.device)
    if N == 0:
        return out
    C = np.ascontiguousarray(ref.dct_matrix(), np.float32)
    q = ref.quant_tables(qluma, qchroma, "cpu").numpy()
    with torch.cuda.device(tiles.device):
        err = library("jpeg_transform")(
            tiles.data_ptr(), out.data_ptr(), N, H, W, C.ctypes.data,
            q.ctypes.data, torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, "jpeg_transform")
    jpeg_transform.launches += 1
    return out


jpeg_transform.launches = 0


def downsample2x2(img: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """One pyramid step: (C, H, W) → (C, H//2, W//2) float32.

    The 2×2 box mean, stride 2, with the pyramid chain's
    ``clip(round(·), 0, 255)`` fused in (``repro``'s chain applies it after
    ``repro.kernels.downsample2x2``): the output holds exact u8 values, as
    the next level's transform expects. An odd last row or column is
    dropped.
    """
    if not _launches_kernel(img, "downsample2x2", 3, impl):
        return ref.downsample2x2_q_ref(img)
    C, H, W = img.shape
    out = torch.empty((C, H // 2, W // 2), dtype=torch.float32,
                      device=img.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(img.device):
        err = library("downsample2x2")(
            img.data_ptr(), out.data_ptr(), C, H, W,
            torch.cuda.current_stream().cuda_stream)
    _raise_on_error(err, "downsample2x2")
    downsample2x2.launches += 1
    return out


downsample2x2.launches = 0
