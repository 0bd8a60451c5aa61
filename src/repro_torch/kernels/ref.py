"""Plain PyTorch versions of the port's kernels (the ground truth on the card).

Each function here computes, with ordinary tensor operations, exactly what
one hand-written CUDA kernel in ``csrc/`` computes, in the same order of
float operations. The CPU runs these in place of the kernels, the tests
compare them with the JAX package, and ``chip_smoke.py`` compares every
kernel with its plain version on the card.

Bit-exactness rules (DESIGN.md "Bit-exactness contract", carried over):

* the level-shifted YCbCr polynomials exist once (:func:`ycbcr_polynomials`)
  in the reference's expression order — the CUDA kernel restates them term
  for term, with no fused multiply-add;
* the 8×8 DCT is two chained fixed-order 8-term sums, the row pass
  ``T = C·X`` and then the column pass ``Y = T·Cᵀ``, each summed j = 0..7
  left to right — exactly the loop the CUDA kernel runs, so kernel and
  plain version agree bit for bit on any input;
* ``C`` is the numpy-built :func:`dct_matrix`, never recomputed with a
  float32 cosine, and quantization is ``round_half_even(y / q)``.

The JAX reference sums the DCT in an order its backend picks, so on
adversarial content (uniform noise) a last-ULP difference can flip a
quotient that sits exactly at a rounding tie: measured 2 coefficients in
12.58M off by ±1, each at ``|frac(y/q)| − 0.5`` below 1e-6 (ROADMAP,
Queue C). On slide content the two agree exactly.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "JPEG_LUMA_Q", "JPEG_CHROMA_Q", "dct_matrix", "ycbcr_polynomials",
    "quant_tables", "jpeg_quotient_ref", "jpeg_transform_ref",
    "downsample2x2_ref", "downsample2x2_q_ref",
]

# ITU-T81 Annex K quantization tables (quality 50)
JPEG_LUMA_Q = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)

JPEG_CHROMA_Q = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], np.float32)


def dct_matrix() -> np.ndarray:
    """Orthonormal 8×8 DCT-II matrix C (DCT: C·X·Cᵀ), built in numpy."""
    k = np.arange(8)
    C = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    C *= np.sqrt(2.0 / 8.0)
    C[0] *= 1.0 / np.sqrt(2.0)
    return C.astype(np.float32)


def ycbcr_polynomials(r, g, b):
    """The single copy of the level-shifted JPEG YCbCr polynomials.

    Same expressions, same order, as ``repro.kernels.ref.ycbcr_polynomials``
    (float32 throughout: a Python float constant times a float32 tensor
    rounds the constant to float32 first, as JAX's weak types do).
    ``csrc/jpeg_transform.cu`` restates these terms one for one.
    """
    y = 0.299 * r + 0.587 * g + 0.114 * b - 128.0
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b
    return y, cb, cr


def quant_tables(qluma, qchroma, device) -> torch.Tensor:
    """(3, 8, 8) float32 tables for the Y, Cb and Cr planes."""
    ql = JPEG_LUMA_Q if qluma is None else qluma
    qc = JPEG_CHROMA_Q if qchroma is None else qchroma
    q = np.stack([np.asarray(ql, np.float32), np.asarray(qc, np.float32),
                  np.asarray(qc, np.float32)])
    return torch.from_numpy(q).to(device)


def _fixed_order_dct(blocks: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """(…, 8, 8) blocks → C·X·Cᵀ as two fixed-order 8-term sums.

    Row pass ``T[i,k] = Σ_j C[i,j]·X[j,k]`` and column pass
    ``Y[i,l] = Σ_k T[i,k]·C[l,k]``, each accumulated j (or k) = 0..7 from
    the first product on — one rounding per multiply and per add, as the
    CUDA kernel does with ``__fmul_rn``/``__fadd_rn``.
    """
    t = C[:, 0, None] * blocks[..., 0, None, :]
    for j in range(1, 8):
        t = t + C[:, j, None] * blocks[..., j, None, :]
    y = t[..., :, 0, None] * C[:, 0]
    for k in range(1, 8):
        y = y + t[..., :, k, None] * C[:, k]
    return y


def jpeg_quotient_ref(tiles, qluma=None, qchroma=None) -> torch.Tensor:
    """(N, 3, T, T) RGB → (N, 3, T, T) float32 ``DCT(YCbCr) / Q``.

    The unrounded quotient of the forward transform; :func:`jpeg_transform_ref`
    rounds it. Tests and ``chip_smoke.py`` read it to tell a rounding tie
    (a quotient within 1e-5 of ``k + 0.5``) from a real disagreement.
    """
    x = tiles.to(torch.float32)
    N, _, H, W = x.shape
    C = torch.from_numpy(dct_matrix()).to(x.device)
    q = quant_tables(qluma, qchroma, x.device)
    planes = torch.stack(ycbcr_polynomials(x[:, 0], x[:, 1], x[:, 2]), 1)
    blocks = planes.reshape(N, 3, H // 8, 8, W // 8, 8).transpose(3, 4)
    y = _fixed_order_dct(blocks, C) / q[None, :, None, None]
    return y.transpose(3, 4).reshape(N, 3, H, W)


def jpeg_transform_ref(tiles, qluma=None, qchroma=None) -> torch.Tensor:
    """Plain version of the fused whole-level JPEG transform kernel.

    tiles: (N, 3, T, T) RGB (uint8 values, any dtype) → (N, 3, T, T) int32
    quantized YCbCr DCT coefficients, blocks in place. ``torch.round``
    rounds half to even, like ``jnp.round`` and the kernel's ``rintf``.
    """
    return torch.round(jpeg_quotient_ref(tiles, qluma, qchroma)).to(
        torch.int32)


def downsample2x2_ref(img) -> torch.Tensor:
    """2×2 box mean, stride 2: (C, H, W) → (C, H//2, W//2) float32.

    The four taps are summed in the JAX reference's order; an odd last row
    or column is dropped.
    """
    x = img.to(torch.float32)
    _, H, W = x.shape
    x = x[:, : H - H % 2, : W - W % 2]
    return 0.25 * (x[:, 0::2, 0::2] + x[:, 1::2, 0::2]
                   + x[:, 0::2, 1::2] + x[:, 1::2, 1::2])


def downsample2x2_q_ref(img) -> torch.Tensor:
    """The pyramid step: ``clip(round(downsample2x2(img)), 0, 255)``.

    The values stay exact integers (u8 range) in float32, which is what the
    next level's transform expects.
    """
    return torch.clamp(torch.round(downsample2x2_ref(img)), 0, 255)
