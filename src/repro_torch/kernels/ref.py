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
  float32 cosine, and quantization is ``round_half_even(y / q)``;
* the inverse transform mirrors all three: dequantize, the row pass
  ``T = Cᵀ·X`` and the column pass ``Y = T·C`` as fixed-order 8-term sums,
  then the inverse polynomials (:func:`ycbcr_inverse_polynomials`) and
  ``clip(round_half_even(·), 0, 255)``.

The JAX reference sums the DCT in an order its backend picks, so on
adversarial content (uniform noise) a last-ULP difference can flip a
quotient that sits exactly at a rounding tie: measured 2 coefficients in
12.58M off by ±1, each at ``|frac(y/q)| − 0.5`` below 1e-6 (ROADMAP,
Queue C). The inverse transform has the same hazard at the pixel round
(no summation order reproduces XLA's float iDCT bit for bit): on the
coefficients of uniform noise a few samples in 10⁵ sit within ~3e-5 of a
.5 tie and come out ±1; on slide content the two agree exactly.

:func:`entropy_decode_ref` is the plain version of the one integer kernel,
the Huffman decoder: a lockstep transliteration of
``repro.wsi.entropy_jax._lockstep`` that advances every tile's scan by one
symbol per step, keeps each lane's first failure, and writes the
coefficients in place exactly as the per-lane CUDA kernel does.

:func:`wkv_chunked_ref` is the plain version of the one float kernel that
is not bit-exact, RWKV6's chunked wkv: a transcription of
``repro.models.rwkv6.wkv_chunked`` (sub-block factored, every decay
``exp(Δ)`` with Δ ≤ 0). The CUDA kernel evaluates the same function in
another order of sums (chunks of 64 with a zero-padded tail, the state
carried between them by a scan, the products on the tensor cores in
3×TF32), so the two agree to the reference's own bound,
``max|Δ| / (max|ref| + 1) < 5e-4``, not bit for bit.
:func:`wkv_chunk_passes_ref` mirrors the kernel's own decomposition, pass
by pass (per-chunk state increments, the state scan, the outputs), so its
chunk indexing, tail and state hand-off are checked on the CPU.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch import sharding as shd

__all__ = [
    "JPEG_LUMA_Q", "JPEG_CHROMA_Q", "ZIGZAG", "dct_matrix",
    "ycbcr_polynomials", "ycbcr_inverse_polynomials", "quant_tables",
    "rgb2ycbcr_ref", "dct8x8_quant_ref", "jpeg_quotient_ref",
    "jpeg_transform_ref", "idct8x8_dequant_ref", "idct_dequant_blocks",
    "jpeg_inverse_ref",
    "downsample2x2_ref", "downsample2x2_q_ref", "entropy_decode_ref",
    "entropy_decode_subseq_ref", "ERR_INVALID", "ERR_RUN", "ERR_TRUNC",
    "wkv_chunked_ref", "wkv_chunk_passes_ref",
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


#: zigzag scan order: slot z of a block's symbol stream holds the
#: coefficient at row-major position ``ZIGZAG[z]`` of its 8×8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
])


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


def ycbcr_inverse_polynomials(y, cb, cr):
    """The single copy of the inverse (level-unshifted) YCbCr→RGB polynomials.

    Same expressions, same order, as
    ``repro.kernels.ref.ycbcr_inverse_polynomials``;
    ``csrc/jpeg_inverse.cu`` restates these terms one for one.
    """
    y = y + 128.0
    r = y + 1.402 * cr
    g = y - 0.344136 * cb - 0.714136 * cr
    b = y + 1.772 * cb
    return r, g, b


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


def _blocks(planes: torch.Tensor) -> torch.Tensor:
    """(…, H, W) → (…, H/8, W/8, 8, 8) blocks (a view)."""
    *lead, H, W = planes.shape
    return planes.reshape(*lead, H // 8, 8, W // 8, 8).transpose(-3, -2)


def _unblocks(blocks: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`_blocks`: (…, bh, bw, 8, 8) → (…, H, W)."""
    *lead, bh, bw, _, _ = blocks.shape
    return blocks.transpose(-3, -2).reshape(*lead, bh * 8, bw * 8)


def rgb2ycbcr_ref(img) -> torch.Tensor:
    """(3, H, W) RGB → (3, H, W) float32 level-shifted Y, Cb, Cr planes."""
    x = img.to(torch.float32)
    return torch.stack(ycbcr_polynomials(x[0], x[1], x[2]))


def dct8x8_quant_ref(plane, qtable=None) -> torch.Tensor:
    """(H, W) level-shifted plane → (H, W) int32 ``round(DCT(X) / Q)``.

    Blocks in place; the per-tile path's transform. Same fixed-order DCT as
    :func:`jpeg_transform_ref`, so a tile's per-tile coefficients equal its
    batched ones bit for bit. ``qtable`` defaults to the luma table.
    """
    x = plane.to(torch.float32)
    C = torch.from_numpy(dct_matrix()).to(x.device)
    q = torch.from_numpy(np.array(  # a writable copy of any table
        JPEG_LUMA_Q if qtable is None else qtable, np.float32)).to(x.device)
    return torch.round(_unblocks(_fixed_order_dct(_blocks(x), C) / q)).to(
        torch.int32)


def jpeg_quotient_ref(tiles, qluma=None, qchroma=None) -> torch.Tensor:
    """(N, 3, T, T) RGB → (N, 3, T, T) float32 ``DCT(YCbCr) / Q``.

    The unrounded quotient of the forward transform; :func:`jpeg_transform_ref`
    rounds it. Tests and ``chip_smoke.py`` read it to tell a rounding tie
    (a quotient within 1e-5 of ``k + 0.5``) from a real disagreement.
    """
    x = tiles.to(torch.float32)
    C = torch.from_numpy(dct_matrix()).to(x.device)
    q = quant_tables(qluma, qchroma, x.device)
    planes = torch.stack(ycbcr_polynomials(x[:, 0], x[:, 1], x[:, 2]), 1)
    y = _fixed_order_dct(_blocks(planes), C) / q[None, :, None, None]
    return _unblocks(y)


def jpeg_transform_ref(tiles, qluma=None, qchroma=None) -> torch.Tensor:
    """Plain version of the fused whole-level JPEG transform kernel.

    tiles: (N, 3, T, T) RGB (uint8 values, any dtype) → (N, 3, T, T) int32
    quantized YCbCr DCT coefficients, blocks in place. ``torch.round``
    rounds half to even, like ``jnp.round`` and the kernel's ``rintf``.
    """
    return torch.round(jpeg_quotient_ref(tiles, qluma, qchroma)).to(
        torch.int32)


def idct8x8_dequant_ref(coef, qtable) -> torch.Tensor:
    """(H, W) quantized coefficients, blocks in place → (H, W) float32
    level-shifted samples: the inverse of :func:`dct8x8_quant_ref` (the
    decoder path and PSNR tests), in :func:`idct_dequant_blocks`'s fixed
    order. ``qtable`` is the (8, 8) table the plane was quantized with."""
    C = torch.from_numpy(dct_matrix()).to(coef.device)
    q = torch.as_tensor(np.array(qtable, np.float32)).to(coef.device)
    return _unblocks(idct_dequant_blocks(_blocks(coef), q, C))


def idct_dequant_blocks(xb, q, C) -> torch.Tensor:
    """(…, 8, 8) quantized blocks → (…, 8, 8) spatial samples (float32).

    Dequantize (``X·Q``, exact for in-range coefficients), then the row
    pass ``T[i,k] = Σ_j C[j,i]·X[j,k]`` and the column pass
    ``Y[i,l] = Σ_k T[i,k]·C[k,l]``, each accumulated from the first product
    on, j (or k) = 0..7 — the loop ``csrc/jpeg_inverse.cu`` runs.
    """
    x = xb.to(torch.float32) * q
    t = C[0, :, None] * x[..., 0, None, :]
    for j in range(1, 8):
        t = t + C[j, :, None] * x[..., j, None, :]
    y = t[..., :, 0, None] * C[0, :]
    for k in range(1, 8):
        y = y + t[..., :, k, None] * C[k, :]
    return y


def jpeg_inverse_ref(coef, qluma=None, qchroma=None) -> torch.Tensor:
    """Plain version of the fused whole-level inverse JPEG transform kernel.

    coef: (N, 3, H, W) int quantized YCbCr DCT coefficients, blocks in place
    → (N, 3, H, W) uint8 RGB: per-channel dequantize + iDCT, the inverse
    polynomials, ``clip(round(·), 0, 255)``.
    """
    C = torch.from_numpy(dct_matrix()).to(coef.device)
    q = quant_tables(qluma, qchroma, coef.device)
    y = _unblocks(idct_dequant_blocks(_blocks(coef), q[None, :, None, None],
                                      C))
    rgb = torch.stack(ycbcr_inverse_polynomials(y[:, 0], y[:, 1], y[:, 2]),
                      1)
    return torch.clamp(torch.round(rgb), 0, 255).to(torch.uint8)


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


#: an entropy-decode lane's error kinds, in the reference's raise priority
#: (the lowest kind wins among lanes failing at the same symbol step)
ERR_INVALID, ERR_RUN, ERR_TRUNC = 1, 2, 3


class _Symbol(NamedTuple):
    """One Huffman symbol per lane, decoded at the lane's state."""
    v: torch.Tensor         # its value: the DC difference or the AC value
    pos: torch.Tensor       # the bit after it
    k: torch.Tensor         # the next zigzag slot (0: the unit is done)
    slot: torch.Tensor      # the zigzag slot it writes (a DC symbol: 0)
    is_dc: torch.Tensor
    is_coef: torch.Tensor   # an AC value (not EOB, not ZRL)
    adv: torch.Tensor       # it completes its unit
    bad_code: torch.Tensor  # no code starts with these bits
    bad_run: torch.Tensor   # an AC run past the block's end


def _decode_symbol(buf, base, lut, pos, comp, k, live) -> _Symbol:
    """The symbol at bit ``pos`` of each lane's scan (byte offset ``base``
    in ``buf``), decoded with the table of the lane's component ``comp``
    and zigzag slot ``k`` (0: a DC symbol is next). int32 throughout, with
    3-byte windows; lanes that are not ``live`` read their scan's first
    bytes and are to be masked off by the caller."""
    def window(p):  # 24 bits from the byte of each live cursor p
        i = base + (torch.where(live, p, 0) >> 3)
        return (buf[i] << 16) | (buf[i + 1] << 8) | buf[i + 2]

    is_dc = k == 0
    code = (window(pos) >> (8 - (pos & 7))) & 0xFFFF
    e = lut[(torch.where(is_dc, 0, 2) + (comp != 0)) * 65536 + code]
    sym, ln = e & 0xFF, e >> 8
    s = torch.where(is_dc, sym, sym & 0xF)
    pos2 = pos + ln
    ext = (1 << s) - 1
    bits = (window(pos2) >> (24 - (pos2 & 7) - s)) & ext
    v = torch.where(bits >= (1 << s) >> 1, bits, bits - ext)
    is_eob = ~is_dc & (sym == 0x00)
    is_zrl = ~is_dc & (sym == 0xF0)
    is_coef = ~(is_dc | is_eob | is_zrl)
    knew = k + (sym >> 4)
    bad_code = ln == 0
    k2 = torch.where(is_dc, 1, torch.where(
        is_zrl, k + 16, torch.where(is_coef, knew + 1, k)))
    adv = is_eob | (k2 >= 64)
    return _Symbol(v, pos2 + s, torch.where(adv, 0, k2),
                   torch.where(is_dc, 0, knew.clamp(0, 63)), is_dc, is_coef,
                   adv, bad_code, ~bad_code & is_coef & (knew > 63))


def entropy_decode_ref(buf, offs, nbits, lut, H: int, W: int):
    """Plain version of the Huffman decode kernel (baseline, 4:4:4).

    buf: (B,) uint8 — every tile's unstuffed scan followed by at least 8
    zero guard bytes; offs: (N,) int64 byte offset of each tile's scan;
    nbits: (N,) int32 scan length in bits; lut: (4·65536,) int16 16-bit
    lookahead tables [dc-luma, dc-chroma, ac-luma, ac-chroma], each entry
    ``symbol | code_length << 8`` (length 0: no code starts with these
    bits). Returns ``(coef, stop, err_kind)``: (N, 3, H, W) int32
    coefficients, blocks in place, DC integrated per component; for each
    lane the index of the symbol at which it stopped — its last symbol, or
    the one at which it first failed; and the kind of that failure
    (``ERR_*``, 0 for none). Coefficients from a failure on are zero.

    The lockstep of ``repro.wsi.entropy_jax._lockstep``, in int32 with 3-byte
    windows: step s decodes the s-th symbol of every live lane. A lane
    stops at its first failure and the others run on, so each lane's
    result is what it is alone — what the CUDA kernel computes, one CTA
    per lane (:func:`entropy_decode_subseq_ref` mirrors how).
    """
    dev = buf.device
    N = offs.numel()
    nu = (H // 8) * (W // 8) * 3
    plane = H * W
    flat = torch.zeros(N * 3 * plane + 1, dtype=torch.int32, device=dev)
    stop = torch.full((N,), -1, dtype=torch.int32, device=dev)
    err_kind = torch.zeros(N, dtype=torch.int32, device=dev)
    coef = flat[:-1].view(N, 3, H, W)
    if N == 0 or nu == 0:
        return coef, stop, err_kind

    dump = N * 3 * plane  # where masked-off lanes write (sliced away)
    lut = lut.to(torch.int32)
    nat = torch.from_numpy(ZIGZAG).to(dev)
    buf = buf.to(torch.int32)
    base = torch.arange(N, device=dev) * (3 * plane)
    pos = torch.zeros(N, dtype=torch.int32, device=dev)
    u = torch.zeros_like(pos)
    k = torch.zeros_like(pos)
    pred = torch.zeros((N, 3), dtype=torch.int32, device=dev)
    live = torch.ones(N, dtype=torch.bool, device=dev)

    step = 0
    while True:
        comp = u % 3
        d = _decode_symbol(buf, offs, lut, pos, comp, k, live)
        bad_code = live & d.bad_code
        bad_run = live & d.bad_run
        err_kind = torch.where(bad_code, ERR_INVALID,
                               torch.where(bad_run, ERR_RUN, err_kind))
        ok = live & ~(bad_code | bad_run)
        pos = torch.where(ok, d.pos, pos)

        # the DC predictor of the lane's component, then one scatter
        old = pred.gather(1, comp[:, None].long())[:, 0]
        dc = torch.where(ok & d.is_dc, old + d.v, old)
        pred.scatter_(1, comp[:, None].long(), dc[:, None])
        slot = nat[d.slot]
        blk = u // 3
        addr = (base + comp.long() * plane
                + ((blk // (W // 8)) * 8 + slot // 8) * W
                + (blk % (W // 8)) * 8 + slot % 8)
        write = ok & (d.is_dc | d.is_coef)
        flat[torch.where(write, addr, dump)] = torch.where(d.is_dc, dc, d.v)

        k = torch.where(ok, d.k, k)
        u = u + (ok & d.adv).to(torch.int32)
        trunc = ok & (u < nu) & (pos > nbits)
        err_kind = torch.where(trunc, ERR_TRUNC, err_kind)
        stop = torch.where(live & ~(ok & (u < nu) & ~trunc), step, stop)
        live = ok & (u < nu) & ~trunc
        step += 1
        if step % 16 == 0 and not bool(live.any()):
            return coef, stop, err_kind


#: what the mirror leaves in a coefficient that no lane wrote (every one is
#: written, so the value never survives; a test would see it if one did)
_UNWRITTEN = -2 ** 31


def entropy_decode_subseq_ref(buf, offs, nbits, lut, H: int, W: int,
                              threads: int):
    """Plain mirror of the ``entropy_decode`` kernel's design: one CTA of
    ``threads`` threads per tile, self-synchronising subsequences.

    Same arguments and results as :func:`entropy_decode_ref`, plus
    ``rounds`` (N,) int32, the sync rounds each tile took. Vectorised over
    (tile, subsequence) lanes, lane j standing for thread j:

    1. a tile's ``nbits`` bits are cut into ranges of L bits, L the least
       multiple of 32 (≥ 32) with ``threads`` · L ≥ nbits; J = ⌈nbits/L⌉
       (≥ 1) ranges are used, the last one ending past ``nbits`` (its
       decoder stops at the first symbol that ends beyond the scan). A
       decoder's state at a symbol boundary is (bit, comp, k); entry j is
       guessed (j·L, 0, 0), entry 0 is true;
    2. sync rounds: every lane whose entry changed decodes from it to the
       first boundary at or past its range's end and hands that state to
       the next lane as its entry; an invalid code or a run past the block
       hands nothing on. Rounds repeat until no entry changes; after round
       r entries 0..r+1 are true, so a tile takes at most J rounds;
    3. each lane's last decode counted its symbols, completed units, DC
       symbols, DC differences per component (int32, wrapping as the
       reference's predictor does) and its first failure (local symbol
       index, units and slot at it, kind; a truncation is the first symbol
       ending past ``nbits``). An exclusive scan over the lanes gives each
       range's first global symbol, first unit and DC predictors; the first
       range in which the tile ends (a failure below unit ``nu``, or its
       ``nu``-th unit) fixes ``stop``, ``err_kind``, the units started
       ``u_z`` and the last symbol that is applied;
    4. dense write: a lane owns the units whose DC symbol lies in its range
       (ranges up to the ending one). It skips the symbols that finish the
       previous owner's unit, builds each owned unit in a 64-entry buffer —
       the last one past its range's end, a failing one as far as the
       reference wrote it — and writes the whole 8×8 block once; units from
       ``u_z`` on are written as zero blocks.

    Nothing on the main path calls it: the tests hold it to
    :func:`entropy_decode_ref` on the CPU and ``chip_smoke.py`` holds the
    kernel's rounds to it.
    """
    dev = buf.device
    N, T = offs.numel(), threads
    bw = W // 8
    nu = (H // 8) * bw * 3
    coef = torch.full((N, 3, H, W), _UNWRITTEN, dtype=torch.int32,
                      device=dev)
    stop = torch.full((N,), -1, dtype=torch.int32, device=dev)
    err_kind = torch.zeros(N, dtype=torch.int32, device=dev)
    rounds = torch.zeros(N, dtype=torch.int32, device=dev)
    if N == 0:
        return coef, stop, err_kind, rounds

    lut = lut.to(torch.int32)
    buf = buf.to(torch.int32)
    nat = torch.from_numpy(ZIGZAG).to(dev)
    nbits = nbits.to(torch.int32)
    # 1. lanes (tile, subsequence), tile-major
    tile = torch.arange(N, device=dev).repeat_interleave(T)
    j = torch.arange(T, dtype=torch.int32, device=dev).repeat(N)
    L = 32 * torch.clamp((nbits + 32 * T - 1) // (32 * T), min=1)
    J = torch.clamp((nbits + L - 1) // L, min=1)
    base, nb, Lm, Jm = offs[tile], nbits[tile], L[tile], J[tile]
    lane = j < Jm
    end = torch.where(j == Jm - 1, nb + 1, (j + 1) * Lm)
    e_pos, e_comp, e_k = j * Lm, torch.zeros_like(j), torch.zeros_like(j)
    zero = torch.zeros_like(j)
    nsym, adv, ndc = zero.clone(), zero.clone(), zero.clone()
    f_i, f_a, f_k, f_kind = zero.clone(), zero.clone(), zero.clone(), \
        zero.clone()
    dcs = torch.zeros((N * T, 3), dtype=torch.int32, device=dev)
    comps = torch.arange(3, device=dev)

    def decode(todo):
        """Each todo lane from its entry to the first symbol boundary at or
        past its range's end: that boundary's state and the counts."""
        pos, comp, k = e_pos, e_comp, e_k
        for t in (nsym, adv, ndc, f_kind):
            t.masked_fill_(todo, 0)
        dcs.masked_fill_(todo[:, None], 0)
        live = todo & (pos < end)
        while bool(live.any()):
            d = _decode_symbol(buf, base, lut, pos, comp, k, live)
            bad = live & (d.bad_code | d.bad_run)
            if bool(bad.any()):
                kind = torch.where(d.bad_code, ERR_INVALID, ERR_RUN)
                for t, val in ((f_i, nsym), (f_a, adv), (f_k, k),
                               (f_kind, kind)):
                    t.copy_(torch.where(bad, val, t))
            ok = live & ~bad
            dc = ok & d.is_dc
            dcs.add_(torch.where(dc[:, None] & (comp[:, None] == comps),
                                 d.v[:, None], 0).to(torch.int32))
            ndc.add_(dc.to(torch.int32))
            nsym.add_(ok.to(torch.int32))
            a = ok & d.adv
            adv.add_(a.to(torch.int32))
            comp = torch.where(a, (comp + 1) % 3, comp)
            k = torch.where(ok, d.k, k)
            pos = torch.where(ok, d.pos, pos)
            trunc = ok & (pos > nb)
            if bool(trunc.any()):
                for t, val in ((f_i, nsym - 1), (f_a, adv), (f_k, k),
                               (f_kind, torch.full_like(j, ERR_TRUNC))):
                    t.copy_(torch.where(trunc, val, t))
            live = ok & (pos < end)
        handed = todo & ((f_kind == 0) | (f_kind == ERR_TRUNC))
        return pos, comp, k, handed

    # 2. sync rounds
    todo = lane.clone()
    while True:
        rounds += todo.view(N, T).any(1).to(torch.int32)
        x_pos, x_comp, x_k, handed = decode(todo)
        x_pos, x_comp, x_k, handed = (torch.roll(t, 1) for t in (
            x_pos, x_comp, x_k, handed))
        todo = lane & (j > 0) & handed & (
            (x_pos != e_pos) | (x_comp != e_comp) | (x_k != e_k))
        if not bool(todo.any()):
            break
        e_pos, e_comp, e_k = (torch.where(todo, x, e) for x, e in (
            (x_pos, e_pos), (x_comp, e_comp), (x_k, e_k)))

    # 3. the scan over each tile's ranges, and the tile's outcome
    def exclusive(x):
        x = torch.where(lane.view(N, T, *([1] * (x.dim() - 1))),
                        x.view(N, T, *x.shape[1:]).long(), 0)
        return (torch.cumsum(x, 1) - x).reshape(N * T, *x.shape[2:])

    s0, u0 = exclusive(nsym), exclusive(adv)
    p0 = exclusive(dcs).to(torch.int32)  # wraps as int32, like pred += v
    fail_end = lane & (f_kind > 0) & (u0 + f_a < nu)
    ends = (fail_end | (lane & (u0 + adv >= nu))).view(N, T)
    assert bool(ends.any(1).all()), "a tile's decode has no end"
    j_end = ends.to(torch.int8).argmax(1)
    me = torch.arange(N, device=dev) * T + j_end
    failed = fail_end[me]
    fail_stop = s0[me] + f_i[me]
    err_kind = torch.where(failed, f_kind[me], 0).to(torch.int32)
    u_z = torch.where(failed, u0[me] + f_a[me] + (f_k[me] != 0).long(), nu)
    # symbols from this global index on are not applied
    limit = torch.where(failed, fail_stop + (err_kind == ERR_TRUNC).long(),
                        torch.iinfo(torch.int64).max)

    # 4. the dense write
    blocks = coef.view(N, 3, H // 8, 8, bw, 8)

    def put(mask, unit, values):
        m = mask.nonzero()[:, 0]
        b = unit[m] // 3
        blocks[tile[m], unit[m] % 3, b // bw, :, b % bw, :] = \
            values[m].view(-1, 8, 8)

    first = u0 + (e_k != 0).long()
    n_own = torch.where(lane & (j <= j_end[tile]), torch.clamp(torch.minimum(
        ndc.long(), u_z[tile] - first), min=0), 0)
    pos, comp, k, g = e_pos, e_comp, e_k, s0
    pred = p0.clone()
    skip = k != 0  # the symbols that finish the previous owner's unit
    unit, done = first, torch.zeros_like(first)
    unit_buf = torch.zeros((N * T, 64), dtype=torch.int32, device=dev)
    clean_stop = torch.full((N,), -1, dtype=torch.int64, device=dev)
    live = n_own > 0
    lim = limit[tile]
    while bool(live.any()):
        at_limit = live & (g >= lim)  # a failing unit, as far as it went
        assert bool((~at_limit | (~skip & (k != 0))).all())
        put(at_limit, unit, unit_buf)
        live = live & ~at_limit
        d = _decode_symbol(buf, base, lut, pos, comp, k, live)
        assert not bool((live & (d.bad_code | d.bad_run)).any())
        w = live & ~skip
        dc = w & d.is_dc
        pred = torch.where(dc[:, None] & (comp[:, None] == comps),
                           pred + d.v[:, None], pred)
        val = torch.where(d.is_dc, pred.gather(1, comp[:, None].long())[:, 0],
                          d.v)
        wr = (w & (d.is_dc | d.is_coef)).nonzero()[:, 0]
        unit_buf[wr, nat[d.slot[wr]].long()] = val[wr]
        a = live & d.adv
        full = a & ~skip
        put(full, unit, unit_buf)
        unit_buf[full] = 0
        last = full & (unit == nu - 1)
        clean_stop[tile[last]] = g[last]
        unit = unit + full.long()
        done = done + full.long()
        skip = skip & ~a
        comp = torch.where(a, (comp + 1) % 3, comp)
        k = torch.where(live, d.k, k)
        pos = torch.where(live, d.pos, pos)
        g = g + live.long()
        live = live & (done < n_own)
    units = torch.arange(nu, device=dev)
    zn, zu = (units[None] >= u_z[:, None]).nonzero(as_tuple=True)
    blocks[zn, zu % 3, (zu // 3) // bw, :, (zu // 3) % bw, :] = 0
    stop = torch.where(failed, fail_stop, clean_stop).to(torch.int32)
    return coef, stop, err_kind, rounds


def wkv_chunked_ref(r, k, v, logw, u, state, chunk: int = 64, sub: int = 16):
    """RWKV6's chunked wkv: ``(out (B, S, H, K), final_state (B, H, K, K))``.

    All float32. r/k/v/logw: (B, S, H, K); u: (H, K); state: (B, H, K, V=K).
    A transcription of ``repro.models.rwkv6.wkv_chunked``, its fallbacks
    included: the chunk is the whole sequence (``Q = S``) when ``S % chunk``,
    and the sub-block the whole chunk when ``Q % sub`` (so a length that is
    not a multiple of ``chunk`` builds a (B, 1, S, S, H, K) tensor). The
    decay from position s to a later t is factored through the boundary of
    t's sub-block, so every exponent is ≤ 0.
    """
    B, S, H, K = r.shape
    Q = min(chunk, S)
    if S % Q:
        Q = S
    q = min(sub, Q)
    if Q % q:
        q = Q
    ns = Q // q
    dev = r.device
    smask = (torch.arange(Q, device=dev)[None, :]
             < (torch.arange(ns, device=dev) * q)[:, None])  # (ns, Q)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev), -1)
    outs = []
    for c0 in range(0, S, Q):
        rc, kc, vc, lw = (t[:, c0:c0 + Q] for t in (r, k, v, logw))
        rc = shd.constrain(rc, "batch", "", "", "")
        kc = shd.constrain(kc, "batch", "", "", "")
        L = torch.cumsum(lw, dim=1)  # inclusive log-decay
        Lex = L - lw  # exclusive
        Lend = L[:, -1]  # (B, H, K)

        # inter-chunk: the carried state projected onto every position
        out = torch.einsum("bqhk,bhkv->bqhv", rc * torch.exp(Lex), state)

        # cross-sub-block (within the chunk), boundary-factored
        Lb = torch.cat([torch.zeros((B, 1, H, K), dtype=L.dtype, device=dev),
                        L[:, q - 1::q][:, :ns - 1]], dim=1)  # (B, ns, H, K)
        rg = rc.reshape(B, ns, q, H, K)
        Lexg = Lex.reshape(B, ns, q, H, K)
        r2 = rg * torch.exp(torch.clamp(Lexg - Lb[:, :, None], max=0.0))
        k2 = kc[:, None] * torch.exp(
            torch.clamp(Lb[:, :, None] - L[:, None], max=0.0))  # (B,ns,Q,H,K)
        att_x = torch.einsum("bjthk,bjshk->bjhts", r2, k2)
        att_x = att_x * smask[None, :, None, None, :]
        out_x = torch.einsum("bjhts,bshv->bjthv", att_x, vc)
        out = out + out_x.reshape(B, Q, H, K)

        # diagonal sub-blocks: explicit log-difference (t, s in one block)
        kg = kc.reshape(B, ns, q, H, K)
        vg = vc.reshape(B, ns, q, H, K)
        Lg = L.reshape(B, ns, q, H, K)
        Ldiff = torch.clamp(Lexg[:, :, :, None] - Lg[:, :, None], max=0.0)
        dec = torch.where(tri[None, None, :, :, None, None], torch.exp(Ldiff),
                          0.0)  # (B, ns, t, s, H, K)
        att_d = torch.einsum("bjthk,bjshk,bjtshk->bjhts", rg, kg, dec)
        out_d = torch.einsum("bjhts,bjshv->bjthv", att_d, vg)
        # the u bonus on the diagonal (s == t)
        out_u = (rg * u[None, None, None] * kg).sum(-1, keepdim=True) * vg
        out = out + (out_d + out_u).reshape(B, Q, H, K)

        # state update
        kdec = kc * torch.exp(torch.clamp(Lend[:, None] - L, max=0.0))
        state = state * torch.exp(Lend)[..., None] + torch.einsum(
            "bqhk,bqhv->bhkv", kdec, vc)
        outs.append(out)
    return torch.cat(outs, dim=1), state


def wkv_chunk_passes_ref(r, k, v, logw, u, state, chunk: int = 64,
                         sub: int = 16) -> dict:
    """The CUDA kernel's passes over RWKV6's chunked wkv, in plain torch.

    Same inputs as :func:`wkv_chunked_ref`. The sequence is cut into
    ``nc = ceil(S / chunk)`` chunks, the tail zero-padded (r = k = v = 0,
    logw = 0: it neither decays the state nor adds to it). Per chunk c, L
    is the inclusive log-decay prefix sum, ``Lex[t] = L[t - 1]`` (0 at
    t = 0) the exclusive one, ``Lend = L[chunk - 1]``:

    1. ``dS[c] = (k ⊙ exp(Lend − L))ᵀ v`` and ``decay[c] = exp(Lend)``;
    2. the scan, the only step in chunk order: ``s_in[c] = S_{c−1}``,
       ``S_c = decay[c] ⊙ S_{c−1} + dS[c]`` (per row of the state);
    3. ``out_c = A v + (r ⊙ exp(Lex)) s_in[c]``, with A lower-triangular:
       below the diagonal sub-blocks ``r exp(Lex − Lb) · k exp(Lb − L)``
       factored through the start ``Lb`` of t's sub-block, on them the
       per-pair ``Σ r_t k_s exp(Lex_t − L_s)`` and the u bonus at s = t.

    Every exponent is clamped ≤ 0. Returns ``dict(out (B, S, H, K),
    final_state (B, H, K, K), dS (B, H, nc, K, K), decay (B, H, nc, K),
    s_in (B, H, nc, K, K))``: the kernel's outputs and its scratch.
    """
    B, S, H, K = r.shape
    nc = -(-S // chunk)
    ns = chunk // sub
    dev = r.device

    def tiles(t):  # (B, S, H, K) -> (B, H, nc, chunk, K), zero-padded
        t = torch.nn.functional.pad(t, (0, 0, 0, 0, 0, nc * chunk - S))
        return t.reshape(B, nc, chunk, H, K).permute(0, 3, 1, 2, 4)

    rc, kc, vc, lw = (tiles(t) for t in (r, k, v, logw))
    L = torch.cumsum(lw, dim=3)
    Lex = torch.cat([torch.zeros_like(L[..., :1, :]), L[..., :-1, :]], dim=3)
    Lend = L[..., -1, :]  # (B, H, nc, K)

    # pass 1: each chunk's state increment and decay
    kdec = kc * torch.exp(torch.clamp(Lend[..., None, :] - L, max=0.0))
    dS = torch.einsum("bhnsk,bhnsv->bhnkv", kdec, vc)
    decay = torch.exp(torch.clamp(Lend, max=0.0))

    # pass 2: the state scan
    s_in, s = [], state
    for c in range(nc):
        s_in.append(s)
        s = decay[:, :, c, :, None] * s + dS[:, :, c]
    s_in = torch.stack(s_in, dim=2)

    # pass 3: A (cross-sub-block entries factored through Lb, per-pair
    # decays on the diagonal sub-blocks, the u bonus), then A v + r~ s_in
    Lb = Lex[..., ::sub, :]  # (B, H, nc, ns, K)
    rg, kg, Lexg, Lg = (t.reshape(B, H, nc, ns, sub, K)
                        for t in (rc, kc, Lex, L))
    r2 = rg * torch.exp(torch.clamp(Lexg - Lb[..., None, :], max=0.0))
    k2 = kc[:, :, :, None] * torch.exp(
        torch.clamp(Lb[..., None, :] - L[:, :, :, None], max=0.0))
    smask = (torch.arange(chunk, device=dev)[None, :]
             < (torch.arange(ns, device=dev) * sub)[:, None])  # (ns, chunk)
    A = torch.einsum("bhnjtk,bhnjsk->bhnjts", r2, k2) * smask[:, None, :]
    tri = torch.tril(torch.ones((sub, sub), dtype=torch.bool, device=dev), -1)
    dec = torch.where(tri[..., None], torch.exp(torch.clamp(
        Lexg[..., :, None, :] - Lg[..., None, :, :], max=0.0)), 0.0)
    diag = torch.einsum("bhnjtk,bhnjsk,bhnjtsk->bhnjts", rg, kg, dec)
    bonus = (rg * u[None, :, None, None, None] * kg).sum(-1)
    diag = diag + torch.diag_embed(bonus)
    for j in range(ns):
        A[..., j, :, j * sub:(j + 1) * sub] = diag[..., j, :, :]
    A = A.reshape(B, H, nc, chunk, chunk)
    out = torch.einsum("bhnts,bhnsv->bhntv", A, vc) + torch.einsum(
        "bhntk,bhnkv->bhntv", rc * torch.exp(torch.clamp(Lex, max=0.0)),
        s_in)
    out = out.permute(0, 2, 3, 1, 4).reshape(B, nc * chunk, H, K)[:, :S]
    return dict(out=out, final_state=s, dS=dS, decay=decay, s_in=s_in)
