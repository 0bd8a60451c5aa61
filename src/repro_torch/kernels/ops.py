"""Public wrappers over the port's CUDA kernels: impl dispatch and launch.

``impl`` selects the backend per call:

- ``"auto"`` (default) — a CUDA tensor launches the hand-written kernel
  (``csrc/*.cu``); a CPU tensor runs the plain PyTorch version in
  ``ref.py``. The choice follows the tensor's device only: on a CUDA tensor
  the wrapper launches the kernel or raises, and never falls back. On
  either device ``auto`` takes only what the kernel takes (its dtype,
  contiguous), so a CPU run fails where the card would.
- ``"ref"`` — the plain version on whatever device the tensor is on (the
  tests and ``chip_smoke.py`` compare kernels against it).

Each wrapper counts its kernel launches in ``<wrapper>.launches`` (a plain
integer, incremented under a lock only where the kernel is launched, so
the count stays exact when several threads launch), so a run can show
that its main path went through the kernels.

Unlike ``repro.kernels.ops`` there is no power-of-two bucketing of the
batch: eager PyTorch has no jit cache to keep small, so a level of any
size is one launch at its own shape.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from repro_torch.analysis.lockdep import TrackedLock
from repro_torch.kernels import ref
from repro_torch.kernels._build import library

__all__ = ["jpeg_transform", "downsample2x2", "jpeg_inverse", "rgb2ycbcr",
           "dct8x8_quant", "entropy_decode", "ENTROPY_THREADS",
           "wkv_chunk", "wkv_scratch_floats", "wkv_scratch_views"]


def _launches_kernel(x: torch.Tensor, name: str, ndim: int, impl: str,
                     dtype: torch.dtype = torch.float32) -> bool:
    """Whether this call launches the kernel (``auto`` on a CUDA tensor).

    For ``auto`` it first checks the kernel's input contract on any device.
    """
    if impl == "ref":
        return False
    if impl != "auto":
        raise ValueError(f"impl must be 'auto' or 'ref': {impl!r}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: the CUDA kernel takes {dtype}, got "
                        f"{x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name}: expected a {ndim}-d tensor, got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: the CUDA kernel takes a contiguous tensor")
    return x.is_cuda


def _check_blocks(x: torch.Tensor, name: str, what: str) -> None:
    """(N, 3, H, W) with H and W multiples of 8."""
    if x.dim() != 4 or x.shape[1] != 3 or x.shape[2] % 8 or x.shape[3] % 8:
        raise ValueError(f"{name}: expected (N, 3, H, W) {what} with H, W "
                         f"multiples of 8, got {tuple(x.shape)}")


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


# The kernels' by-value host operands, built once so that a call's host
# work is its launch (the per-tile path calls these kernels per tile).
@lru_cache(maxsize=None)
def _host_default_tables() -> np.ndarray:
    """The (3, 8, 8) Annex-K tables for Y, Cb and Cr."""
    return _frozen(ref.quant_tables(None, None, "cpu").numpy().copy())


@lru_cache(maxsize=None)
def _host_zigzag() -> np.ndarray:
    return _frozen(np.array(ref.ZIGZAG, np.int64))


def _host_tables(qluma, qchroma) -> np.ndarray:
    if qluma is None and qchroma is None:
        return _host_default_tables()
    return ref.quant_tables(qluma, qchroma, "cpu").numpy()


def _host_table(qtable) -> np.ndarray:
    """``dct8x8_quant``'s table as the (8, 8) float32 array the kernel
    reads (64 floats, row-major): ``None`` is the Annex-K luma plane of
    ``_host_default_tables``; a contiguous float32 table, such as the
    ``ref`` tables the per-tile path passes, is used as it is; any other is
    converted."""
    if qtable is None:
        return _host_default_tables()[0]
    q = np.ascontiguousarray(qtable, np.float32)
    if q.shape != (8, 8):
        raise ValueError(f"dct8x8_quant: qtable must be (8, 8), got "
                         f"{q.shape}")
    return q


_COUNT_LOCK = TrackedLock("kernels.ops.launches")


def _count(wrapper) -> None:
    """One more launch of ``wrapper``'s kernel: the read-modify-write of
    ``wrapper.launches`` under a lock, since pipeline workers launch from
    several threads at once."""
    with _COUNT_LOCK:
        wrapper.launches += 1


def _launch(name: str, t: torch.Tensor, *args) -> None:
    """Call kernel ``name``'s C launcher with ``args`` and the current
    stream of ``t``'s card; raise if the launch failed.

    The launchers launch on the current device, so a tensor on another card
    switches to it for the call; when it is current (the per-tile path's
    case) the device guard's round trip is skipped, and the stream is read
    as its raw handle, without building a ``torch.cuda.Stream``."""
    dev = t.get_device()
    stream = torch._C._cuda_getCurrentRawStream(dev)
    if torch._C._cuda_getDevice() == dev:
        err = library(name)(*args, stream)
    else:
        with torch.cuda.device(dev):
            err = library(name)(*args, stream)
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
    _check_blocks(tiles, "jpeg_transform", "tiles")
    if not _launches_kernel(tiles, "jpeg_transform", 4, impl):
        return ref.jpeg_transform_ref(tiles, qluma, qchroma)
    N, _, H, W = tiles.shape
    out = torch.empty(tiles.shape, dtype=torch.int32, device=tiles.device)
    if N == 0:
        return out
    q = _host_tables(qluma, qchroma)
    _launch("jpeg_transform", tiles, tiles.data_ptr(), out.data_ptr(), N, H,
            W, q.ctypes.data)
    _count(jpeg_transform)
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
    _launch("downsample2x2", img, img.data_ptr(), out.data_ptr(), C, H, W)
    _count(downsample2x2)
    return out


downsample2x2.launches = 0


def jpeg_inverse(coef: torch.Tensor, qluma=None, qchroma=None,
                 impl: str = "auto") -> torch.Tensor:
    """(N, 3, H, W) int32 quantized YCbCr DCT coefs → (N, 3, H, W) uint8 RGB.

    The whole-level inverse dispatch: one launch decode-transforms every
    tile of a stored level (dequantize with the luma table for Y and the
    chroma table for Cb/Cr, 8×8 iDCT, YCbCr → RGB, ``clip(round(·))``).
    H and W must be multiples of 8; ``N == 0`` launches nothing.
    ``qluma``/``qchroma`` default to the Annex-K tables.
    """
    _check_blocks(coef, "jpeg_inverse", "coefficients")
    if not _launches_kernel(coef, "jpeg_inverse", 4, impl, torch.int32):
        return ref.jpeg_inverse_ref(coef, qluma, qchroma)
    N, _, H, W = coef.shape
    out = torch.empty(coef.shape, dtype=torch.uint8, device=coef.device)
    if N == 0:
        return out
    q = _host_tables(qluma, qchroma)
    _launch("jpeg_inverse", coef, coef.data_ptr(), out.data_ptr(), N, H, W,
            q.ctypes.data)
    _count(jpeg_inverse)
    return out


jpeg_inverse.launches = 0


def rgb2ycbcr(img: torch.Tensor, impl: str = "auto") -> torch.Tensor:
    """(3, H, W) RGB → (3, H, W) float32 level-shifted Y, Cb, Cr planes.

    The per-tile path's colour conversion (one launch per tile).
    """
    if img.dim() != 3 or img.shape[0] != 3:
        raise ValueError("rgb2ycbcr: expected a (3, H, W) image, got "
                         f"{tuple(img.shape)}")
    if not _launches_kernel(img, "rgb2ycbcr", 3, impl):
        return ref.rgb2ycbcr_ref(img)
    _, H, W = img.shape
    out = torch.empty_like(img)  # contiguous, as img is
    if out.numel() == 0:
        return out
    _launch("rgb2ycbcr", img, img.data_ptr(), out.data_ptr(), H, W)
    _count(rgb2ycbcr)
    return out


rgb2ycbcr.launches = 0


def dct8x8_quant(plane: torch.Tensor, qtable=None,
                 impl: str = "auto") -> torch.Tensor:
    """(H, W) float32 level-shifted plane → (H, W) int32 quantized DCT coefs.

    The per-tile path's transform, one launch per channel of a tile: 8×8
    DCT-II and ``round(y / q)``, blocks in place. H and W must be multiples
    of 8; ``qtable`` (8, 8) defaults to the Annex-K luma table.
    """
    if plane.dim() != 2 or plane.shape[0] % 8 or plane.shape[1] % 8:
        raise ValueError("dct8x8_quant: expected an (H, W) plane with H, W "
                         f"multiples of 8, got {tuple(plane.shape)}")
    q = _host_table(qtable)
    if not _launches_kernel(plane, "dct8x8_quant", 2, impl):
        return ref.dct8x8_quant_ref(plane, q)
    H, W = plane.shape
    out = torch.empty_like(plane, dtype=torch.int32)  # contiguous
    if out.numel() == 0:
        return out
    _launch("dct8x8_quant", plane, plane.data_ptr(), out.data_ptr(), H, W,
            q.ctypes.data)
    _count(dct8x8_quant)
    return out


dct8x8_quant.launches = 0


#: threads (subsequences) of the ``entropy_decode`` kernel's CTA, one CTA
#: per tile; :func:`ref.entropy_decode_subseq_ref` at this width gives the
#: kernel's sync rounds
ENTROPY_THREADS = 256


def entropy_decode(buf: torch.Tensor, offs: torch.Tensor,
                   nbits: torch.Tensor, lut: torch.Tensor, H: int, W: int,
                   impl: str = "auto", stats: torch.Tensor | None = None):
    """Huffman-decode N tile scans → ``(coef, stop, err_kind)``.

    buf (B,) uint8, offs (N,) int64, nbits (N,) int32 and lut (4·65536,)
    int16, all on one device, as :func:`ref.entropy_decode_ref` documents
    (each scan followed by at least 8 zero bytes inside buf). One launch
    decodes every tile of a level, one CTA of :data:`ENTROPY_THREADS`
    threads per tile (self-synchronising subsequences, then a dense write;
    :func:`ref.entropy_decode_subseq_ref` mirrors it), into (N, 3, H, W)
    int32 coefficients (blocks in place, DC integrated), every one written
    once by the kernel; each lane reports the index of the symbol at which
    it stopped (its last, or its first failing one) and the failure's kind
    (0 when it decoded cleanly). The caller turns those into the
    reference's error.

    ``stats``, a debug output for tests and measurements: a contiguous
    (N, 3) int32 CUDA tensor that the kernel fills with each tile's sync
    rounds, symbols decoded over all its passes and lookups that fell
    through to the 16-bit table. Only a kernel launch takes it.
    """
    if H <= 0 or W <= 0 or H % 8 or W % 8:
        raise ValueError(f"entropy_decode: tile {H}x{W} is not a positive "
                         "multiple of 8")
    for t, name, dtype in ((offs, "offs", torch.int64),
                           (nbits, "nbits", torch.int32),
                           (lut, "lut", torch.int16)):
        if t.dtype != dtype or t.dim() != 1 or t.device != buf.device:
            raise ValueError(f"entropy_decode: {name} must be a 1-d {dtype} "
                             f"tensor on {buf.device}")
    if offs.numel() != nbits.numel() or lut.numel() != 4 * 65536:
        raise ValueError("entropy_decode: offs/nbits lengths differ or the "
                         "lut is not 4 x 65536 entries")
    # every scan and its 8 guard bytes must lie inside buf: a lane reads up
    # to 8 bytes past a cursor that is still inside its scan (one read-back
    # of three numbers: a single wait on a CUDA tensor)
    if offs.numel():
        lo_off, lo_bits, hi_end = torch.stack((
            offs.min(), nbits.min().long(),
            (offs + (nbits.long() + 7) // 8 + 8).max())).tolist()
        if lo_off < 0 or lo_bits < 0 or hi_end > buf.numel():
            raise ValueError("entropy_decode: a scan and its 8 guard bytes "
                             "do not fit inside buf")
    launch = _launches_kernel(buf, "entropy_decode", 1, impl, torch.uint8)
    N = offs.numel()
    if stats is not None and (
            not launch or stats.dtype != torch.int32
            or tuple(stats.shape) != (N, 3) or not stats.is_contiguous()
            or stats.device != buf.device):
        raise ValueError(f"entropy_decode: stats must be a contiguous "
                         f"({N}, 3) int32 tensor on the card, and is only "
                         f"filled by a kernel launch")
    if not launch:
        return ref.entropy_decode_ref(buf, offs, nbits, lut, H, W)
    dev = buf.device
    coef = torch.empty((N, 3, H, W), dtype=torch.int32, device=dev)
    stop = torch.empty(N, dtype=torch.int32, device=dev)
    err_kind = torch.empty(N, dtype=torch.int32, device=dev)
    if N == 0:
        return coef, stop, err_kind
    offs, nbits, lut = (t.contiguous() for t in (offs, nbits, lut))
    if stats is not None:
        stats.zero_()
    zz = _host_zigzag()
    _launch("entropy_decode", buf, buf.data_ptr(), buf.numel(),
            offs.data_ptr(), nbits.data_ptr(), lut.data_ptr(),
            coef.data_ptr(), stop.data_ptr(), err_kind.data_ptr(),
            0 if stats is None else stats.data_ptr(), N, H, W,
            zz.ctypes.data)
    _count(entropy_decode)
    return coef, stop, err_kind


entropy_decode.launches = 0


#: head widths the wkv kernel is built for (a template instance each):
#: rwkv6-3b's 64 and the smoke config's 16
WKV_HEAD_DIMS = (16, 64)
#: positions per chunk of the wkv kernel's passes
WKV_CHUNK = 64
#: kernels one ``wkv_chunk`` call launches on a CUDA tensor
WKV_KERNELS_PER_CALL = 3


def _check_aligned(t: torch.Tensor, what: str) -> None:
    """The wkv kernel moves r, k, v, logw and its scratch in 16-byte pieces
    (``cp.async``), so their data must start on a 16-byte boundary: a
    contiguous view at an offset that is not a multiple of 4 floats would
    fault on the card and poison its context."""
    if t.data_ptr() % 16:
        raise ValueError(f"{what} must start on a 16-byte boundary (the "
                         f"kernel reads it in 16-byte pieces); this view "
                         f"starts {t.data_ptr() % 16} bytes past one")


def wkv_scratch_floats(B: int, S: int, H: int, K: int) -> int:
    """Floats of scratch a ``wkv_chunk`` kernel call uses: per (b, h) and
    chunk the state increment dS and the state handed in S_{c−1} (K × K
    each) and the chunk's decay exp(Lend) (K)."""
    nc = -(-S // WKV_CHUNK)
    return B * H * nc * K * (2 * K + 1)


def wkv_scratch_views(scratch: torch.Tensor, B: int, S: int, H: int,
                      K: int) -> dict:
    """The kernel's scratch as ``dS`` and ``s_in`` (B, H, nc, K, K) and
    ``decay`` (B, H, nc, K), the layout of
    :func:`ref.wkv_chunk_passes_ref`'s results of the same names."""
    nc = -(-S // WKV_CHUNK)
    n = B * H * nc * K * K
    return dict(dS=scratch[:n].view(B, H, nc, K, K),
                s_in=scratch[n:2 * n].view(B, H, nc, K, K),
                decay=scratch[2 * n:2 * n + B * H * nc * K].view(B, H, nc, K))


def wkv_chunk(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              logw: torch.Tensor, u: torch.Tensor, state: torch.Tensor,
              impl: str = "auto", scratch: torch.Tensor | None = None):
    """RWKV6's chunked wkv → ``(out (B, S, H, K), final_state (B, H, K, K))``.

    r, k, v, logw (B, S, H, K), u (H, K) and the initial state
    (B, H, K, K), all float32 and on one device, r, k, v and logw starting
    on a 16-byte boundary (a view at another offset raises
    ``ValueError``); ``logw`` ≤ 0 is the log of
    each position's per-channel decay. The function of
    ``repro.models.rwkv6.wkv_chunked``, any S ≥ 1.

    On a CUDA tensor one call launches :data:`WKV_KERNELS_PER_CALL` (3)
    kernels on the current stream, and counts once in ``launches``: the
    per-chunk state increments (B·H·⌈S/64⌉ CTAs), the elementwise state
    scan over the chunks, and the outputs (B·H·⌈S/64⌉ CTAs; intra-chunk
    terms and the carried state, the products on the tensor cores in
    3×TF32). They pass :func:`wkv_scratch_floats` float32 of scratch
    (42.3 MB at (1, 2048, 40, 64)), allocated here with ``torch.empty``
    unless the caller passes ``scratch`` (contiguous float32 of at least
    that size on the same card, 16-byte aligned; :func:`wkv_scratch_views`
    reads it). The
    kernel is not bit-exact with its plain version
    (:func:`ref.wkv_chunked_ref`, another order of sums; the passes are
    mirrored by :func:`ref.wkv_chunk_passes_ref`): they agree to
    ``max|Δ| / (max|ref| + 1) < 5e-4`` (ROADMAP F7). A launch that fails
    raises; there is no fallback to the plain version.
    """
    if r.dim() != 4:
        raise ValueError(f"wkv_chunk: r must be (B, S, H, K), got "
                         f"{tuple(r.shape)}")
    B, S, H, K = r.shape
    tensors = {"k": k, "v": v, "logw": logw, "u": u, "state": state}
    shapes = {"u": (H, K), "state": (B, H, K, K)}
    for name, t in tensors.items():
        want = shapes.get(name, (B, S, H, K))
        if tuple(t.shape) != want or t.device != r.device:
            raise ValueError(f"wkv_chunk: {name} must be {want} on "
                             f"{r.device}, got {tuple(t.shape)} on {t.device}")
    if S == 0:
        raise ValueError("wkv_chunk: the sequence is empty (S = 0)")
    launch = _launches_kernel(r, "wkv_chunk", 4, impl)
    if impl == "auto":  # the rest of the kernel's contract, on every device
        if K not in WKV_HEAD_DIMS:
            raise ValueError(f"wkv_chunk: the CUDA kernel takes K in "
                             f"{WKV_HEAD_DIMS}, got {K}")
        for name, t in tensors.items():
            if t.dtype != torch.float32 or not t.is_contiguous():
                raise TypeError(f"wkv_chunk: the CUDA kernel takes "
                                f"contiguous float32; {name} is {t.dtype}, "
                                f"contiguous={t.is_contiguous()}")
        for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
            _check_aligned(t, f"wkv_chunk: {name}")
    if not launch:
        return ref.wkv_chunked_ref(r, k, v, logw, u, state)
    out = torch.empty_like(r)
    final = torch.empty_like(state)
    if B * H == 0:
        return out, final
    need = wkv_scratch_floats(B, S, H, K)
    if scratch is None:
        scratch = torch.empty(need, dtype=torch.float32, device=r.device)
    elif (scratch.dtype != torch.float32 or scratch.device != r.device
          or not scratch.is_contiguous() or scratch.numel() < need):
        raise ValueError(f"wkv_chunk: scratch must be contiguous float32 of "
                         f"at least {need} elements on {r.device}")
    _check_aligned(scratch, "wkv_chunk: scratch")
    _launch("wkv_chunk", r, r.data_ptr(), k.data_ptr(), v.data_ptr(),
            logw.data_ptr(), u.data_ptr(), state.data_ptr(), out.data_ptr(),
            final.data_ptr(), scratch.data_ptr(), B, S, H, K)
    _count(wkv_chunk)
    return out, final


wkv_chunk.launches = 0
