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
that its main path went through the kernels. Under a roofline counter
(``repro_torch.roofline.counters``) each call also records its kernel's
work formula (``roofline.work``) once, whichever version runs, and hides
its body's aten ops from the counter.

**The data mesh** (``repro.kernels.ops``' mesh layer): the whole-level
kernels ``jpeg_transform`` and ``jpeg_inverse`` take an (N, 3, T, T)
batch whose tiles are independent, and split it over the ambient mesh, a
tuple of devices (:func:`default_mesh`: every visible card, starting with
the tensor's own; :func:`use_mesh` scopes another, per thread). A batch
that the mesh divides (:func:`data_sharding`) goes to the mesh's devices
in equal contiguous shards, one launch each; the results are gathered
into one tensor on the caller's device, so the wrappers keep their
signatures. A shard on the caller's card is a view of the batch and
writes into a view of the result; a shard on another card is copied
there and back by ATen's device-to-device ``copy_``. A card named twice
runs its shards one after the other. The per-tile math does not depend
on the batch, so a split call equals the whole call bit for bit.
``downsample2x2`` and ``entropy_decode`` run whole, as in ``repro``.

Unlike ``repro.kernels.ops`` there is no power-of-two bucketing of the
batch: eager PyTorch has no jit cache to keep small, so a level of any
size is one launch at its own shape.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from functools import lru_cache, wraps

import numpy as np
import torch

from repro_torch.analysis.lockdep import TrackedLock
from repro_torch.kernels import ref
from repro_torch.kernels._build import library
from repro_torch.roofline import work

__all__ = ["jpeg_transform", "downsample2x2", "jpeg_inverse", "rgb2ycbcr",
           "dct8x8_quant", "idct8x8_dequant", "entropy_decode", "ENTROPY_THREADS",
           "wkv_chunk", "wkv_scratch_floats", "wkv_scratch_views",
           "WkvChunk", "launch_counts", "default_mesh", "use_mesh",
           "data_sharding"]


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


def _counted(name: str, work_of):
    """Record ``work_of(*args, **kwargs)`` (``roofline.work``'s formula)
    for each call of the decorated wrapper while a roofline counter is
    active on this thread, and hide the call's aten ops from it."""
    def deco(fn):
        @wraps(fn)
        def wrapper(*args, **kwargs):
            if work.active_counter() is None:
                return fn(*args, **kwargs)
            with work.kernel_work(name, work_of(*args, **kwargs)):
                return fn(*args, **kwargs)
        return wrapper
    return deco


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


# --------------------------------------------------------------------------
# the data mesh: which devices whole-level batches are split over
# --------------------------------------------------------------------------
_MESH_TLS = threading.local()


def _mesh_devices(mesh) -> tuple[torch.device, ...]:
    """A mesh as a tuple of ``torch.device``, each CUDA entry with its
    index (``"cuda"`` is the current card)."""
    devs = []
    for d in mesh:
        d = torch.device(d)
        if d.type == "cuda" and d.index is None:
            if not torch.cuda.is_available():
                raise RuntimeError(f"mesh device {d}: no CUDA device is "
                                   "available")
            d = torch.device("cuda", torch.cuda.current_device())
        devs.append(d)
    if not devs:
        raise ValueError("a mesh names at least one device")
    return tuple(devs)


def default_mesh(device="cuda") -> tuple[torch.device, ...]:
    """The ambient mesh for whole-level batches on ``device``.

    The mesh :func:`use_mesh` scoped on this thread, if any; otherwise,
    for a CUDA ``device``, every visible card, ``device`` first and the
    others after it in index order (wrapping round), and for any other
    device that device alone. It never moves to the CPU on its own: a CUDA
    device on a machine without one raises."""
    mesh = getattr(_MESH_TLS, "mesh", None)
    if mesh is not None:
        return mesh
    (dev,) = _mesh_devices((device,))
    if dev.type != "cuda":
        return (dev,)
    n = torch.cuda.device_count()
    return tuple(torch.device("cuda", (dev.index + i) % n)
                 for i in range(n))


@contextmanager
def use_mesh(devices):
    """Scope the ambient mesh (thread-local) for the whole-level kernels:
    ``devices`` is a sequence of devices (or their names), a card possibly
    named more than once. Restores the previous scope on exit."""
    prev = getattr(_MESH_TLS, "mesh", None)
    _MESH_TLS.mesh = _mesh_devices(devices)
    try:
        yield _MESH_TLS.mesh
    finally:
        _MESH_TLS.mesh = prev


def data_sharding(n: int, mesh) -> list[tuple[torch.device, slice]]:
    """How a leading batch of ``n`` lies on ``mesh``: ``(device, rows)``
    per shard. ``len(mesh)`` contiguous equal shards, in mesh order, when
    ``n > 0`` and the mesh divides it; otherwise the whole batch on the
    mesh's first device (a batch that does not divide still gives the same
    bytes, without the split)."""
    mesh = _mesh_devices(mesh)
    m = len(mesh)
    if n <= 0 or n % m:
        return [(mesh[0], slice(0, n))]
    k = n // m
    return [(d, slice(i * k, (i + 1) * k)) for i, d in enumerate(mesh)]


def _batched_call(x: torch.Tensor, dtype: torch.dtype, name: str,
                  run) -> torch.Tensor:
    """The mesh policy of the (N, 3, T, T) kernels (module doc):
    ``run(part, out)`` computes the rows ``part`` into ``out``, a tensor
    of ``dtype`` of ``part``'s shape on ``part``'s device. Returns the
    gathered result on ``x.device``.

    A mesh whose device type is not ``x``'s raises ``ValueError``: no
    tensor changes device type. Cross-card copies go through ATen's
    ``copy_``, which makes each card's current stream wait for the other's
    before the copy and the destination's wait for the copy after it, so
    the shards and the result are freed safely on their own streams."""
    mesh = default_mesh(x.device)
    if any(d.type != x.device.type for d in mesh):
        raise ValueError(f"{name}: the mesh {[str(d) for d in mesh]} "
                         f"mixes device types with a tensor on {x.device}")
    out = torch.empty(x.shape, dtype=dtype, device=x.device)
    for dev, rows in data_sharding(x.shape[0], mesh):
        part, dst = x[rows], out[rows]
        if dev == x.device:
            # the kernels read their input a 4-byte sample a lane (a view
            # at any offset) and store their output in 16-byte pieces
            if x.is_cuda:
                _check_aligned(dst, f"{name}: a shard's result")
            run(part, dst)
            continue
        part = part.to(dev, non_blocking=True)
        res = torch.empty(part.shape, dtype=dtype, device=dev)
        run(part, res)
        dst.copy_(res, non_blocking=True)
    return out


@_counted("jpeg_transform", lambda tiles, *a, **k:
          work.jpeg_transform_work(tiles.shape))
def jpeg_transform(tiles: torch.Tensor, qluma=None, qchroma=None,
                   impl: str = "auto") -> torch.Tensor:
    """(N, 3, H, W) RGB tiles → (N, 3, H, W) int32 quantized YCbCr DCT coefs.

    The whole-level dispatch: one launch transform-codes every tile of a
    pyramid level (level-shifted YCbCr, per-channel 8×8 DCT, ``round(y/q)``
    with the luma table for Y and the chroma table for Cb/Cr), or one per
    shard where the ambient mesh splits the batch (module doc). H and W
    must be multiples of 8 (the pyramid's tiles are square, T × T).
    ``N == 0`` (a level smaller than one tile) launches nothing and returns
    an empty int32 tensor. ``qluma``/``qchroma`` default to the Annex-K
    tables.
    """
    _check_blocks(tiles, "jpeg_transform", "tiles")
    launch = _launches_kernel(tiles, "jpeg_transform", 4, impl)
    q = _host_tables(qluma, qchroma) if launch else None

    def run(x: torch.Tensor, out: torch.Tensor) -> None:
        if not launch:
            out.copy_(ref.jpeg_transform_ref(x, qluma, qchroma))
            return
        N, _, H, W = x.shape
        if N == 0:
            return
        _launch("jpeg_transform", x, x.data_ptr(), out.data_ptr(), N, H, W,
                q.ctypes.data)
        _count(jpeg_transform)

    return _batched_call(tiles, torch.int32, "jpeg_transform", run)


jpeg_transform.launches = 0


@_counted("downsample2x2", lambda img, *a, **k:
          work.downsample2x2_work(img.shape))
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


@_counted("jpeg_inverse", lambda coef, *a, **k:
          work.jpeg_inverse_work(coef.shape))
def jpeg_inverse(coef: torch.Tensor, qluma=None, qchroma=None,
                 impl: str = "auto") -> torch.Tensor:
    """(N, 3, H, W) int32 quantized YCbCr DCT coefs → (N, 3, H, W) uint8 RGB.

    The whole-level inverse dispatch: one launch decode-transforms every
    tile of a stored level (dequantize with the luma table for Y and the
    chroma table for Cb/Cr, 8×8 iDCT, YCbCr → RGB, ``clip(round(·))``), or
    one per shard where the ambient mesh splits the batch, as
    :func:`jpeg_transform` does. H and W must be multiples of 8; ``N ==
    0`` launches nothing. ``qluma``/``qchroma`` default to the Annex-K
    tables.
    """
    _check_blocks(coef, "jpeg_inverse", "coefficients")
    launch = _launches_kernel(coef, "jpeg_inverse", 4, impl, torch.int32)
    q = _host_tables(qluma, qchroma) if launch else None

    def run(x: torch.Tensor, out: torch.Tensor) -> None:
        if not launch:
            out.copy_(ref.jpeg_inverse_ref(x, qluma, qchroma))
            return
        N, _, H, W = x.shape
        if N == 0:
            return
        _launch("jpeg_inverse", x, x.data_ptr(), out.data_ptr(), N, H, W,
                q.ctypes.data)
        _count(jpeg_inverse)

    return _batched_call(coef, torch.uint8, "jpeg_inverse", run)


jpeg_inverse.launches = 0


@_counted("rgb2ycbcr", lambda img, *a, **k:
          work.rgb2ycbcr_work(img.shape))
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


@_counted("dct8x8_quant", lambda plane, *a, **k:
          work.dct8x8_quant_work(plane.shape))
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


def idct8x8_dequant(coef: torch.Tensor, qtable) -> torch.Tensor:
    """Decoder-side inverse of :func:`dct8x8_quant`: (H, W) quantized
    coefficients → (H, W) float32 level-shifted samples. Plain PyTorch on
    any device (``repro``'s counterpart is jnp only, no kernel); the tests
    and the decoder use it."""
    return ref.idct8x8_dequant_ref(coef, qtable)


#: threads (subsequences) of the ``entropy_decode`` kernel's CTA, one CTA
#: per tile; :func:`ref.entropy_decode_subseq_ref` at this width gives the
#: kernel's sync rounds
ENTROPY_THREADS = 256


@_counted("entropy_decode", lambda buf, offs, nbits, lut, H, W, *a, **k:
          work.entropy_decode_work(offs.numel(), H, W, buf.numel(),
                                   lut.numel()))
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
    (``cp.async``), and the block kernels store their outputs so, so that
    data must start on a 16-byte boundary: a contiguous view at an offset
    that is not a multiple of 16 bytes would fault on the card and poison
    its context (a mesh shard's result is a view at an offset: a whole
    number of tiles, a multiple of 192 bytes). A fake tensor (the dry run)
    has no data to check."""
    from torch._subclasses.fake_tensor import FakeTensor

    if isinstance(t, FakeTensor):
        return
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

    The kernel writes its outputs through raw pointers, so they carry no
    autograd history: with ``impl="auto"``, on inputs that require grad
    while grad mode is on, the call goes through :class:`WkvChunk` on
    every device, whose forward is this function (the kernel, or on the
    CPU its plain version) and whose backward is the plain chunked form's
    gradient: one path, so a step counts the same work on the card and on
    the CPU (``roofline.counters``).
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
    if impl == "auto" and torch.is_grad_enabled() and any(
            t.requires_grad for t in (r, k, v, logw, u, state)):
        return WkvChunk.apply(r, k, v, logw, u, state)
    with work.kernel_work("wkv_chunk", work.wkv_chunk_work(B, S, H, K)):
        if not launch:
            return ref.wkv_chunked_ref(r, k, v, logw, u, state)
        return _wkv_launch(r, k, v, logw, u, state, scratch)


def _wkv_launch(r, k, v, logw, u, state, scratch):
    """One ``wkv_chunk`` kernel call on the card (:func:`wkv_chunk`)."""
    B, S, H, K = r.shape
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


class WkvChunk(torch.autograd.Function):
    """:func:`wkv_chunk` with a gradient: ``WkvChunk.apply(r, k, v, logw,
    u, state) -> (out, final_state)``; :func:`wkv_chunk` comes
    here by itself on inputs that require grad.

    The forward is :func:`wkv_chunk`, run with grad off (on a CUDA tensor
    the kernel, counted once in ``wkv_chunk.launches``; on the CPU its
    plain version). The backward
    recomputes the plain chunked form (:func:`ref.wkv_chunked_ref`) on the
    saved inputs and differentiates it by autograd, giving all six
    gradients, the initial state's included: the gradient ``repro``
    takes, which differentiates XLA's ``wkv_chunked`` (its Pallas kernel
    has no VJP). A backward kernel is later work (ROADMAP A12).
    """

    @staticmethod
    def forward(ctx, r, k, v, logw, u, state):
        ctx.save_for_backward(r, k, v, logw, u, state)
        with torch.profiler.record_function("wkv_fwd"):
            return wkv_chunk(r, k, v, logw, u, state)

    @staticmethod
    def backward(ctx, g_out, g_state):
        inputs = [t.detach().requires_grad_() for t in ctx.saved_tensors]
        with torch.profiler.record_function("wkv_bwd"), torch.enable_grad():
            out, final = ref.wkv_chunked_ref(*inputs)
            return torch.autograd.grad((out, final), inputs,
                                       (g_out, g_state))


def launch_counts() -> dict[str, int]:
    """Every counted wrapper's ``launches``, by name: what a region
    launched is the difference of two readings."""
    return {"jpeg_transform": jpeg_transform.launches,
            "downsample2x2": downsample2x2.launches,
            "jpeg_inverse": jpeg_inverse.launches,
            "rgb2ycbcr": rgb2ycbcr.launches,
            "dct8x8_quant": dct8x8_quant.launches,
            "entropy_decode": entropy_decode.launches,
            "wkv_chunk": wkv_chunk.launches}
