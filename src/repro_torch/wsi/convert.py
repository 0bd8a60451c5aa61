"""The converter: any registered slide container → multi-level DICOM WSM study.

The PyTorch/CUDA port of ``repro.wsi.convert``. Per slide: sniff the
container (``repro_torch.wsi.formats.open_slide``), stream tiles through the
``SlideReader`` protocol, build the multi-resolution pyramid on the device
with the ``downsample2x2`` kernel, transform-code every level's tiles with
the ``jpeg_transform`` kernel, entropy-code on the host, wrap each level in
a DICOM Part-10 instance (TILED_FULL) and bundle the study as a tar.

Three paths, all emitting study tars **byte-identical** to each other and
to ``repro``'s for the same pixels and manifest ``"uids"``:

- **pipelined** (default): level 0 goes up once, in row strips from pinned
  host memory, into one preallocated ``(3, H, W)`` float32 device tensor.
  Every level's ``jpeg_transform`` and the ``downsample2x2`` chain between
  levels are enqueued on the current stream at once; each level's
  coefficients are copied to pinned host memory on a side stream, gated by
  an event recorded after that level's transform. The host entropy-codes
  level N while the card runs the levels above N. ``TRANSFER_STATS``
  counts one upload and one dispatch chain per slide.
- **sync batched** (``pipelined=False``, and always for ``jpeg=False``):
  each level's host work finishes before the next level's device work is
  enqueued. Kept as the byte-identity A/B baseline; ``jpeg=False`` writes
  native explicit-VR-LE frames.
- **per-tile** (``batched=False``): the sync engine's device pyramid, but
  every frame is encoded on its own by ``encode_tile`` (one ``rgb2ycbcr``
  and three ``dct8x8_quant`` launches and the Python Huffman loop). Kept
  as the A/B baseline of the whole-level transform.

**Determinism, crash/resume**: as in the reference, the study/series UIDs
are minted once into the manifest (``"uids"``), SOP UIDs derive from the
series UID, and ``ConvertOptions.manifest`` is the single store of
finished-level Part-10 bytes. The manifest holds only ``str``/``bytes``, so
a manifest written by ``repro``'s converter resumes here unchanged.
"""
from __future__ import annotations

import io
import json
import tarfile
from contextlib import nullcontext

import numpy as np
import torch

from repro_torch.core import tracing
from repro_torch.kernels import downsample2x2, jpeg_transform
from repro_torch.kernels.ops import use_mesh
from repro_torch.wsi.dicom import (TS_EXPLICIT_LE, TS_JPEG_BASELINE, new_uid,
                                   write_part10)
from repro_torch.wsi.formats import SlideReader, open_slide
from repro_torch.wsi.jpeg import (encode_coef_batch, encode_tile,
                                  resolve_device)

__all__ = ["convert_wsi_to_dicom", "study_levels", "ConvertOptions",
           "TRANSFER_STATS"]


class ConvertOptions:
    """Converter knobs.

    min_level_size
        Stop the pyramid once the next level's short edge would fall below
        this (pixels). Levels smaller than one tile emit zero full frames.
    jpeg
        ``True`` → encapsulated JPEG baseline transfer syntax; ``False`` →
        native (uncompressed) explicit-VR-LE pixel data, through the sync
        engine.
    manifest
        Resume checkpoint *and* the only copy of finished-level bytes held
        by the converter: maps level index (str) to that level's Part-10
        bytes, plus the ``"uids"`` entry (JSON ``[study_uid, series_uid]``)
        minted on first use. A manifest written by ``repro``'s converter is
        accepted as it is.
    batched
        ``True`` (default): one ``jpeg_transform`` launch per level.
        ``False``: the per-tile path (``encode_tile`` per frame), through
        the sync engine.
    pipelined
        ``True`` (default): the overlapped engine (see module docstring).
        ``False``: strictly sequential per-level stages.
    device
        Where the pyramid and the kernels run: ``"cuda"`` (default, also
        what ``None`` means), ``"cuda:<i>"`` or ``"cpu"``. A CUDA device on
        a machine without one raises; the converter never moves to the CPU
        unless asked.
    mesh
        Optional sequence of devices (of ``device``'s type; a card may be
        named more than once): scope the conversion's ``jpeg_transform``
        launches to this mesh, each level's tile batch split over it (see
        ``kernels.ops.use_mesh``). ``None`` (default) uses the ambient mesh
        (every visible card, ``device`` first). The pyramid, the
        downsample chain and the coefficient fetches stay on ``device``.
        The split never changes output bytes, only where tiles are
        computed.
    """

    def __init__(self, *, min_level_size: int = 256, jpeg: bool = True,
                 manifest: dict | None = None, batched: bool = True,
                 pipelined: bool = True, device: str | None = "cuda",
                 mesh=None):
        self.min_level_size = min_level_size
        self.jpeg = jpeg
        self.batched = batched
        self.pipelined = pipelined
        self.device = device
        self.mesh = mesh
        self.manifest = manifest if manifest is not None else {}

    def clear_manifest(self) -> None:
        """Drop finished-level bytes (call after the study tar is stored).

        Also drops the stored study/series UIDs, so a conversion rerun
        against the cleared manifest mints fresh identifiers.
        """
        self.manifest.clear()


def _study_uids(opt: ConvertOptions) -> tuple[str, str]:
    """(study_uid, series_uid), minted once and persisted in the manifest."""
    raw = opt.manifest.get("uids")
    if raw is None:
        raw = json.dumps([new_uid(), new_uid()])
        opt.manifest["uids"] = raw
    study_uid, series_uid = json.loads(raw)
    return study_uid, series_uid


def _level_frames(img: np.ndarray, tile: int) -> list[np.ndarray]:
    """Tile a (H, W, 3) level into row-major frames."""
    H, W, _ = img.shape
    return [img[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile]
            for r in range(H // tile) for c in range(W // tile)]


def _tile_batch(dev: torch.Tensor, tile: int) -> torch.Tensor:
    """(3, H, W) level → contiguous (N, 3, tile, tile) row-major tile batch."""
    _, H, W = dev.shape
    bh, bw = H // tile, W // tile
    if bh == 0 or bw == 0:
        # level smaller than one tile: no full frames
        return torch.zeros((0, 3, tile, tile), dtype=dev.dtype,
                           device=dev.device)
    return (dev[:, :bh * tile, :bw * tile].reshape(3, bh, tile, bw, tile)
            .permute(1, 3, 0, 2, 4).contiguous()
            .view(bh * bw, 3, tile, tile))


class TransferStats:
    """Host↔device traffic ledger for the pipelined engine.

    ``uploads`` counts streamed level-0 uploads (one per slide — the strip
    copies of one slide are one logical transfer), ``dispatches`` counts
    enqueued pyramid chains (one per slide), and ``fetches`` counts
    per-level coefficient downloads. Counters are advisory (not
    thread-synchronized); reset + assert from a single thread.
    """

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.uploads = 0
        self.dispatches = 0
        self.fetches = 0


TRANSFER_STATS = TransferStats()


def _upload_level0(rd: SlideReader, device: torch.device) -> torch.Tensor:
    """Stream level 0 to ``device`` one tile row at a time.

    Each row strip is inflated into a pinned host buffer and copied
    (``non_blocking``) into its rows of one preallocated ``(3, H, W)``
    float32 tensor, so the copy of row r overlaps the inflation of row r+1.
    The caching host allocator recycles a strip's pinned block only once its
    copy has completed. The strips hold exact uint8 values in float32.
    """
    tile, W = rd.tile, rd.W
    bh, bw = rd.grid
    cuda = device.type == "cuda"
    TRANSFER_STATS.uploads += 1
    dev = torch.empty((3, rd.H, W), dtype=torch.float32, device=device)
    for r in range(bh):
        row = torch.empty((3, tile, W), dtype=torch.float32, pin_memory=cuda)
        row_np = row.numpy()
        for c in range(bw):
            row_np[:, :, c * tile:(c + 1) * tile] = \
                np.transpose(rd.read_tile(r, c), (2, 0, 1))
        dev[:, r * tile:(r + 1) * tile].copy_(row, non_blocking=cuda)
    return dev


def _wrap_level(opt: ConvertOptions, li: int, frames: list[bytes], ts: str,
                tile: int, H: int, W: int, metadata: dict | None,
                study_uid: str, series_uid: str) -> None:
    """Wrap one finished level as Part-10 bytes into the manifest."""
    opt.manifest[str(li)] = write_part10(
        frames=frames, rows=tile, cols=tile,
        total_rows=H, total_cols=W, transfer_syntax=ts,
        study_uid=study_uid, series_uid=series_uid,
        sop_instance_uid=f"{series_uid}.{li + 1}",
        instance_number=li + 1,
        metadata={0: (metadata or {}).get("slide_id", "unknown"),
                  1: f"level={li}"},
    )


def _level_chunks(batch: np.ndarray, bh: int, bw: int) -> list[np.ndarray]:
    """Split a level's (N, 3, T, T) coefficient batch into row-aligned
    chunks for the host entropy coder (~4 per level, on whole tile rows, so
    per-chunk encode emits exactly the frames of a whole-level encode)."""
    rows_per = max(1, bh // 4)
    return [batch[r0 * bw:min(r0 + rows_per, bh) * bw]
            for r0 in range(0, bh, rows_per)]


def _pyramid_dims(H: int, W: int,
                  min_level_size: int) -> list[tuple[int, int]]:
    """Host-side geometry walk: (H, W) per pyramid level, same stopping
    rule as the sync engine's device walk."""
    dims = []
    while True:
        dims.append((H, W))
        if min(H, W) // 2 < min_level_size:
            return dims
        H, W = H // 2, W // 2


def _fetch_async(coef: torch.Tensor, copy_stream) -> tuple:
    """Start the device→host copy of one level's coefficients.

    On CUDA the copy runs on ``copy_stream`` into pinned memory, behind an
    event recorded on the current stream after the level's transform, and
    returns ``(host tensor, completion event)``. ``coef`` is the
    transform's gathered result on the home card: a shard computed on
    another card was copied into it on that card's stream, which the home
    card's current stream waits on, so the event covers every shard. On
    the CPU the tensor is already on the host.
    """
    if copy_stream is None or coef.numel() == 0:
        return coef.cpu(), None
    host = torch.empty(coef.shape, dtype=coef.dtype, pin_memory=True)
    ready = torch.cuda.Event()
    ready.record()
    with torch.cuda.stream(copy_stream):
        copy_stream.wait_event(ready)
        host.copy_(coef, non_blocking=True)
        coef.record_stream(copy_stream)  # keep its memory until the copy ends
        done = torch.cuda.Event()
        done.record(copy_stream)
    return host, done


def _convert_pipelined(rd: SlideReader, metadata: dict | None,
                       opt: ConvertOptions, study_uid: str, series_uid: str,
                       device: torch.device) -> int:
    """The overlapped engine. Returns the number of levels.

    1. **Upload** — level 0 once, in pinned row strips (``_upload_level0``).
    2. **Enqueue the chain** — for every level, ``jpeg_transform`` on its
       tile batch (levels already in the manifest are skipped; their
       downsamples still run, because deeper levels derive from them) and
       the ``downsample2x2`` step to the next level (nothing past the last
       needed level), all on the current stream; each level's coefficient
       copy starts on a side stream as
       soon as its transform is enqueued. Rebinding ``dev`` drops each
       level's pixels once the next level is enqueued, level 0 included.
    3. **Ordered consume** — levels are entropy-coded and Part-10-wrapped
       in pyramid order, in row-aligned chunks; each finished level is
       checkpointed into the manifest at once.
    """
    tile = rd.tile
    dims = _pyramid_dims(rd.H, rd.W, opt.min_level_size)
    n_levels = len(dims)
    needed = [li for li in range(n_levels) if str(li) not in opt.manifest]
    if not needed:
        return n_levels

    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" \
        else None
    with tracing.span("convert.upload"):
        dev = _upload_level0(rd, device)
    TRANSFER_STATS.dispatches += 1
    pending = []
    with tracing.span("convert.dispatch", levels=len(needed)):
        # asynchronous launches: the span covers the enqueue, not device
        # time — device work overlaps the per-level entropy spans below
        for li in range(needed[-1] + 1):
            if li in needed:
                pending.append(_fetch_async(
                    jpeg_transform(_tile_batch(dev, tile)), copy_stream))
            if li < needed[-1]:
                dev = downsample2x2(dev)
        del dev

    for li, (host, done) in zip(needed, pending):
        H, W = dims[li]
        with tracing.span("convert.entropy", level=li):
            if done is not None:
                done.synchronize()
            coef = host.numpy()
            TRANSFER_STATS.fetches += 1
            bh, bw = H // tile, W // tile
            chunks = [coef] if (bh == 0 or bw == 0) \
                else _level_chunks(coef, bh, bw)
            frames: list[bytes] = []
            for ch in chunks:
                frames += encode_coef_batch(ch)
            _wrap_level(opt, li, frames, TS_JPEG_BASELINE, tile, H, W,
                        metadata, study_uid, series_uid)
            tracing.add_event(None, "convert.checkpoint", level=li,
                              frames=len(frames))
    return n_levels


def _convert_sync(rd: SlideReader, metadata: dict | None,
                  opt: ConvertOptions, study_uid: str, series_uid: str,
                  device: torch.device) -> int:
    """The strictly sequential engine (batched or per-tile). Returns the
    number of levels."""
    tile = rd.tile
    level = np.empty((rd.H, rd.W, 3), np.uint8)
    for (r, c), t in rd.tiles():
        level[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile] = t
    # the pyramid lives on the device as float32 planes holding exact uint8
    # values (each downsample is re-quantized in the kernel)
    dev = torch.from_numpy(np.ascontiguousarray(
        np.transpose(level, (2, 0, 1)), dtype=np.float32)).to(device)
    del level

    li = 0
    while True:
        H, W = int(dev.shape[1]), int(dev.shape[2])
        if str(li) not in opt.manifest:
            ts = TS_JPEG_BASELINE if opt.jpeg else TS_EXPLICIT_LE
            if opt.jpeg and opt.batched:
                coef = jpeg_transform(_tile_batch(dev, tile)).cpu().numpy()
                frames = encode_coef_batch(coef)
            else:
                img = dev.cpu().numpy().transpose(1, 2, 0).astype(np.uint8)
                frames = [encode_tile(f, device=device) if opt.jpeg
                          else np.ascontiguousarray(f).tobytes()
                          for f in _level_frames(img, tile)]
            _wrap_level(opt, li, frames, ts, tile, H, W, metadata,
                        study_uid, series_uid)
        if min(H, W) // 2 < opt.min_level_size:
            return li + 1
        dev = downsample2x2(dev)
        li += 1


def _pack_study(opt: ConvertOptions, n_levels: int, study_uid: str,
                tile: int) -> bytes:
    """Assemble the study tar directly from the manifest (deterministic:
    fixed member mtimes, levels in index order)."""
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tar:
        manifest = {"levels": n_levels, "study_uid": study_uid,
                    "tile": tile}
        mb = json.dumps(manifest).encode()
        info = tarfile.TarInfo("study.json")
        info.size = len(mb)
        tar.addfile(info, io.BytesIO(mb))
        for i in range(n_levels):
            blob = opt.manifest[str(i)]
            info = tarfile.TarInfo(f"level_{i}.dcm")
            info.size = len(blob)
            tar.addfile(info, io.BytesIO(blob))
    return buf.getvalue()


def convert_wsi_to_dicom(slide_bytes: bytes, metadata: dict | None = None,
                         options: ConvertOptions | None = None) -> bytes:
    """Full conversion of any registered container (sniffed by magic bytes).

    Returns a tar archive of per-level .dcm files. Raises an actionable
    ``ValueError`` for unknown/truncated containers (see
    ``repro_torch.wsi.formats.sniff``) and ``RuntimeError`` when the
    requested CUDA device is missing."""
    opt = options or ConvertOptions()
    device = resolve_device(opt.device)
    rd = open_slide(slide_bytes)
    if rd.H % rd.tile or rd.W % rd.tile:
        raise ValueError(
            f"slide is {rd.H}x{rd.W} with {rd.tile}px tiles — the pyramid "
            "engine requires tile-aligned dimensions (pad the scan)")
    study_uid, series_uid = _study_uids(opt)
    # events and streams below belong to the current CUDA device
    ctx = torch.cuda.device(device) if device.type == "cuda" \
        else nullcontext()
    mesh = use_mesh(opt.mesh) if opt.mesh is not None else nullcontext()
    stats0 = (TRANSFER_STATS.uploads, TRANSFER_STATS.dispatches,
              TRANSFER_STATS.fetches)
    with tracing.span("convert.slide",
                      slide=(metadata or {}).get("slide_id")) as sp:
        with ctx, mesh:
            if opt.pipelined and opt.jpeg and opt.batched:
                n_levels = _convert_pipelined(rd, metadata, opt, study_uid,
                                              series_uid, device)
            else:
                n_levels = _convert_sync(rd, metadata, opt, study_uid,
                                         series_uid, device)
        with tracing.span("convert.pack", levels=n_levels):
            out = _pack_study(opt, n_levels, study_uid, rd.tile)
        if sp is not None:
            # TRANSFER_STATS is advisory (not thread-synced): under
            # concurrent conversions the deltas may include a neighbour's
            # transfers — they annotate, they don't assert
            sp.attrs.update(
                levels=n_levels,
                uploads=TRANSFER_STATS.uploads - stats0[0],
                dispatches=TRANSFER_STATS.dispatches - stats0[1],
                fetches=TRANSFER_STATS.fetches - stats0[2])
    return out


def study_levels(study_tar: bytes) -> dict[str, bytes]:
    """Unpack a converted study archive (non-file members are skipped)."""
    out = {}
    with tarfile.open(fileobj=io.BytesIO(study_tar)) as tar:
        for m in tar.getmembers():
            f = tar.extractfile(m)
            if f is None:  # directory / link member
                continue
            out[m.name] = f.read()
    return out
