#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0] [--size 16384]

Run from the repository root on a machine with a CUDA card and nvcc. It
imports nothing of JAX or of the ``repro`` package. Phases, each of which
raises (exit code ≠ 0) on any failed check:

1. device — the card's name and power limit (``nvidia-smi``); TF32 off for
   the plain versions;
2. build — every kernel in ``src/repro_torch/kernels/csrc`` with nvcc, all
   sources in parallel;
3. kernels vs plain versions at main-path shapes — ``downsample2x2`` on a
   (3, size, size) level (bit-exact), ``jpeg_transform`` on the (N, 3, 256,
   256) tile batch of that level: slide tiles (exact) and uniform noise
   (every mismatch ±1 at a rounding tie, at most 1e-6 of the coefficients);
   ``jpeg_inverse`` on the coefficients of both (bit-exact);
   ``rgb2ycbcr`` and ``dct8x8_quant`` at the per-tile shapes (3, 256, 256)
   and (256, 256) (bit-exact), also timed at a level's shape; each timed
   with CUDA events (median of 10; at the per-tile shapes per launch of
   200 launches replayed from one CUDA graph, and per call of 200 calls
   from the host) beside its plain version, ``bound_ms``
   (the least time the card could take: the larger of bytes over the
   memory rate and operations over the float32 rate) and, where one
   PyTorch call computes the same function, that call's time;
4. equivalence on a 4096² slide — PSV vs TIFF, pipelined vs sync and
   per-tile (``batched=False``, its launch counts zeroed just before) study
   tars on the card, and the card's tar vs the CPU plain path's, byte for
   byte; every level decoded on the card by ``decode_tiles_batch`` equals
   ``decode_tile`` per frame and the CPU plain path, pixel for pixel;
5. the main path — a size² PSV slide (256² tiles) converted on ``cuda`` by
   the pipelined engine with the launch counts zeroed just before: one
   ``jpeg_transform`` launch per level, one ``downsample2x2`` per level
   step, one upload; every level's Part-10 frame count equals its tile
   count; per-stage wall times and MPix/s;
6. the read side — every level of that study read back as the export
   service does (``Part10Index.read_frame`` → ``decode_frames`` on
   ``cuda`` with the launch counts zeroed just before → ``write_tiff`` →
   ``open_slide``): one ``jpeg_inverse`` and one ``entropy_decode`` launch
   per level, the one-frame level included; each level equal,
   pixel for pixel, to the codec's round trip (``jpeg_inverse`` ∘
   ``jpeg_transform``) of the level's pixels, rebuilt by the
   ``downsample2x2`` chain; PSNR against those pixels above 30 dB at level 0
   and above 25 dB at every level (the bounds of tests/test_storage_dicom.py
   for a tissue tile and for a stored round trip: q50 JPEG of this slide's
   2–32× downsampled levels measures 26.7–34.0 dB); per-stage wall times
   and MPix/s;
7. ``entropy_decode`` vs its plain version and the numpy engine on level
   0's frames (coefficient-exact), the same error string as the numpy
   engine on a batch with corrupt frames, and the longest tile's symbol
   count (the kernel's chain of dependent reads) beside its bytes bound.

Prints the kernel JSON line and the card line before the last line, which
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# NVIDIA H100 SXM data sheet (dense peaks at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
TIE = 1e-5
MAX_MISMATCH_FRACTION = 1e-6
# tests/test_storage_dicom.py's bounds: a level-0 tissue tile, and any
# stored round trip (the downsampled levels of a synthetic slide lose more
# to q50 quantization: 26.7 dB measured at the 16x level)
PSNR_MIN_DB_LEVEL0 = 30.0
PSNR_MIN_DB = 25.0
KERNELS = ("downsample2x2", "jpeg_transform", "jpeg_inverse", "rgb2ycbcr",
           "dct8x8_quant", "entropy_decode")


def _log(msg: str) -> None:
    print(msg, flush=True)


def _zero_launches() -> None:
    from repro_torch.kernels import ops
    for name in KERNELS:
        getattr(ops, name).launches = 0


def _read_launches() -> dict:
    from repro_torch.kernels import ops
    return {name: getattr(ops, name).launches for name in KERNELS}


def _time_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _per_call_ms(fn, calls: int = 200) -> float:
    """Time per call of ``calls`` back-to-back calls of ``fn()`` from the
    host, by CUDA events around the loop (median of 5 loops).

    What the per-tile path pays per call: the span is set by whichever is
    slower, the device work or the host's launch (the wrapper's checks,
    ctypes, ``cudaLaunchKernel``)."""
    import torch
    for _ in range(10):
        fn()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def _graph_ms(fn, calls: int = 200) -> float:
    """Device time per call of ``fn()``: ``calls`` calls captured in one
    CUDA graph, replayed (median of 10 replays), so no host work lies
    between two launches. ``fn`` must launch on the current stream and
    make no host↔device copy or sync."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = _time_ms(graph.replay) / calls
    del graph
    return ms


def _bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _uids(seed: int) -> str:
    import numpy as np
    rng = np.random.default_rng(seed)
    return json.dumps(["2.25." + "".join(map(str, rng.integers(0, 10, 30)))
                       for _ in range(2)])


def _tile_tensor(slide: bytes, device):
    """The level-0 (N, 3, T, T) float32 tile batch of a slide, on device."""
    import numpy as np
    import torch
    from repro_torch.wsi.formats import open_slide
    rd = open_slide(slide)
    bh, bw = rd.grid
    out = torch.empty((bh * bw, 3, rd.tile, rd.tile), dtype=torch.float32,
                      device=device)
    for r in range(bh):
        row = np.stack([np.transpose(rd.read_tile(r, c), (2, 0, 1))
                        for c in range(bw)])
        out[r * bw:(r + 1) * bw] = torch.from_numpy(row)
    return out


def check_kernels(size: int, slide: bytes, seed: int) -> dict:
    """Phase 3: each kernel vs its plain version at main-path shapes."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    results = {}

    # downsample2x2 on a (3, size, size) level of u8 values
    x = torch.randint(0, 256, (3, size, size), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.float32)
    got = ops.downsample2x2(x)
    plain = ops.downsample2x2(x, impl="ref")
    lib = torch.clamp(torch.round(F.avg_pool2d(x, 2)), 0, 255)
    torch.cuda.synchronize()
    mism = int((got != plain).sum())
    if mism:
        raise AssertionError(f"downsample2x2: {mism} elements differ from "
                             "the plain version (must be bit-exact)")
    if not torch.equal(lib, plain):
        raise AssertionError("downsample2x2: avg_pool2d yardstick disagrees")
    n_out = got.numel()
    bound_ms, bound_by = _bound(x.numel() * 4 + n_out * 4, n_out * 7.0)
    results["downsample2x2"] = dict(
        name="downsample2x2", route="cuda",
        source="src/repro_torch/kernels/csrc/downsample2x2.cu",
        replaces="src/repro/kernels/downsample2x2.py:26",
        mismatches=mism, max_abs_err=float((got - plain).abs().max()),
        ms=_time_ms(lambda: ops.downsample2x2(x)),
        plain_ms=_time_ms(lambda: ops.downsample2x2(x, impl="ref")),
        bound_ms=bound_ms, bound_by=bound_by,
        library_ms=_time_ms(lambda: torch.clamp(
            torch.round(F.avg_pool2d(x, 2)), 0, 255)),
        shape=list(x.shape))
    del x, got, plain, lib

    # jpeg_transform on the level's (N, 3, 256, 256) tile batch
    tiles = _tile_tensor(slide, dev)
    noise = torch.randint(0, 256, tuple(tiles.shape), generator=gen,
                          device=dev, dtype=torch.int32).to(torch.float32)
    mism, err = 0, 0.0
    coefs = {}
    for kind, t in (("slide", tiles), ("noise", noise)):
        got = ops.jpeg_transform(t)
        coefs[kind] = got
        plain = ops.jpeg_transform(t, impl="ref")
        torch.cuda.synchronize()
        bad = got != plain
        m = int(bad.sum())
        if m:
            if kind == "slide":
                raise AssertionError(f"jpeg_transform: {m} coefficients "
                                     "differ on slide content")
            q = ref.jpeg_quotient_ref(t)[bad]
            ties = (q - torch.trunc(q)).abs().sub(0.5).abs() < TIE
            if not bool(ties.all()) or m > MAX_MISMATCH_FRACTION * t.numel() \
                    or int((got - plain)[bad].abs().max()) != 1:
                raise AssertionError(f"jpeg_transform: {m} coefficients "
                                     "differ on noise outside the tie rule")
        mism += m
        err = max(err, float((got - plain).abs().max()))
        del got, plain, bad
    del noise
    px = tiles.numel() // 3
    bound_ms, bound_by = _bound(tiles.numel() * 4 * 2, px * 112.0)
    results["jpeg_transform"] = dict(
        name="jpeg_transform", route="cuda",
        source="src/repro_torch/kernels/csrc/jpeg_transform.cu",
        replaces="src/repro/kernels/jpeg_transform.py:53",
        mismatches=mism, max_abs_err=err,
        ms=_time_ms(lambda: ops.jpeg_transform(tiles)),
        plain_ms=_time_ms(lambda: ops.jpeg_transform(tiles, impl="ref")),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        shape=list(tiles.shape))

    # jpeg_inverse on the coefficients of the slide tiles and of the noise
    del tiles
    torch.cuda.empty_cache()
    mism, err = 0, 0.0
    for kind, c in coefs.items():
        got = ops.jpeg_inverse(c)
        plain = ops.jpeg_inverse(c, impl="ref")
        torch.cuda.synchronize()
        m = int((got != plain).sum())
        if m:
            raise AssertionError(f"jpeg_inverse: {m} samples differ from "
                                 f"the plain version on {kind} coefficients "
                                 "(must be bit-exact)")
        mism += m
        err = max(err, float((got.int() - plain.int()).abs().max()))
        del got, plain
        torch.cuda.empty_cache()
    c = coefs.pop("slide")
    del coefs
    px = c.numel() // 3
    bound_ms, bound_by = _bound(c.numel() * 4 + c.numel(), px * 111.0)
    results["jpeg_inverse"] = dict(
        name="jpeg_inverse", route="cuda",
        source="src/repro_torch/kernels/csrc/jpeg_inverse.cu",
        replaces="src/repro/kernels/jpeg_inverse.py:61",
        mismatches=mism, max_abs_err=err,
        ms=_time_ms(lambda: ops.jpeg_inverse(c)),
        plain_ms=_time_ms(lambda: ops.jpeg_inverse(c, impl="ref"), reps=3),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        shape=list(c.shape))
    del c
    torch.cuda.empty_cache()
    results.update(_check_per_tile_kernels(size, gen))
    return results


def _check_per_tile_kernels(size: int, gen) -> dict:
    """rgb2ycbcr and dct8x8_quant at the per-tile path's shapes (one
    256² tile; one of its planes), bit-exact; also timed on a level.

    At the tile's shape ``ms`` and ``library_ms`` are per call replayed
    from a CUDA graph (``_graph_ms``: device time), while ``call_ms`` (the
    kernel's wrapper) and ``plain_ms`` (whose quantization table upload a
    graph cannot hold) are per call of a loop from the host
    (``_per_call_ms``); at the level's shape all are single calls
    (``_time_ms``). ``rgb2ycbcr``'s library call is
    one ``torch.addmm``: the 3×3 colour matrix times the (3, H·W) pixels
    plus the level-shift bias, a yardstick the port never calls (it must
    agree with the plain version within 1e-3; it rounds differently)."""
    import torch
    from repro_torch.kernels import ops, ref

    dev = gen.device
    results = {}
    mat = torch.tensor([[0.299, 0.587, 0.114],
                        [-0.168736, -0.331264, 0.5],
                        [0.5, -0.418688, -0.081312]], device=dev)
    bias = torch.tensor([[-128.0], [0.0], [0.0]], device=dev)

    def library(name, x):
        if name != "rgb2ycbcr":
            return None  # no one PyTorch call is a blockwise DCT + quant
        return lambda: torch.addmm(bias, mat, x.view(3, -1)).view(x.shape)

    def pixels(shape):
        return torch.randint(0, 256, shape, generator=gen, device=dev,
                             dtype=torch.int32).to(torch.float32)

    for name, per_tile, level, ops_per_elem, out_bytes in (
            ("rgb2ycbcr", (3, 256, 256), (3, size, size), 16 / 3, 4),
            ("dct8x8_quant", (256, 256), (size, size), 32.0, 4)):
        fn = getattr(ops, name)
        mism, err, timed = 0, 0.0, {}
        for key, shape in (("tile", per_tile), ("level", level)):
            # dct8x8_quant takes a level-shifted luma plane
            x = pixels(shape) if name == "rgb2ycbcr" else \
                ref.rgb2ycbcr_ref(pixels((3, *shape)))[0].contiguous()
            got, plain = fn(x), fn(x, impl="ref")
            torch.cuda.synchronize()
            m = int((got != plain).sum())
            if m:
                raise AssertionError(f"{name}: {m} values differ from the "
                                     f"plain version at {shape}")
            mism += m
            err = max(err, float((got - plain).abs().max()))
            lib = library(name, x)
            if lib is not None and float((lib() - plain).abs().max()) > 1e-3:
                raise AssertionError(f"{name}: the library yardstick "
                                     "disagrees with the plain version")
            bound = _bound(x.numel() * 4 + got.numel() * out_bytes,
                           x.numel() * ops_per_elem)
            tile = key == "tile"
            timed[key] = dict(
                ms=(_graph_ms if tile else _time_ms)(lambda: fn(x)),
                call_ms=_per_call_ms(lambda: fn(x)) if tile else None,
                plain_ms=(_per_call_ms if tile else _time_ms)(
                    lambda: fn(x, impl="ref")),
                library_ms=None if lib is None else (
                    _graph_ms if tile else _time_ms)(lib),
                bound=bound, shape=list(shape))
            del x, got, plain, lib
            torch.cuda.empty_cache()
        t, lv = timed["tile"], timed["level"]
        results[name] = dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces={"rgb2ycbcr": "src/repro/kernels/rgb2ycbcr.py:29",
                      "dct8x8_quant": "src/repro/kernels/dct8x8_quant.py:46"
                      }[name],
            mismatches=mism, max_abs_err=err, ms=t["ms"],
            plain_ms=t["plain_ms"], bound_ms=t["bound"][0],
            bound_by=t["bound"][1], library_ms=t["library_ms"],
            call_ms=t["call_ms"],
            ms_measures="device time per launch, 200 launches replayed "
                        "from one CUDA graph; call_ms and plain_ms: per "
                        "call of 200 back-to-back calls from the host",
            shape=t["shape"], level_shape=lv["shape"], level_ms=lv["ms"],
            level_plain_ms=lv["plain_ms"], level_bound_ms=lv["bound"][0],
            level_library_ms=lv["library_ms"])
    return results


def check_equivalence(seed: int) -> dict:
    """Phase 4 on a 4096² slide: study tars of PSV vs TIFF, pipelined vs
    sync vs per-tile, card vs CPU; the decoders on every level."""
    import numpy as np
    from repro_torch.wsi import (ConvertOptions, SyntheticScanner,
                                 convert_wsi_to_dicom, decode_tile,
                                 decode_tiles_batch, study_levels)
    from repro_torch.wsi.dicom import Part10Index
    size = 4096
    scanner = SyntheticScanner(seed=seed + 1)
    psv, tiff = scanner.scan(size, size, 256), scanner.scan_tiff(size, size,
                                                                 256)
    uids = _uids(seed + 1)

    def run(slide, **kw):
        opt = ConvertOptions(manifest={"uids": uids}, **kw)
        return convert_wsi_to_dicom(slide, {"slide_id": "smoke"}, opt)

    tars = {"psv pipelined": run(psv), "tiff pipelined": run(tiff),
            "psv sync": run(psv, pipelined=False),
            "tiff sync": run(tiff, pipelined=False),
            "psv cpu plain": run(psv, device="cpu")}
    # the per-tile path: one rgb2ycbcr + three dct8x8_quant per frame
    _zero_launches()
    t0 = time.perf_counter()
    tars["psv per-tile"] = run(psv, batched=False)
    per_tile_s = time.perf_counter() - t0
    launches = _read_launches()
    base = tars["psv pipelined"]
    for name, tar in tars.items():
        if tar != base:
            raise AssertionError(f"{size}² study tar of {name} differs")
    levels = study_levels(base)
    n_levels = json.loads(levels["study.json"])["levels"]
    frames = [Part10Index(levels[f"level_{li}.dcm"]).n_frames
              for li in range(n_levels)]
    want = {k: 0 for k in KERNELS}
    want.update(downsample2x2=n_levels - 1, rgb2ycbcr=sum(frames),
                dct8x8_quant=3 * sum(frames))
    if launches != want:
        raise AssertionError(f"per-tile path launches {launches}, expected "
                             f"{want}")
    _log(f"equivalence {size}²: {len(tars)} study tars byte-identical "
         f"({len(base)} bytes); per-tile path {per_tile_s:.2f} s for "
         f"{sum(frames)} frames, launches {launches}")

    t0 = time.perf_counter()
    for li in range(n_levels):
        idx = Part10Index(levels[f"level_{li}.dcm"])
        jpgs = [idx.read_frame(i) for i in range(idx.n_frames)]
        card = decode_tiles_batch(jpgs, device="cuda")
        if not np.array_equal(card, decode_tiles_batch(jpgs, device="cpu")):
            raise AssertionError(f"level {li}: batched decode on the card "
                                 "differs from the CPU plain path")
        per = np.stack([decode_tile(j, device="cuda") for j in jpgs])
        if not np.array_equal(card, per):
            raise AssertionError(f"level {li}: decode_tiles_batch differs "
                                 "from decode_tile per frame")
    decode_s = time.perf_counter() - t0
    _log(f"equivalence {size}²: {n_levels} levels decode pixel-identical "
         f"(batched on the card, per tile on the card, batched on the CPU) "
         f"in {decode_s:.2f} s")
    return dict(size=size, per_tile_s=per_tile_s, per_tile_frames=sum(frames),
                launches=launches, decode_check_s=decode_s)


def run_main_path(size: int, slide: bytes, seed: int) -> dict:
    """Phase 5: one size² slide through the pipelined engine on the card.

    Returns the study tar and the phase's numbers."""
    import torch
    import repro_torch.wsi.convert as cv
    from repro_torch.wsi import ConvertOptions, study_levels
    from repro_torch.wsi.dicom import Part10Index

    stage = {"upload": 0.0, "fetch_enqueue": 0.0, "entropy": 0.0,
             "wrap": 0.0, "pack": 0.0}
    events = []

    def timed(name, fn, sync=False):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            stage[name] += time.perf_counter() - t0
            return out
        return wrapper

    def evented(fn):
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            events.append(ev)
            return out
        return wrapper

    originals = {k: getattr(cv, k) for k in (
        "_upload_level0", "_fetch_async", "encode_coef_batch", "_wrap_level",
        "_pack_study", "jpeg_transform", "downsample2x2")}
    cv._upload_level0 = evented(timed("upload", originals["_upload_level0"],
                                      sync=True))
    cv._fetch_async = timed("fetch_enqueue", originals["_fetch_async"])
    cv.encode_coef_batch = timed("entropy", originals["encode_coef_batch"])
    cv._wrap_level = timed("wrap", originals["_wrap_level"])
    cv._pack_study = timed("pack", originals["_pack_study"])
    cv.jpeg_transform = evented(originals["jpeg_transform"])
    cv.downsample2x2 = evented(originals["downsample2x2"])
    try:
        opt = ConvertOptions(manifest={"uids": _uids(seed)}, device="cuda")
        _zero_launches()
        cv.TRANSFER_STATS.reset()
        t0 = time.perf_counter()
        tar = cv.convert_wsi_to_dicom(slide, {"slide_id": "smoke"}, opt)
        wall = time.perf_counter() - t0
        launches = _read_launches()
        stats = (cv.TRANSFER_STATS.uploads, cv.TRANSFER_STATS.dispatches,
                 cv.TRANSFER_STATS.fetches)
    finally:
        for k, v in originals.items():
            setattr(cv, k, v)
    device_ms = events[0].elapsed_time(events[-1])

    levels = study_levels(tar)
    n_levels = json.loads(levels["study.json"])["levels"]
    for li in range(n_levels):
        idx = Part10Index(levels[f"level_{li}.dcm"])
        idx.verify()
        side = size >> li
        want = (side // 256) ** 2
        if idx.n_frames != want or idx.get_int(0x0028, 0x0008) != want:
            raise AssertionError(f"level {li}: {idx.n_frames} frames, "
                                 f"expected {want}")
    expect_levels = len(cv._pyramid_dims(size, size, 256))
    if n_levels != expect_levels:
        raise AssertionError(f"{n_levels} levels, expected {expect_levels}")
    want = {k: 0 for k in KERNELS}
    want.update(jpeg_transform=n_levels, downsample2x2=n_levels - 1)
    if launches != want:
        raise AssertionError(f"kernel launches on the main path: {launches}")
    if stats != (1, 1, n_levels):
        raise AssertionError(f"uploads/dispatches/fetches: {stats}")
    mpix = size * size / 1e6
    return tar, dict(size=size, levels=n_levels, launches=launches,
                     uploads=stats[0], tar_bytes=len(tar), wall_s=wall,
                     mpix_per_s=mpix / wall, device_chain_ms=device_ms,
                     stage_s=stage,
                     host_other_s=wall - sum(stage.values()))


def run_read_side(size: int, slide: bytes, tar: bytes) -> dict:
    """Phase 6: every level of the main path's study read back on the card
    as the export service does, frames → decode_frames → write_tiff."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.wsi import decode_frames, open_slide, psnr, study_levels
    from repro_torch.wsi import jpeg as P
    from repro_torch.wsi.dicom import Part10Index
    from repro_torch.wsi.formats.tiff import write_tiff

    stage = {"parse_unstuff": 0.0, "entropy": 0.0, "inverse": 0.0,
             "d2h": 0.0}

    def timed(name, fn, sync=False):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            if sync:
                torch.cuda.synchronize()
            stage[name] += time.perf_counter() - t0
            return out
        return wrapper

    originals = {k: getattr(P, k) for k in (
        "_scans", "decode_scans", "jpeg_inverse", "_rgb_to_host")}
    P._scans = timed("parse_unstuff", originals["_scans"])
    P.decode_scans = timed("entropy", originals["decode_scans"], sync=True)
    P.jpeg_inverse = timed("inverse", originals["jpeg_inverse"], sync=True)
    P._rgb_to_host = timed("d2h", originals["_rgb_to_host"])

    levels = study_levels(tar)
    n_levels = json.loads(levels["study.json"])["levels"]
    # the reference pixels: level 0 from the slide, then the kernel chain
    dev = torch.device("cuda")
    pix = _tile_tensor(slide, dev)
    T = pix.shape[-1]
    bw = size // T
    level = pix.reshape(bw, bw, 3, T, T).permute(2, 0, 3, 1, 4).reshape(
        3, size, size)
    del pix
    rows, launches = [], {k: 0 for k in KERNELS}
    decode_s = tiff_s = 0.0
    try:
        for li in range(n_levels):
            if li:
                level = ops.downsample2x2(level)
            H = W = size >> li
            idx = Part10Index(levels[f"level_{li}.dcm"])
            n = idx.n_frames
            frames = [idx.read_frame(i) for i in range(n)]
            ts = idx.get_str(0x0002, 0x0010)
            _zero_launches()
            t0 = time.perf_counter()
            rgb = decode_frames(frames, transfer_syntax=ts, rows=T, cols=T,
                                device="cuda")
            dt = time.perf_counter() - t0
            got = _read_launches()
            want = {k: 0 for k in KERNELS}
            want.update(jpeg_inverse=1, entropy_decode=1)
            if got != want:
                raise AssertionError(f"level {li}: read-side launches {got}, "
                                     f"expected {want}")
            for k, v in got.items():
                launches[k] += v
            bh = H // T
            t0 = time.perf_counter()
            tif = write_tiff({(r, c): rgb[r * bh + c] for r in range(bh)
                              for c in range(bh)}, H, W, T,
                             description=f"chip_smoke|level = {li}")
            tt = time.perf_counter() - t0
            rd = open_slide(tif)
            if (rd.H, rd.W, rd.tile) != (H, W, T) or not np.array_equal(
                    rd.read_tile(bh - 1, bh - 1), rgb[-1]):
                raise AssertionError(f"level {li}: the exported TIFF does "
                                     "not reopen to the decoded pixels")
            tiles = level.reshape(3, bh, T, bh, T).permute(1, 3, 0, 2, 4) \
                .contiguous().view(bh * bh, 3, T, T)
            got_px = torch.from_numpy(rgb).to(dev).permute(0, 3, 1, 2)
            if not torch.equal(got_px, ops.jpeg_inverse(
                    ops.jpeg_transform(tiles))):
                raise AssertionError(f"level {li}: decoded pixels differ "
                                     "from the codec's round trip")
            mse = float(((got_px.float() - tiles) ** 2).mean(
                dtype=torch.float64))
            db = float(10 * np.log10(255.0 ** 2 / max(mse, 1e-12)))
            if db <= (PSNR_MIN_DB_LEVEL0 if li == 0 else PSNR_MIN_DB):
                raise AssertionError(f"level {li}: PSNR {db:.2f} dB")
            if li == n_levels - 1:  # the host formula, on one tile
                db_tile = psnr(rgb[0], tiles[0].permute(1, 2, 0).cpu()
                               .numpy())
                if abs(db_tile - db) > 1e-6 * db:
                    raise AssertionError("PSNR on the card and on the host "
                                         "disagree")
            decode_s += dt
            tiff_s += tt
            rows.append(dict(level=li, frames=n, decode_s=dt, tiff_s=tt,
                             tiff_bytes=len(tif), psnr_db=db))
            del rgb, tif, got_px, tiles
    finally:
        for k, v in originals.items():
            setattr(P, k, v)
    del level
    torch.cuda.empty_cache()
    mpix = sum((size >> li) ** 2 for li in range(n_levels)) / 1e6
    return dict(levels=rows, launches=launches, decode_s=decode_s,
                tiff_s=tiff_s, stage_s=stage,
                decode_mpix_per_s=mpix / decode_s,
                export_mpix_per_s=mpix / (decode_s + tiff_s))


def check_entropy_decode(tar: bytes) -> dict:
    """Phase 7: entropy_decode on level 0's frames vs its plain version and
    the numpy engine, errors included."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.wsi import jpeg as P, study_levels
    from repro_torch.wsi.dicom import Part10Index
    from repro_torch.wsi.entropy import _device_lut, pack_scans

    idx = Part10Index(study_levels(tar)["level_0.dcm"])
    frames = [idx.read_frame(i) for i in range(idx.n_frames)]
    scans, H, W = P._scans(frames)
    dev = torch.device("cuda")
    buf, offs, nbits = (torch.from_numpy(a).to(dev) for a in pack_scans(scans))
    args = (buf, offs, nbits, _device_lut(dev), H, W)
    got = ops.entropy_decode(*args)
    t0 = time.perf_counter()
    plain = ops.entropy_decode(*args, impl="ref")
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    for name, a, b in zip(("coef", "stop", "kind"), got, plain):
        if not torch.equal(a, b):
            raise AssertionError(f"entropy_decode: {name} differs from the "
                                 "plain version")
    if int(got[2].max()):
        raise AssertionError("entropy_decode: a clean frame failed")
    t0 = time.perf_counter()
    oracle = P.decode_coef_batch(frames, device="cpu", engine="numpy")
    numpy_s = time.perf_counter() - t0
    if not torch.equal(got[0].cpu(), oracle):
        raise AssertionError("entropy_decode: coefficients differ from the "
                             "numpy engine")
    # corrupt frames: a truncated one and a bit-flipped one among good ones
    _, _, start, _ = P._parse_jfif(frames[2])
    flipped = bytearray(frames[2])
    flipped[start + 40] ^= 0x10
    batch = [frames[0], frames[1][: len(frames[1]) // 2] + b"\xff\xd9",
             bytes(flipped), frames[3]]
    errs = []
    for device, engine in (("cuda", "kernel"), ("cpu", "numpy")):
        try:
            P.decode_coef_batch(batch, device=device, engine=engine)
            errs.append(None)
        except ValueError as exc:
            errs.append(str(exc))
    if errs[0] is None or errs[0] != errs[1]:
        raise AssertionError(f"entropy_decode errors differ: {errs}")
    symbols = got[1].long() + 1
    coef = got[0]
    nbytes = (coef.numel() * 4 + buf.numel() + len(scans) * (8 + 4 + 4 + 4)
              + args[3].numel() * 2)
    bound_ms, bound_by = _bound(nbytes, 0.0)
    ms = _time_ms(lambda: ops.entropy_decode(*args))
    longest = int(symbols.max())
    return dict(
        name="entropy_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/entropy_decode.cu",
        replaces="src/repro/wsi/entropy_jax.py:55",
        mismatches=0, max_abs_err=0.0, ms=ms,
        plain_ms=_time_ms(lambda: ops.entropy_decode(*args, impl="ref"),
                          reps=2, warmup=0),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        shape=[len(scans), 3, H, W], scan_bytes=int(buf.numel()),
        longest_tile_symbols=longest, total_symbols=int(symbols.sum()),
        ns_per_symbol_longest_tile=ms * 1e6 / longest,
        numpy_engine_s=numpy_s, plain_first_call_s=plain_s,
        corrupt_batch_error=errs[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--size", type=int, default=16384,
                    help="main-path slide edge in pixels (multiple of 256)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch is missing)", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.wsi import SyntheticScanner

    # 1. device
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _log(f"device: {kind}; torch {torch.__version__}, CUDA "
         f"{torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build_all()
    _log(f"build: {len(logs)} kernel(s) compiled in "
         f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Used" in line or "spill" in line:
                _log(f"  {name}: {line.strip()}")

    # the main path's slide, also the source of phase 3's slide tiles
    t0 = time.perf_counter()
    slide = SyntheticScanner(seed=args.seed).scan(args.size, args.size, 256)
    scan_s = time.perf_counter() - t0
    _log(f"scan: {args.size}² PSV slide, {len(slide)} bytes, {scan_s:.2f} s")

    # 3. kernels vs plain versions
    kernels = check_kernels(args.size, slide, args.seed)
    for k in kernels.values():
        _log(f"kernel {k['name']}: {k['mismatches']} mismatches, "
             f"{k['ms']:.3f} ms (plain {k['plain_ms']:.3f}, bound "
             f"{k['bound_ms']:.3f} by {k['bound_by']})")

    # 4. equivalence at 4096², the per-tile path with its launch counts
    per_tile = check_equivalence(args.seed)

    # 5. the main path
    tar, main_path = run_main_path(args.size, slide, args.seed)
    main_path["stage_s"] = {"scan": scan_s, **main_path["stage_s"]}
    _log("main path: " + json.dumps(main_path))

    # 6. the read side of the main path's study
    read_side = run_read_side(args.size, slide, tar)
    _log("read side: " + json.dumps(read_side))

    # 7. entropy_decode on level 0's frames
    kernels["entropy_decode"] = check_entropy_decode(tar)
    _log("kernel entropy_decode: " + json.dumps(kernels["entropy_decode"]))

    # each kernel's launches in the run of the path that drives it
    path_of = {"downsample2x2": main_path, "jpeg_transform": main_path,
               "rgb2ycbcr": per_tile, "dct8x8_quant": per_tile,
               "jpeg_inverse": read_side, "entropy_decode": read_side}
    for name, k in kernels.items():
        k["launches"] = path_of[name]["launches"][name]
        if not k["launches"]:
            raise AssertionError(f"{name} was not launched on its path")

    _log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
