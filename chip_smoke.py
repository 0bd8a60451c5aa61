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
   ``jpeg_inverse`` on the coefficients of both (bit-exact); both also at
   the tile count of every level of the study (``level_ms``: the first
   4096, 1024, …, 1 slide tiles, one call each, with ``level_bound_ms``
   and the sums; ``copy_ms``, a PyTorch copy of level 0's bytes:
   ``block_levels``);
   ``rgb2ycbcr`` and ``dct8x8_quant`` at the per-tile shapes (3, 256, 256)
   and (256, 256), at a level's shape and on one 8×8 block (bit-exact;
   ``dct8x8_quant`` on noise and on the slide's luma, ``slide_*``); each
   timed with CUDA events (median of 10; at the per-tile shapes per
   launch of 200 launches replayed from one CUDA graph, ``floor_ms`` so on
   the 8×8 block, and per call of 200 calls from the host) beside its
   plain version, ``bound_ms`` (the least time the card could take: the
   larger of bytes over the memory rate and operations over the float32
   rate) and, where one PyTorch call computes the same function, that
   call's time; ``call_breakdown_us``: the host time of each piece of a
   per-tile wrapper call;
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
7. ``entropy_decode`` on level 0's frames and on a batch with corrupt
   frames: its coefficients, stops and error kinds equal to its plain
   version's (the lockstep) and its plain mirror's
   (``ref.entropy_decode_subseq_ref``, run on the card), its sync rounds
   per tile (the kernel's debug output) equal to the mirror's, its
   coefficients equal to the numpy engine's on level 0 and its error
   string equal to the numpy engine's on the corrupt batch; ``ms`` is one
   call at level 0 beside its bytes bound (``plain_ms`` one plain call),
   ``level_ms`` one call at each level of the study (CUDA events, median
   of 10) and ``decode_scans_s`` the read side's entropy stage at each
   level (host clock, median of 3), with the rounds
   (``rounds_max``, ``rounds_mean``), how many times each symbol was
   decoded over the kernel's passes (``decodes_per_symbol``), the share of
   lookups that fell through to the 16-bit table (``slow_lookup_share``)
   and the longest tile's symbol count;
8. ``wkv_chunk`` (RWKV6's chunked wkv) vs its plain version at the serving
   path's prefill shape (1, 2048, 40, 64) and a tail shape (1, 200, 40,
   64), from a random state, decays drawn as tests/test_kernels.py draws
   them (up to 2 and 25): output and final state within the reference's
   bound ``max|Δ| / (max|plain| + 1) < 5e-4``; timed beside its bound,
   with the device time of each of the three kernels a call launches
   (``passes_ms``, by ``torch.profiler``);
9. serving — ``rwkv6-3b`` at full width (3.1 B parameters in bf16, random
   from a seeded generator) in the continuous-batching engine, 4 slots,
   ``max_len`` 4096, six greedy requests of 32 new tokens with prompts of
   2048, 1024, 512, 256, 100 and 64 tokens, submitted and ticked as a user
   runs the engine: with the launch counts zeroed just before, one
   ``wkv_chunk`` launch per layer per prefill (192) and no other kernel;
   prefill tokens/s per prompt length (the engine's prefill call, timed
   alone), decode tokens/s and tokens per tick. Then engine runs that
   record their logits (a subclass that keeps them as ``_greedy`` picks
   each token): the kernel again (tokens equal to the main path's), the
   plain wkv with each of its 192 calls also run through the kernel on the
   same activations and held to the bound above, and a witness: the plain
   wkv summed in another order (chunks of 32), an exact reordering whose
   float32 difference is the kernel's size. This random bf16 model
   amplifies such a difference in one layer's rounding into a large share
   of the largest logit over 32 layers, so the witness measures how far
   two correct runs part (its spread: the largest max|Δ| / max|plain| of
   a prefill's logits). The kernel's bf16 run is held to twice that
   spread; the same pair in float32 compute (same bf16 weights) to 2e-3.
   Each request's tokens must be equal up to the first step at which they
   part, which is allowed only where the plain run's top-2 logit gap is
   below twice the bound times the step's largest logit. One 2048-token
   prefill and one decode step are then profiled (``torch.profiler``):
   kernel time beside the host wall time, the device's busy share, and
   the prefill's ``wkv_ms`` / ``wkv_share``: the summed device time of the
   kernels ``wkv_chunk`` launches (three a layer) and its share; all 96
   must be in the trace. ``lead_ms``: the first kernel's start in it;
10. the event-driven pipeline on the card — four 8192² slides (256²
    tiles; two PSV, two TIFF; UIDs pinned from each slide id) ingested
    into the landing bucket of a ``ConversionPipeline`` on a
    ``RealScheduler`` (8 workers), with the port's lockdep and racedep
    armed: landing bucket → ``OBJECT_FINALIZE`` → topic → push
    subscription → ``ConverterFleet`` → ``convert_wsi_to_dicom`` on
    ``cuda`` in worker threads → study tar → ingest subscription → the
    2-shard DICOM store → validation and ML-inference subscribers (frames
    decoded on the card). Run A is serial (one instance, concurrency 1);
    run B the same with two instances of concurrency 2 (up to four
    conversions in flight on the card), then an ``export-request`` of one
    study. With the launch counts zeroed before each run: ``jpeg_transform``
    once per level, ``downsample2x2`` once per level step, ``entropy_decode``
    and ``jpeg_inverse`` launched by inference and export. Gates: 4/4
    converted and nothing dead-lettered in each run, run B's tars equal to
    run A's and slide 0's to a direct conversion, levels × slides instances
    stored, zero detector violations, one span tree per slide holding
    ``pipeline.convert`` → ``convert.slide`` → ``convert.entropy``, the
    exported level-0 TIFF equal to ``decode_frames`` of the stored frames.
    Prints each run's batch wall time and level-0 MPix/s, the summed
    ``pipeline.convert`` span time, the ``convert.*`` spans' shares, peak
    device memory, inference frames and export MPix/s.

Prints the kernel JSON line and the card line before the last line, which
is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import json
import math
import re
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
           "dct8x8_quant", "entropy_decode", "wkv_chunk")
# the reference's bound for its wkv kernel (tests/test_kernels.py)
WKV_BOUND = 5e-4
# what the names of the kernels that one wkv_chunk call launches contain
WKV_KERNEL_MATCH = "wkv_pass"
# idle time at each end of a profiled window: the profiler drops a kernel
# whose device timestamp, mapped to the host clock, falls outside the
# window, and on an H100 that mapping has read a few ms early, so the
# first kernels of a profiled 2048-token prefill were at times lost
# (a profile's ``lead_ms`` reads the pad and the host's time to its first
# launch, less that error)
PROFILE_PAD_S = 0.05
# serving: prompt lengths (their plain prefill stays small: a length that
# is not a multiple of 64 makes the plain wkv build an (S, S, H, K) tensor,
# 100 MB at S = 100), new tokens, slots, max_len
SERVE_PROMPTS = (2048, 1024, 512, 256, 100, 64)
SERVE_NEW = 32
SERVE_SLOTS = 4
SERVE_MAX_LEN = 4096
# max|Δ| / max|plain| of a run's prefill logits vs the plain run's (module
# doc): in float32 a fixed bound; in bf16 this factor times the witness's
# spread (the plain wkv summed in another order, vs the plain wkv)
LOGIT_REL_F32 = 2e-3
WITNESS_FACTOR = 2.0


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


def _transform_bound(tiles) -> tuple[float, str]:
    """jpeg_transform: 12 B in and 12 B out a pixel, ~112 operations."""
    return _bound(tiles.numel() * 4 * 2, tiles.numel() // 3 * 112.0)


def _inverse_bound(coef) -> tuple[float, str]:
    """jpeg_inverse: 12 B in and 3 B out a pixel, ~111 operations."""
    return _bound(coef.numel() * 4 + coef.numel(), coef.numel() // 3 * 111.0)


def block_levels(tiles) -> dict:
    """``jpeg_transform`` and ``jpeg_inverse`` at the tile counts of each
    level of the study (4096, 1024, …, 1 for a 16384² slide): the first n
    of level 0's (N, 3, 256, 256) batch ``tiles``, the inverse on the
    transform's coefficients of them. ``level_ms``: one call through the
    wrapper at each level (CUDA events, median of 10), each beside its
    bound; ``copy_ms``: at level 0, one PyTorch copy that moves the same
    bytes with no arithmetic (float32 → float32 for the transform, int32 →
    uint8 for the inverse), what the card's memory delivers to a plain
    streaming kernel. It uses whichever ``repro_torch`` is first on
    ``sys.path``, so it times another commit's tree too."""
    import torch
    from repro_torch.kernels import ops

    counts = []
    n = tiles.shape[0]
    while n >= 1:
        counts.append(n)
        n //= 4
    out = {name: dict(level_tiles=counts, level_ms=[], level_bound_ms=[])
           for name in ("jpeg_transform", "jpeg_inverse")}
    for n in counts:
        t = tiles[:n]
        c = ops.jpeg_transform(t)
        for name, fn, x, bound in (
                ("jpeg_transform", ops.jpeg_transform, t, _transform_bound),
                ("jpeg_inverse", ops.jpeg_inverse, c, _inverse_bound)):
            out[name]["level_ms"].append(_time_ms(lambda: fn(x)))
            out[name]["level_bound_ms"].append(bound(x)[0])
        del t, c
        torch.cuda.empty_cache()
    dst = torch.empty_like(tiles)
    out["jpeg_transform"]["copy_ms"] = _time_ms(lambda: dst.copy_(tiles))
    dst = torch.empty(tiles.shape, dtype=torch.uint8, device=tiles.device)
    c = tiles.to(torch.int32)
    out["jpeg_inverse"]["copy_ms"] = _time_ms(lambda: dst.copy_(c))
    del dst, c
    torch.cuda.empty_cache()
    for row in out.values():
        row["level_ms_sum"] = sum(row["level_ms"])
        row["level_bound_ms_sum"] = sum(row["level_bound_ms"])
    return out


def block_levels_ab(tiles0: int, seed: int) -> dict:
    """:func:`block_levels` on ``tiles0`` 256² tiles of two kinds: uniform
    u8 noise (made on the card from ``seed``) and slide tiles (the 256
    tiles of a 4096² SyntheticScanner slide from ``seed``, repeated), whose
    flat blocks give the transform many sums of exactly 0. Like
    ``entropy_levels``, it times whichever ``repro_torch`` is first on
    ``sys.path``: to compare two trees on one card, call it in one process
    per tree with that tree's ``src`` first (parent, this, this, parent;
    PERF.md's A/B)."""
    import torch
    from repro_torch.wsi import SyntheticScanner
    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = torch.randint(0, 256, (tiles0, 3, 256, 256), generator=gen,
                          device="cuda", dtype=torch.int32).to(torch.float32)
    out = {"noise": block_levels(noise)}
    del noise
    scan = _tile_tensor(SyntheticScanner(seed=seed).scan(4096, 4096, 256),
                        torch.device("cuda"))
    slide = scan.repeat(-(-tiles0 // scan.shape[0]), 1, 1, 1)[:tiles0]
    out["slide"] = block_levels(slide.contiguous())
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
    bound_ms, bound_by = _transform_bound(tiles)
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
    bound_ms, bound_by = _inverse_bound(c)
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
    for name, levels in block_levels(tiles).items():
        results[name].update(levels)
    torch.cuda.empty_cache()
    results.update(_check_per_tile_kernels(size, gen, tiles))
    del tiles
    torch.cuda.empty_cache()
    return results


def _level_image(tiles, cols: int):
    """The (3, rows·T, cols·T) image of a row-major (rows·cols, 3, T, T)
    tile batch."""
    n, _, t, _ = tiles.shape
    return tiles.view(n // cols, cols, 3, t, t).permute(2, 0, 3, 1, 4) \
        .reshape(3, n // cols * t, cols * t)


def _per_tile_inputs(pixels) -> dict:
    """Each per-tile kernel's inputs cut from a (3, S, S) image: at the
    tile's shape (256², from the image's centre), at the level's (the whole
    image) and at one 8×8 block (``point``, the launch floor).
    ``dct8x8_quant`` takes the image's level-shifted luma plane."""
    from repro_torch.kernels import ref
    c = pixels.shape[1] // 2 // 256 * 256
    luma = ref.rgb2ycbcr_ref(pixels)[0].clone()  # frees Cb and Cr
    return {"rgb2ycbcr": dict(tile=pixels[:, c:c + 256, c:c + 256],
                              level=pixels, point=pixels[:, c:c + 8, c:c + 8]),
            "dct8x8_quant": dict(tile=luma[c:c + 256, c:c + 256],
                                 level=luma, point=luma[c:c + 8, c:c + 8])}


def _copy_ms(x) -> float:
    """One PyTorch copy of ``x``'s bytes into a tensor like it: what the
    card's memory delivers to a plain streaming kernel."""
    dst = x.new_empty(x.shape)
    return _time_ms(lambda: dst.copy_(x))


def _per_tile_times(fn, x: dict) -> dict:
    """``ms``: device time per launch at the tile's shape, 200 launches
    replayed from one CUDA graph; ``call_ms``: per call of 200 back-to-back
    calls from the host; ``floor_ms``: as ``ms``, on one 8×8 block, what
    any launch of the kernel costs; ``level_ms``: one call at the level's
    shape (CUDA events, median of 10)."""
    tile, level, point = (x[k].contiguous() for k in ("tile", "level",
                                                       "point"))
    return dict(ms=_graph_ms(lambda: fn(tile)),
                call_ms=_per_call_ms(lambda: fn(tile)),
                floor_ms=_graph_ms(lambda: fn(point)),
                level_ms=_time_ms(lambda: fn(level)))


def call_breakdown_us(calls: int = 200) -> dict:
    """Host time of the pieces of one per-tile wrapper call at the tile's
    shape, each timed alone: ``time.perf_counter_ns`` around one call,
    median of ``calls`` after 10 warm-up calls, in µs.

    Pieces: ``checks`` (``ops._launches_kernel``), ``pointers`` (the
    tensors' ``data_ptr()``), ``empty_like`` (the output's allocation),
    ``current_device`` and ``raw_stream`` (``ops._launch``'s
    ``torch._C._cuda_getDevice`` and ``_cuda_getCurrentRawStream``), for
    ``dct8x8_quant`` ``table`` (``ops._host_table`` and the table's
    ``.ctypes`` address); ``call`` is the whole wrapper and ``rest`` the
    call less the pieces: the ctypes call and ``cudaLaunchKernel``."""
    import torch
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    idx = torch.cuda.current_device()
    img = torch.zeros((3, 256, 256), device=dev)
    plane = torch.zeros((256, 256), device=dev)
    q = ref.JPEG_CHROMA_Q

    def us(fn) -> float:
        for _ in range(10):
            fn()
        ts = []
        for _ in range(calls):
            t0 = time.perf_counter_ns()
            fn()
            ts.append(time.perf_counter_ns() - t0)
        torch.cuda.synchronize()
        return statistics.median(ts) / 1e3

    shared = dict(
        current_device=us(torch._C._cuda_getDevice),
        raw_stream=us(lambda: torch._C._cuda_getCurrentRawStream(idx)),
        pointers=us(lambda: (img.data_ptr(), plane.data_ptr())))
    out = {}
    for name, x, args, dtype in (
            ("rgb2ycbcr", img, (), torch.float32),
            ("dct8x8_quant", plane, (q,), torch.int32)):
        fn = getattr(ops, name)
        row = dict(
            shared,
            checks=us(lambda: ops._launches_kernel(x, name, x.dim(), "auto")),
            empty_like=us(lambda: torch.empty_like(x, dtype=dtype)))
        if name == "dct8x8_quant":
            row["table"] = us(lambda: ops._host_table(q).ctypes.data)
        pieces = sum(row.values())
        row["call"] = us(lambda: fn(x, *args))
        row["rest"] = row["call"] - pieces
        out[name] = row
    return out


def per_tile_ab(seed: int, size: int = 16384) -> dict:
    """``rgb2ycbcr`` and ``dct8x8_quant`` timed as :func:`_per_tile_times`
    does (``ms``, ``call_ms``, ``floor_ms``, ``level_ms`` at (3, size,
    size) and (size, size)) on uniform u8 noise (made on the card from
    ``seed``) and, for ``dct8x8_quant``, on slide content too (the 256
    tiles of a 4096² SyntheticScanner slide from ``seed``, repeated to a
    size² level: its flat blocks give many sums of exactly 0). Like
    :func:`block_levels_ab`, it times
    whichever ``repro_torch`` is first on ``sys.path``: to compare two
    trees on one card, call it in one process per tree with that tree's
    ``src`` first (parent, this, this, parent; PERF.md's A/B)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.wsi import SyntheticScanner

    gen = torch.Generator(device="cuda").manual_seed(seed)
    noise = _per_tile_inputs(torch.randint(
        0, 256, (3, size, size), generator=gen, device="cuda",
        dtype=torch.int32).to(torch.float32))
    out = {"rgb2ycbcr": _per_tile_times(ops.rgb2ycbcr, noise["rgb2ycbcr"]),
           "dct8x8_quant": {"noise": _per_tile_times(
               ops.dct8x8_quant, noise["dct8x8_quant"])}}
    out["rgb2ycbcr"]["level_copy_ms"] = _copy_ms(noise["rgb2ycbcr"]["level"])
    del noise
    torch.cuda.empty_cache()
    scan = _tile_tensor(SyntheticScanner(seed=seed).scan(4096, 4096, 256),
                        torch.device("cuda"))
    cols = size // 256
    slide = _per_tile_inputs(_level_image(
        scan.repeat(-(-cols * cols // scan.shape[0]), 1, 1, 1)[:cols * cols],
        cols))
    out["dct8x8_quant"]["slide"] = _per_tile_times(
        ops.dct8x8_quant, slide["dct8x8_quant"])
    del slide, scan
    torch.cuda.empty_cache()
    return out


def _check_per_tile_kernels(size: int, gen, tiles) -> dict:
    """rgb2ycbcr and dct8x8_quant at the per-tile path's shapes (one 256²
    tile; its luma plane), at a level's (3, size, size) and (size, size)
    and on one 8×8 block, bit-exact: ``rgb2ycbcr`` on uniform u8 noise,
    ``dct8x8_quant`` on the luma of that noise and of the slide's level 0
    (``tiles``, its (N, 3, 256, 256) batch), whose flat blocks give sums of
    exactly 0.

    Times as :func:`_per_tile_times` (``dct8x8_quant``'s ``slide_*`` on
    slide content); ``plain_ms`` per call of a loop from the host at the
    tile (its quantization table upload a graph cannot hold) and one call
    at the level, ``library_ms`` as ``ms`` and ``level_ms``.
    ``rgb2ycbcr``'s library call is one ``torch.addmm``: the 3×3 colour
    matrix times the (3, H·W) pixels plus the level-shift bias, a
    yardstick the port never calls (it must agree with the plain version
    within 1e-3; it rounds differently)."""
    import torch
    from repro_torch.kernels import ops

    dev = gen.device
    mat = torch.tensor([[0.299, 0.587, 0.114],
                        [-0.168736, -0.331264, 0.5],
                        [0.5, -0.418688, -0.081312]], device=dev)
    bias = torch.tensor([[-128.0], [0.0], [0.0]], device=dev)
    inputs = {"noise": _per_tile_inputs(torch.randint(
        0, 256, (3, size, size), generator=gen, device=dev,
        dtype=torch.int32).to(torch.float32)),
        "slide": _per_tile_inputs(_level_image(tiles, size // 256))}
    del inputs["slide"]["rgb2ycbcr"]  # its arithmetic has no flat path
    results = {}
    for name, ops_per_elem in (("rgb2ycbcr", 16 / 3),
                               ("dct8x8_quant", 32.0)):
        fn = getattr(ops, name)
        mism, err, row = 0, 0.0, {}
        for kind, per_kernel in inputs.items():
            if name not in per_kernel:
                continue
            x = {k: v.contiguous() for k, v in per_kernel[name].items()}
            for key, xs in x.items():
                got, plain = fn(xs), fn(xs, impl="ref")
                torch.cuda.synchronize()
                m = int((got != plain).sum())
                if m:
                    raise AssertionError(f"{name}: {m} values differ from the "
                                         f"plain version on {kind} at "
                                         f"{tuple(xs.shape)}")
                mism += m
                err = max(err, float((got - plain).abs().max()))
                del got, plain
            times = _per_tile_times(fn, x)
            prefix = "" if kind == "noise" else f"{kind}_"
            row.update({prefix + k: v for k, v in times.items()})
            if kind != "noise":
                continue
            tile, level = x["tile"], x["level"]
            row["plain_ms"] = _per_call_ms(lambda: fn(tile, impl="ref"))
            row["level_plain_ms"] = _time_ms(lambda: fn(level, impl="ref"))
            if name == "rgb2ycbcr":
                row["level_copy_ms"] = _copy_ms(level)
            for key, xs in (("", tile), ("level_", level)):
                nbytes = xs.numel() * 8  # float32 in, 4-byte values out
                row[key + "bound"] = _bound(nbytes, xs.numel() * ops_per_elem)
                if name == "rgb2ycbcr":
                    def lib(xs=xs):
                        return torch.addmm(bias, mat, xs.view(3, -1)) \
                            .view(xs.shape)
                    if float((lib() - fn(xs, impl="ref")).abs().max()) > 1e-3:
                        raise AssertionError("rgb2ycbcr: the library "
                                             "yardstick disagrees with the "
                                             "plain version")
                    row[key + "library_ms"] = (
                        _graph_ms if key == "" else _time_ms)(lib)
                else:  # no one PyTorch call is a blockwise DCT + quant
                    row[key + "library_ms"] = None
            row["shape"], row["level_shape"] = list(tile.shape), \
                list(level.shape)
            del x, tile, level
        (bound_ms, bound_by), level_bound = row.pop("bound"), \
            row.pop("level_bound")
        results[name] = dict(
            name=name, route="cuda",
            source=f"src/repro_torch/kernels/csrc/{name}.cu",
            replaces={"rgb2ycbcr": "src/repro/kernels/rgb2ycbcr.py:29",
                      "dct8x8_quant": "src/repro/kernels/dct8x8_quant.py:46"
                      }[name],
            mismatches=mism, max_abs_err=err, bound_ms=bound_ms,
            bound_by=bound_by, level_bound_ms=level_bound[0], **row,
            ms_measures="device time per launch, 200 launches replayed "
                        "from one CUDA graph (floor_ms: on one 8x8 block); "
                        "call_ms and plain_ms: per call of 200 back-to-back "
                        "calls from the host; level_*: one call")
    del inputs
    torch.cuda.empty_cache()
    breakdown = call_breakdown_us()
    for name, row in breakdown.items():
        results[name]["call_breakdown_us"] = row
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


def entropy_levels(tar: bytes) -> dict:
    """``entropy_decode`` at every level of a study: one call through the
    wrapper (``level_ms``: CUDA events, median of 10) and the read side's
    entropy stage, ``decode_scans`` (``decode_scans_s``: packing, the copy
    to the card, the kernel and its read-backs; host clock, median of 3).
    It uses whichever ``repro_torch`` is first on ``sys.path``, so it times
    another commit's tree too (PERF.md's A/B)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.wsi import jpeg as P, study_levels
    from repro_torch.wsi.dicom import Part10Index
    from repro_torch.wsi.entropy import _device_lut, decode_scans, pack_scans

    dev = torch.device("cuda")
    levels = study_levels(tar)
    out = dict(level_ms=[], decode_scans_s=[], level_tiles=[])
    for li in range(json.loads(levels["study.json"])["levels"]):
        idx = Part10Index(levels[f"level_{li}.dcm"])
        scans, H, W = P._scans([idx.read_frame(i)
                                for i in range(idx.n_frames)])
        args = (*(torch.from_numpy(a).to(dev) for a in pack_scans(scans)),
                _device_lut(dev), H, W)
        out["level_ms"].append(_time_ms(lambda: ops.entropy_decode(*args)))
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            decode_scans(scans, H, W, dev)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        out["decode_scans_s"].append(statistics.median(walls))
        out["level_tiles"].append(len(scans))
        del args
        torch.cuda.empty_cache()
    out["level_ms_sum"] = sum(out["level_ms"])
    out["decode_scans_s_sum"] = sum(out["decode_scans_s"])
    return out


def entropy_plain(args) -> tuple:
    """One call of ``entropy_decode``'s plain version (the lockstep) on
    ``args``: its outputs and its time in ms (CUDA events). It uses
    whichever ``repro_torch`` is first on ``sys.path`` (PERF.md's A/B)."""
    import torch
    from repro_torch.kernels import ops

    ends = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    ends[0].record()
    out = ops.entropy_decode(*args, impl="ref")
    ends[1].record()
    ends[1].synchronize()
    return out, ends[0].elapsed_time(ends[1])


def check_entropy_decode(tar: bytes) -> dict:
    """Phase 7: entropy_decode on level 0's frames vs its plain version, its
    plain mirror (the kernel's sync rounds included) and the numpy engine,
    errors included; the kernel's time at every level of the study."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.wsi import jpeg as P, study_levels
    from repro_torch.wsi.dicom import Part10Index
    from repro_torch.wsi.entropy import _device_lut, pack_scans

    dev = torch.device("cuda")
    levels = study_levels(tar)

    def frames_of(li):
        idx = Part10Index(levels[f"level_{li}.dcm"])
        return [idx.read_frame(i) for i in range(idx.n_frames)]

    def args_of(frames):
        scans, H, W = P._scans(frames)
        return (*(torch.from_numpy(a).to(dev) for a in pack_scans(scans)),
                _device_lut(dev), H, W)

    def held_to_plain_and_mirror(args, what):
        """The kernel's three outputs equal the plain version's and the
        mirror's; its rounds (debug output) equal the mirror's."""
        stats = torch.empty((args[1].numel(), 3), dtype=torch.int32,
                            device=dev)
        got = ops.entropy_decode(*args, stats=stats)
        *mirror, rounds = ref.entropy_decode_subseq_ref(
            *args, ops.ENTROPY_THREADS)
        plain, plain_ms = entropy_plain(args)
        for name, a, b, c in zip(("coef", "stop", "kind"), got, plain,
                                 mirror):
            if not torch.equal(a, b):
                raise AssertionError(f"entropy_decode: {name} differs from "
                                     f"the plain version on {what}")
            if not torch.equal(a, c):
                raise AssertionError(f"entropy_decode: {name} differs from "
                                     f"the plain mirror on {what}")
        if not torch.equal(stats[:, 0], rounds):
            raise AssertionError(f"entropy_decode: sync rounds differ from "
                                 f"the plain mirror's on {what}")
        del mirror, plain
        return got, stats, plain_ms

    frames = frames_of(0)
    args = args_of(frames)
    H, W = args[4:]
    (coef, stop, kind), stats, plain_ms = held_to_plain_and_mirror(
        args, "level 0")
    if int(kind.max()):
        raise AssertionError("entropy_decode: a clean frame failed")
    t0 = time.perf_counter()
    oracle = P.decode_coef_batch(frames, device="cpu", engine="numpy")
    numpy_s = time.perf_counter() - t0
    if not torch.equal(coef.cpu(), oracle):
        raise AssertionError("entropy_decode: coefficients differ from the "
                             "numpy engine")
    del oracle
    # corrupt frames: a truncated one and a bit-flipped one among good ones
    _, _, start, _ = P._parse_jfif(frames[2])
    flipped = bytearray(frames[2])
    flipped[start + 40] ^= 0x10
    batch = [frames[0], frames[1][: len(frames[1]) // 2] + b"\xff\xd9",
             bytes(flipped), frames[3]]
    (_, _, bad_kind), _, _ = held_to_plain_and_mirror(args_of(batch),
                                                      "the corrupt batch")
    if not int(bad_kind.max()):
        raise AssertionError("entropy_decode: the corrupt batch decoded")
    errs = []
    for device, engine in (("cuda", "kernel"), ("cpu", "numpy")):
        try:
            P.decode_coef_batch(batch, device=device, engine=engine)
            errs.append(None)
        except ValueError as exc:
            errs.append(str(exc))
    if errs[0] is None or errs[0] != errs[1]:
        raise AssertionError(f"entropy_decode errors differ: {errs}")
    symbols = stop.long() + 1
    rounds = stats[:, 0].double()
    decoded, slow = (int(x) for x in stats[:, 1:].sum(0).tolist())
    buf = args[0]
    nbytes = (coef.numel() * 4 + buf.numel() + len(frames) * (8 + 4 + 4 + 4)
              + args[3].numel() * 2)
    bound_ms, bound_by = _bound(nbytes, 0.0)
    del coef, stop, kind, stats
    torch.cuda.empty_cache()
    ms = _time_ms(lambda: ops.entropy_decode(*args))
    longest = int(symbols.max())
    del args
    torch.cuda.empty_cache()
    return dict(
        name="entropy_decode", route="cuda",
        source="src/repro_torch/kernels/csrc/entropy_decode.cu",
        replaces="src/repro/wsi/entropy_jax.py:55",
        mismatches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        shape=[len(frames), 3, H, W],
        scan_bytes=int(buf.numel()), threads_per_tile=ops.ENTROPY_THREADS,
        **entropy_levels(tar),
        rounds_max=int(rounds.max()), rounds_mean=float(rounds.mean()),
        decodes_per_symbol=decoded / int(symbols.sum()),
        slow_lookup_share=slow / decoded,
        longest_tile_symbols=longest, total_symbols=int(symbols.sum()),
        ns_per_symbol_longest_tile=ms * 1e6 / longest,
        numpy_engine_s=numpy_s, corrupt_batch_error=errs[0])


def _rel(got, want) -> float:
    """max|got - want| / (max|want| + 1), the reference's wkv measure."""
    return float((got - want).abs().max() / (want.abs().max() + 1.0))


def _wkv_inputs(shape, decay_max: float, gen):
    """r, k, v ~ N(0, 1); logw = -U(0.005, decay_max) as the reference test
    draws it; u ~ N(0, 1); a random initial state ~ N(0, 0.2²)."""
    import torch
    dev = gen.device
    B, S, H, K = shape
    r, k, v = (torch.randn(shape, generator=gen, device=dev)
               for _ in range(3))
    logw = -(0.005 + (decay_max - 0.005) * torch.rand(
        shape, generator=gen, device=dev))
    u = torch.randn((H, K), generator=gen, device=dev)
    state = 0.2 * torch.randn((B, H, K, K), generator=gen, device=dev)
    return r, k, v, logw, u, state


def check_wkv_chunk(seed: int) -> dict:
    """Phase 8: wkv_chunk vs its plain version at the prefill shape and a
    tail shape, output and final state within WKV_BOUND."""
    import torch
    from repro_torch.kernels import ops

    gen = torch.Generator(device=torch.device("cuda")).manual_seed(seed)
    main, tail = (1, 2048, 40, 64), (1, 200, 40, 64)
    errs, rels, timed = [], [], {}
    for shape in (main, tail):
        for decay_max in (2.0, 25.0):
            a = _wkv_inputs(shape, decay_max, gen)
            got = ops.wkv_chunk(*a)
            plain = ops.wkv_chunk(*a, impl="ref")
            torch.cuda.synchronize()
            for g, p in zip(got, plain):
                if not bool(torch.isfinite(g).all()):
                    raise AssertionError(f"wkv_chunk: non-finite values at "
                                         f"{shape}")
                rel = _rel(g, p)
                if rel >= WKV_BOUND:
                    raise AssertionError(
                        f"wkv_chunk: {rel:.3e} of the plain version at "
                        f"{shape}, decays up to {decay_max} (bound "
                        f"{WKV_BOUND})")
                rels.append(rel)
                errs.append(float((g - p).abs().max()))
            if decay_max == 2.0:
                # ms: one call alone, the wrapper's host work included;
                # back_to_back_ms: per call of 50 in a row, the device's
                # time wherever it is slower than the host's
                timed[shape] = dict(
                    ms=_time_ms(lambda: ops.wkv_chunk(*a)),
                    back_to_back_ms=_per_call_ms(lambda: ops.wkv_chunk(*a),
                                                 calls=50),
                    plain_ms=_time_ms(lambda: ops.wkv_chunk(*a, impl="ref"),
                                      reps=3, warmup=1))
            del a, got, plain
            torch.cuda.empty_cache()

    def bound(shape):
        # bytes: r, k, v, logw read and out written once, u, the state in
        # and out; operations: the least the recurrence needs per token and
        # head, 5 K^2 + 6 K: r . S (K^2 multiply-adds), S <- w S + k^T v
        # (K^2 multiplies, K^2 multiply-adds), the u bonus (r u k summed,
        # times v added to the output: 5 K) and exp(logw) (K)
        B, S, H, K = shape
        nbytes = 4 * (5 * B * S * H * K + H * K + 2 * B * H * K * K)
        return _bound(nbytes, B * S * H * (5.0 * K * K + 6.0 * K))

    # each of the call's kernels at the main shape, by the profiler
    a = _wkv_inputs(main, 2.0, gen)
    passes_ms = {}
    rows, _ = _device_kernels(lambda: ops.wkv_chunk(*a), 20)
    for key, ms, calls in rows:
        if WKV_KERNEL_MATCH in key:
            name = re.search(WKV_KERNEL_MATCH + r"\w*", key).group(0)
            passes_ms[name] = ms / 20
    if len(passes_ms) != ops.WKV_KERNELS_PER_CALL:
        raise AssertionError(f"wkv_chunk: the profiler saw kernels "
                             f"{sorted(passes_ms)}, expected "
                             f"{ops.WKV_KERNELS_PER_CALL}")
    del a
    b_main, b_tail = bound(main), bound(tail)
    return dict(
        name="wkv_chunk", route="cuda",
        source="src/repro_torch/kernels/csrc/wkv_chunk.cu",
        replaces="src/repro/kernels/wkv_chunk.py:92",
        max_abs_err=max(errs), max_rel_err=max(rels),
        rel_bound=WKV_BOUND, ms=timed[main]["ms"],
        plain_ms=timed[main]["plain_ms"], bound_ms=b_main[0],
        bound_by=b_main[1], library_ms=None,
        back_to_back_ms=timed[main]["back_to_back_ms"],
        kernels_per_call=ops.WKV_KERNELS_PER_CALL, passes_ms=passes_ms,
        scratch_mb=4e-6 * ops.wkv_scratch_floats(*main),
        shape=list(main), tail_shape=list(tail), tail_ms=timed[tail]["ms"],
        tail_back_to_back_ms=timed[tail]["back_to_back_ms"],
        tail_plain_ms=timed[tail]["plain_ms"], tail_bound_ms=b_tail[0])


def _requests(prompts, tokens: dict, max_new: int):
    from repro_torch.serve.engine import Request
    return [Request(prompt=p, max_new_tokens=max_new, req_id=i,
                    done=lambda t, i=i: tokens.update({i: t}))
            for i, p in enumerate(prompts)]


def _serve_timed(cfg, params, prompts, max_new: int = SERVE_NEW) -> dict:
    """The main path: the engine as a user runs it, every request submitted
    and ticks run until it drains, each submit and tick timed on the host
    (synchronised). Returns the tokens, the ticks' times and what each
    admitted."""
    import torch
    from repro_torch.serve.engine import ContinuousBatchingEngine

    eng = ContinuousBatchingEngine(cfg, params, batch_size=SERVE_SLOTS,
                                   max_len=SERVE_MAX_LEN)
    tokens, ticks = {}, []
    t0 = time.perf_counter()
    for req in _requests(prompts, tokens, max_new):
        eng.submit(req)
    torch.cuda.synchronize()
    submit_s = time.perf_counter() - t0
    while eng.backlog or any(eng.active):
        before = [r.req_id for r in eng.backlog]
        t1 = time.perf_counter()
        eng.tick()
        torch.cuda.synchronize()
        admitted = before[:len(before) - len(eng.backlog)]
        ticks.append((time.perf_counter() - t1, admitted))
    return dict(tokens=tokens, ticks=ticks, submit_s=submit_s,
                wall_s=time.perf_counter() - t0)


def _serve_recorded(cfg, params, prompts, impl) -> dict:
    """One engine run that keeps each request's logits at every token it
    was given (its prefill, then each tick it was active in), through the
    engine's ``_greedy``. ``impl`` goes to the prefill's wkv."""
    from repro_torch.serve.engine import ContinuousBatchingEngine

    class Recording(ContinuousBatchingEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.logits, self._admitting = {}, None

        def _prefill_into(self, b, req):
            self._admitting = req
            try:
                super()._prefill_into(b, req)
            finally:
                self._admitting = None

        def _greedy(self, logits):
            rows = [self._admitting] if self._admitting else self.active
            for row, req in zip(logits.float().cpu(), rows):
                if req is not None:
                    self.logits.setdefault(req.req_id, []).append(row)
            return super()._greedy(logits)

    eng = Recording(cfg, params, batch_size=SERVE_SLOTS,
                    max_len=SERVE_MAX_LEN, impl=impl)
    tokens = {}
    for req in _requests(prompts, tokens, SERVE_NEW):
        eng.submit(req)
    eng.run_until_drained()
    for i, seq in eng.logits.items():  # the tokens are these argmaxes
        if [int(l.argmax()) for l in seq[:len(tokens[i])]] != tokens[i]:
            raise AssertionError(f"request {i}: tokens are not the argmax "
                                 "of the recorded logits")
    return dict(tokens=tokens, logits=eng.logits)


def _shadowed_wkv(shadow: dict):
    """The plain wkv, each call also run through the kernel on the same
    inputs and held to WKV_BOUND; counts the calls in ``shadow``."""
    from repro_torch.kernels import ops

    def wkv(*a):
        out = ops.wkv_chunk(*a, impl="ref")
        kernel = ops.wkv_chunk(*a)
        rel = max(_rel(kernel[0], out[0]), _rel(kernel[1], out[1]))
        if not rel < WKV_BOUND:
            raise AssertionError(f"wkv_chunk on the model's activations at "
                                 f"{tuple(a[0].shape)}: {rel:.3e} of the "
                                 f"plain version (bound {WKV_BOUND})")
        shadow["calls"] = shadow.get("calls", 0) + 1
        shadow["max_rel_err"] = max(shadow.get("max_rel_err", 0.0), rel)
        return out
    return wkv


def _reordered_wkv(*a):
    """The plain wkv summed in another order (chunks of 32, sub-blocks of
    8): the same function, a float32 difference of the kernel's size."""
    from repro_torch.kernels import ref
    return ref.wkv_chunked_ref(*a, chunk=32, sub=8)


def _device_kernels(fn, calls: int = 1) -> tuple:
    """``(name, device ms, launches)`` of every kernel that ``calls`` calls
    of ``fn`` launch (after one unprofiled call), by ``torch.profiler``,
    longest first, and the start of the first of them in ms from the
    trace's start. The calls start and end ``PROFILE_PAD_S`` inside the
    trace's window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    rows = []  # the kernels themselves (an operator's entry repeats them)
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            rows.append((e.key, e.self_device_time_total / 1e3, e.count))
    lead_ms = min(e.time_range.start for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    return sorted(rows, key=lambda r: -r[1]), lead_ms


def _profile(fn, wall_ms: float) -> dict:
    """Kernel time inside one call of ``fn`` (the sum of every kernel's
    device time), beside the call's unprofiled host wall time ``wall_ms``:
    their ratio is the device's busy share. ``wkv_ms`` sums the kernels
    that ``wkv_chunk`` launches (``wkv_share`` of the device time).
    ``lead_ms`` is the first kernel's start in the trace."""
    rows, lead_ms = _device_kernels(fn)
    device_ms = sum(r[1] for r in rows)
    wkv = [r for r in rows if WKV_KERNEL_MATCH in r[0]]
    wkv_ms = sum(r[1] for r in wkv)
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms,
                kernels=sum(r[2] for r in rows),
                wkv_ms=wkv_ms, wkv_share=wkv_ms / device_ms,
                wkv_kernels=sum(r[2] for r in wkv), lead_ms=lead_ms,
                top=[dict(name=n[:90], ms=ms, calls=c)
                     for n, ms, c in rows[:6]])


def _compare_runs(run, plain, bound: float) -> list:
    """Each request's prefill logits within ``bound`` (max|Δ| / max|plain|)
    of the plain run's, and its tokens equal up to a first divergence,
    allowed only where the plain run's top-2 gap is below 2 · bound ·
    max|plain logits| at that step. ``bound`` = inf reports only."""
    rows = []
    for i, want in plain["tokens"].items():
        got = run["tokens"][i]
        la, lp = run["logits"][i], plain["logits"][i]
        rel = [float((a - p).abs().max() / p.abs().max())
               for a, p in zip(la, lp)]
        if rel[0] >= bound:
            raise AssertionError(f"request {i}: prefill logits {rel[0]:.3e} "
                                 f"of the plain run's (bound {bound})")
        part = next((j for j, (a, b) in enumerate(zip(got, want)) if a != b),
                    None)
        if part is None and len(got) != len(want):
            raise AssertionError(f"request {i}: {len(got)} tokens, plain "
                                 f"{len(want)}")
        gap = limit = None
        if part is not None:
            top = lp[part].topk(2).values
            gap = float(top[0] - top[1])
            limit = 2 * bound * float(lp[part].abs().max())
            if not gap < limit:
                raise AssertionError(
                    f"request {i}: tokens part at step {part} where the "
                    f"plain run's top-2 gap is {gap:.4f} (limit {limit:.4f})")
        upto = len(got) if part is None else part + 1
        rows.append(dict(request=i, prefill_logit_rel=rel[0],
                         max_logit_rel_until_parting=max(rel[:upto]),
                         tokens_equal=part is None, parted_at=part,
                         plain_top2_gap=gap,
                         gap_limit=None if limit == math.inf else limit))
    return rows


def run_serving(seed: int) -> dict:
    """Phase 9: rwkv6-3b at full width in the continuous-batching engine."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_defs

    cfg = get_config("rwkv6-3b")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in tree_defs(params))
    if n_params != M.param_count(cfg):
        raise AssertionError(f"{n_params} parameters, expected "
                             f"{M.param_count(cfg)}")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in SERVE_PROMPTS]

    def prefill_s(cfg_, impl, reps):
        """Host wall time (median of ``reps``) of the engine's prefill call
        for each prompt, synchronised."""
        out = {}
        for p in prompts:
            toks = torch.as_tensor(p, device=dev)[None].long()
            times = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                M.prefill(params, cfg_, toks, max_len=SERVE_MAX_LEN,
                          impl=impl)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
            out[len(p)] = statistics.median(times)
        return out

    # warm-up (cuBLAS handles, the kernel's module, the allocator's pools
    # at every prompt length), then the main path's run
    _serve_timed(cfg, params, prompts, max_new=2)
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    run = _serve_timed(cfg, params, prompts)
    launches = _read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = {k: 0 for k in KERNELS}
    want["wkv_chunk"] = cfg.num_layers * len(prompts)
    if launches != want:
        raise AssertionError(f"serving launches {launches}, expected {want}")
    pre_s = prefill_s(cfg, "auto", 3)

    # the comparisons, each an engine run that records its logits: the
    # kernel, the plain wkv (every call shadow-checked against the kernel)
    # and the plain wkv summed in another order, the witness of how far two
    # exact orders of float32 sums part in this bf16 model; then the kernel
    # and the plain wkv in float32 compute
    rec = _serve_recorded(cfg, params, prompts, "auto")
    if rec["tokens"] != run["tokens"]:
        raise AssertionError("the recorded run's tokens differ from the "
                             "main path's")
    shadow = {}
    plain = _serve_recorded(cfg, params, prompts, _shadowed_wkv(shadow))
    if shadow.get("calls") != want["wkv_chunk"]:
        raise AssertionError(f"shadow-checked {shadow.get('calls')} wkv "
                             "calls of the plain run")
    witness = _serve_recorded(cfg, params, prompts, _reordered_wkv)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32,
                                name=cfg.name + "+f32")
    run32 = _serve_recorded(cfg32, params, prompts, "auto")
    plain32 = _serve_recorded(cfg32, params, prompts, "ref")
    rows = {"bf16_witness": _compare_runs(witness, plain, math.inf)}
    spread = max(r["prefill_logit_rel"] for r in rows["bf16_witness"])
    if not spread > 0:
        raise AssertionError("the reordered plain wkv left every prefill's "
                             "logits unchanged: no witness")
    bounds = {"bf16": WITNESS_FACTOR * spread, "f32": LOGIT_REL_F32}
    rows["bf16"] = _compare_runs(rec, plain, bounds["bf16"])
    rows["f32"] = _compare_runs(run32, plain32, bounds["f32"])
    for rr in rows.values():
        for r in rr:
            r["prompt"] = len(prompts[r["request"]])

    decode_tokens = sum(len(t) - 1 for t in run["tokens"].values())
    # a tick's time less the prefills it admitted, each timed alone
    decode_s = sum(t for t, _ in run["ticks"]) - sum(
        pre_s[len(prompts[i])] for _, ids in run["ticks"] for i in ids)
    ms_per_tick = 1e3 * statistics.median(t for t, ids in run["ticks"]
                                          if not ids)
    # device time inside one 2048-token prefill and one 4-slot decode step
    tokens = torch.as_tensor(prompts[0], device=dev)[None].long()
    cache = M.init_cache(cfg, SERVE_SLOTS, SERVE_MAX_LEN, dev)
    step = torch.zeros((SERVE_SLOTS, 1), dtype=torch.long, device=dev)
    pos = torch.full((SERVE_SLOTS,), 100, dtype=torch.long, device=dev)
    profiles = {
        "prefill_2048": _profile(
            lambda: M.prefill(params, cfg, tokens, max_len=SERVE_MAX_LEN),
            1e3 * pre_s[len(prompts[0])]),
        "decode_step": _profile(
            lambda: M.decode_step(params, cfg, cache, step, pos),
            ms_per_tick)}
    from repro_torch.kernels import ops
    want_wkv = cfg.num_layers * ops.WKV_KERNELS_PER_CALL
    if profiles["prefill_2048"]["wkv_kernels"] != want_wkv:
        raise AssertionError(f"the profiled prefill launched "
                             f"{profiles['prefill_2048']['wkv_kernels']} "
                             f"wkv kernels, expected {want_wkv}")
    return dict(
        arch=cfg.name, params=n_params, init_s=init_s,
        launches=launches, peak_gb=peak_gb, wall_s=run["wall_s"],
        submit_s=run["submit_s"],
        prefill_tok_per_s={n: n / pre_s[n] for n in SERVE_PROMPTS},
        prefill_s=pre_s, decode_tokens=decode_tokens,
        decode_ticks=len(run["ticks"]),
        ticks_admitting=sum(1 for _, ids in run["ticks"] if ids),
        decode_s=decode_s, decode_tok_per_s=decode_tokens / decode_s,
        tokens_per_tick=decode_tokens / len(run["ticks"]),
        ms_per_tick=ms_per_tick, profiles=profiles,
        plain_prefill_s=prefill_s(cfg, "ref", 1),
        f32_prefill_s=prefill_s(cfg32, "auto", 1),
        shadow_checked_calls=shadow["calls"],
        shadow_max_rel_err=shadow["max_rel_err"],
        witness_spread=spread, logit_rel_bound=bounds, compare=rows)


# phase 10: slides through the event-driven pipeline
SPINE_SIZE = 8192
SPINE_SLIDES = 4
SPINE_TIMEOUT_S = 600.0


def _pinned_uids(slide_id: str) -> str:
    """The manifest ``"uids"`` entry minted from a slide id."""
    import hashlib
    h = hashlib.sha256(slide_id.encode()).hexdigest()
    return json.dumps(["2.25." + str(int(h[:24], 16)),
                       "2.25." + str(int(h[24:48], 16))])


def _wait_for(cond, what: str, timeout: float = SPINE_TIMEOUT_S) -> None:
    """Poll ``cond()`` until it holds; raise after ``timeout`` seconds."""
    deadline = time.perf_counter() + timeout
    while not cond():
        if time.perf_counter() > deadline:
            raise TimeoutError(f"phase 10: {what} not done after {timeout}s")
        time.sleep(0.02)


def _span_trees(tracer, n_slides: int) -> dict:
    """One trace per slide holding pipeline.convert → convert.slide →
    convert.entropy, each with one root; returns the convert.* span sums."""
    from repro_torch.core.dashboard import trace_problems
    sums = {}
    trees = 0
    for tid, spans in tracer.traces().items():
        by_name = {}
        for sp in spans:
            by_name.setdefault(sp.name, []).append(sp)
        if "pipeline.convert" not in by_name:
            continue
        problems = trace_problems([sp.to_dict() for sp in spans])
        if problems:
            raise AssertionError(f"phase 10: trace {tid}: {problems}")
        (pc,) = by_name["pipeline.convert"]
        (cs,) = by_name["convert.slide"]
        ents = by_name.get("convert.entropy", [])
        if cs.parent_id != pc.span_id or not ents or any(
                e.parent_id != cs.span_id for e in ents):
            raise AssertionError(f"phase 10: trace {tid} lacks "
                                 "pipeline.convert → convert.slide → "
                                 "convert.entropy")
        trees += 1
        for sp in spans:
            if sp.name.startswith(("convert.", "pipeline.")):
                sums[sp.name] = sums.get(sp.name, 0.0) + sp.duration()
    if trees != n_slides:
        raise AssertionError(f"phase 10: {trees} conversion traces for "
                             f"{n_slides} slides")
    return sums


def _spine_run(slides: dict, convert, *, max_instances: int,
               concurrency: int, export: bool) -> dict:
    """One pipeline run over ``slides`` with the detectors armed: the batch,
    the store/validation/inference fan-out, and optionally one export."""
    import torch
    from repro_torch.analysis import lockdep, racedep
    from repro_torch.core import ConversionPipeline, RealScheduler, tracing
    meta = {k: {"slide_id": k} for k in slides}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lockdep.arm(max_hold=30.0)
    racedep.arm()
    sched = RealScheduler(workers=8)
    try:
        with tracing.capture(now=sched.now) as tracer:
            pipe = ConversionPipeline(
                sched, convert=convert, max_instances=max_instances,
                concurrency=concurrency, fleet={}, store_shards=2,
                subscribers=True, cold_start=0.0, device="cuda")
            _zero_launches()
            t0 = time.perf_counter()
            tars = pipe.run_batch(slides, meta, timeout=SPINE_TIMEOUT_S)
            batch_s = time.perf_counter() - t0
            conv_launches = _read_launches()
            n_inst = sum(
                json.loads(_study_json(tar))["levels"] for tar in tars.values())
            store = pipe.store_service
            _wait_for(lambda: len(pipe.validator.checked) >= n_inst
                      and len(pipe.ml_subscriber.predictions) >= n_inst,
                      "store fan-out")
            export_s, export_mpix, tiff_check = None, None, None
            if export:
                study = store.search_studies()[0]
                t0 = time.perf_counter()
                pipe.request_export(study)
                _wait_for(lambda: pipe.export_service.exported, "export")
                export_s = time.perf_counter() - t0
                metas = store.search_instances(study)
                export_mpix = sum(m["total_rows"] * m["total_cols"]
                                  for m in metas) / 1e6
                tiff_check = _export_level0_matches(
                    pipe, study,
                    next(m for m in metas if m["instance_number"] == 1))
            launches = _read_launches()
            stored = sum(len(store.search_instances(u))
                         for u in store.search_studies())
            frames = pipe.metrics.get("inference.frames")
            dead = list(pipe.dead_lettered)
    finally:
        sched.shutdown()
        lock_v = lockdep.disarm()
        race_v = racedep.disarm()
    if lock_v or race_v:
        raise AssertionError(
            "phase 10: detector violations: "
            + "; ".join(str(v) for v in lock_v)
            + "; ".join(f"{v.message} ({v.first_site} / {v.second_site})"
                        for v in race_v))
    if dead or sorted(tars) != sorted(slides):
        raise AssertionError(f"phase 10: {len(tars)}/{len(slides)} "
                             f"converted, dead-lettered {dead}")
    if stored != n_inst:
        raise AssertionError(f"phase 10: the store holds {stored} "
                             f"instances, expected {n_inst}")
    sums = _span_trees(tracer, len(slides))
    slide_s = sums["convert.slide"]
    mpix = len(slides) * SPINE_SIZE * SPINE_SIZE / 1e6
    return dict(
        tars=tars, instances=n_inst, conv_launches=conv_launches,
        launches=launches, batch_s=batch_s, mpix_per_s=mpix / batch_s,
        convert_span_s=sums["pipeline.convert"],
        span_share={k: v / slide_s for k, v in sorted(sums.items())
                    if k.startswith("convert.") and k != "convert.slide"},
        peak_gb=torch.cuda.max_memory_allocated() / 1e9,
        inference_frames=frames, export_s=export_s,
        export_mpix_per_s=(export_mpix / export_s if export else None),
        export_tiff_check=tiff_check)


def _study_json(tar: bytes) -> bytes:
    from repro_torch.wsi import study_levels
    return study_levels(tar)["study.json"]


def _export_level0_matches(pipe, study: str, meta0: dict) -> str:
    """The exported level-0 TIFF, read back with open_slide, equals
    decode_frames of the stored frames, pixel for pixel."""
    import numpy as np
    from repro_torch.wsi import decode_frames, open_slide
    store = pipe.store_service
    sop = meta0["sop_instance_uid"]
    n = store.frame_index(sop).n_frames
    tile = meta0["rows"]
    want = decode_frames([store.retrieve_frame(sop, i) for i in range(n)],
                         transfer_syntax=meta0["transfer_syntax"],
                         rows=tile, cols=tile, device="cuda")
    rd = open_slide(pipe.derived.get(f"{study}/level_0.tiff").data)
    bh, bw = rd.grid
    got = np.stack([rd.read_tile(r, c) for r in range(bh)
                    for c in range(bw)])
    if got.shape != want.shape or not np.array_equal(got, want):
        raise AssertionError("phase 10: the exported level-0 TIFF differs "
                             "from decode_frames of the stored frames")
    return f"{n} tiles equal"


def run_spine(seed: int, card: str) -> dict:
    """Phase 10: four 8192² slides through the event-driven pipeline on
    the card, serial (run A) and concurrent (run B)."""
    from repro_torch.wsi import (ConvertOptions, SyntheticScanner,
                                 convert_wsi_to_dicom)
    from repro_torch.wsi.convert import _pyramid_dims
    t0 = time.perf_counter()
    slides = {}
    for i in range(SPINE_SLIDES):
        sc = SyntheticScanner(seed=seed + 10 + i)
        if i % 2 == 0:
            slides[f"spine/s{i}.psv"] = sc.scan(SPINE_SIZE, SPINE_SIZE, 256)
        else:
            slides[f"spine/s{i}.svs"] = sc.scan_tiff(SPINE_SIZE, SPINE_SIZE,
                                                     256)
    scan_s = time.perf_counter() - t0

    def convert(data: bytes, meta: dict) -> bytes:
        opt = ConvertOptions(manifest={"uids": _pinned_uids(meta["slide_id"])},
                             device="cuda")
        return convert_wsi_to_dicom(data, meta, opt)

    n_levels = len(_pyramid_dims(SPINE_SIZE, SPINE_SIZE, 256))
    want = {k: 0 for k in KERNELS}
    want.update(jpeg_transform=SPINE_SLIDES * n_levels,
                downsample2x2=SPINE_SLIDES * (n_levels - 1))
    runs = {}
    for name, inst, conc, export in (("A", 1, 1, False), ("B", 2, 2, True)):
        r = _spine_run(slides, convert, max_instances=inst,
                       concurrency=conc, export=export)
        got = {k: r["launches"][k] for k in ("jpeg_transform",
                                             "downsample2x2")}
        if got != {k: want[k] for k in got} or \
                r["conv_launches"]["jpeg_transform"] != want["jpeg_transform"]:
            raise AssertionError(f"phase 10 run {name}: conversion launches "
                                 f"{r['launches']}, expected {want}")
        if not (r["launches"]["entropy_decode"] > 0
                and r["launches"]["jpeg_inverse"] > 0):
            raise AssertionError(f"phase 10 run {name}: the read side "
                                 f"launched {r['launches']}")
        if r["instances"] != SPINE_SLIDES * n_levels:
            raise AssertionError(f"phase 10 run {name}: {r['instances']} "
                                 "instances")
        runs[name] = r
        _log(f"spine run {name} ({card}): " + json.dumps(
            {k: v for k, v in r.items() if k != "tars"}))
    for k in slides:
        if runs["B"]["tars"][k] != runs["A"]["tars"][k]:
            raise AssertionError(f"phase 10: run B's tar of {k} differs "
                                 "from run A's")
    first = next(iter(slides))
    if convert(slides[first], {"slide_id": first}) != runs["A"]["tars"][first]:
        raise AssertionError(f"phase 10: {first}'s pipeline tar differs from "
                             "a direct conversion")
    return dict(size=SPINE_SIZE, slides=SPINE_SLIDES, levels=n_levels,
                scan_s=scan_s, launches=runs["B"]["launches"],
                **{f"run_{n}": {k: v for k, v in r.items() if k != "tars"}
                   for n, r in runs.items()})


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
             f"{k['ms']:.5f} ms (plain {k['plain_ms']:.3f}, bound "
             f"{k['bound_ms']:.5f} by {k['bound_by']})")
    for name in ("rgb2ycbcr", "dct8x8_quant"):
        _log(f"per-tile {name}: " + json.dumps(
            {k: v for k, v in kernels[name].items() if "ms" in k}))

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

    # 8. wkv_chunk at the serving path's prefill shapes
    kernels["wkv_chunk"] = check_wkv_chunk(args.seed)
    _log("kernel wkv_chunk: " + json.dumps(kernels["wkv_chunk"]))

    # 9. serving rwkv6-3b at full width
    serving = run_serving(args.seed)
    _log("serving: " + json.dumps(serving))

    # 10. the event-driven pipeline on the card
    spine = run_spine(args.seed, card)
    _log("spine: " + json.dumps(spine))

    # each kernel's launches in the run of the path that drives it
    path_of = {"downsample2x2": main_path, "jpeg_transform": main_path,
               "rgb2ycbcr": per_tile, "dct8x8_quant": per_tile,
               "jpeg_inverse": read_side, "entropy_decode": read_side,
               "wkv_chunk": serving}
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
