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
   each timed with CUDA events (median of 10) beside its plain version,
   ``bound_ms`` (the least time the card could take: the larger of bytes
   over the memory rate and operations over the float32 rate) and, where
   one PyTorch call computes the same function, that call's time;
4. equivalence on a 4096² slide — PSV vs TIFF and pipelined vs sync study
   tars on the card, and the card's tar vs the CPU plain path's, byte for
   byte;
5. the main path — a size² PSV slide (256² tiles) converted on ``cuda`` by
   the pipelined engine with the launch counts zeroed just before: one
   ``jpeg_transform`` launch per level, one ``downsample2x2`` per level
   step, one upload; every level's Part-10 frame count equals its tile
   count; per-stage wall times and MPix/s.

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


def _log(msg: str) -> None:
    print(msg, flush=True)


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
    for kind, t in (("slide", tiles), ("noise", noise)):
        got = ops.jpeg_transform(t)
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
    del tiles, noise
    torch.cuda.empty_cache()
    return results


def check_equivalence(seed: int) -> None:
    """Phase 4: PSV vs TIFF, pipelined vs sync, card vs CPU on a 4096² slide."""
    from repro_torch.wsi import (ConvertOptions, SyntheticScanner,
                                 convert_wsi_to_dicom)
    scanner = SyntheticScanner(seed=seed + 1)
    psv, tiff = scanner.scan(4096, 4096, 256), scanner.scan_tiff(4096, 4096,
                                                                 256)
    uids = _uids(seed + 1)

    def run(slide, **kw):
        opt = ConvertOptions(manifest={"uids": uids}, **kw)
        return convert_wsi_to_dicom(slide, {"slide_id": "smoke"}, opt)

    tars = {"psv pipelined": run(psv), "tiff pipelined": run(tiff),
            "psv sync": run(psv, pipelined=False),
            "tiff sync": run(tiff, pipelined=False),
            "psv cpu plain": run(psv, device="cpu")}
    base = tars["psv pipelined"]
    for name, tar in tars.items():
        if tar != base:
            raise AssertionError(f"4096² study tar of {name} differs")
    _log(f"equivalence 4096²: {len(tars)} study tars byte-identical "
         f"({len(base)} bytes)")


def run_main_path(size: int, slide: bytes, seed: int) -> dict:
    """Phase 5: one size² slide through the pipelined engine on the card."""
    import torch
    import repro_torch.wsi.convert as cv
    from repro_torch.kernels import ops
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
        ops.jpeg_transform.launches = 0
        ops.downsample2x2.launches = 0
        cv.TRANSFER_STATS.reset()
        t0 = time.perf_counter()
        tar = cv.convert_wsi_to_dicom(slide, {"slide_id": "smoke"}, opt)
        wall = time.perf_counter() - t0
        launches = {"jpeg_transform": ops.jpeg_transform.launches,
                    "downsample2x2": ops.downsample2x2.launches}
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
    if launches != {"jpeg_transform": n_levels,
                    "downsample2x2": n_levels - 1}:
        raise AssertionError(f"kernel launches on the main path: {launches}")
    if stats != (1, 1, n_levels):
        raise AssertionError(f"uploads/dispatches/fetches: {stats}")
    mpix = size * size / 1e6
    return dict(size=size, levels=n_levels, launches=launches,
                uploads=stats[0], tar_bytes=len(tar), wall_s=wall,
                mpix_per_s=mpix / wall, device_chain_ms=device_ms,
                stage_s=stage,
                host_other_s=wall - sum(stage.values()))


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

    # 4. equivalence at 4096²
    check_equivalence(args.seed)

    # 5. the main path
    main_path = run_main_path(args.size, slide, args.seed)
    main_path["stage_s"] = {"scan": scan_s, **main_path["stage_s"]}
    _log("main path: " + json.dumps(main_path))
    for name, k in kernels.items():
        k["launches"] = main_path["launches"][name]

    _log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
