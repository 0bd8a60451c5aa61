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
3. kernels vs plain versions at main-path shapes, under a mesh of the one
   card (as phases 5, 6 and 10's conversions; phase 15 splits) —
   ``downsample2x2`` on a
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
   the pipelined engine, its mesh named as the one card (so the gates hold
   on a machine of several), with the launch counts zeroed just before: one
   ``jpeg_transform`` launch per level, one ``downsample2x2`` per level
   step, one upload; every level's Part-10 frame count equals its tile
   count; per-stage wall times and MPix/s;
6. the read side — every level of that study read back as the export
   service does (``Part10Index.read_frame`` → ``decode_frames`` on
   ``cuda`` under a mesh of the one card, with the launch counts zeroed
   just before → ``write_tiff`` →
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
   must be in the trace. ``lead_ms``: the first kernel's start in it.
   The engine runs its decode step as a CUDA graph (``graphs``, the
   default on the card): every engine captures it once, on its second
   decode tick, and replays it on every tick from then on (gated by the
   engine's ``graph_captures`` and ``graph_replays``). One eager engine
   run (``graphs=False``) of the same requests, in bf16 and in float32
   compute, must give the graph runs' tokens (and in float32 the same
   logits); ``graph`` reports both runs' ``ms_per_tick`` and
   ``decode_tok_per_s``, and one decode step from one cache, the
   replay's logits against the eager step's (max|Δ| at most
   ``GRAPH_LOGIT_BOUND``, the caches written equal, no launch counted in
   the capture) with one replay's device time (CUDA events) beside the
   eager step's profiled one;
10. the event-driven pipeline on the card — four 8192² slides (256²
    tiles; two PSV, two TIFF; UIDs pinned from each slide id) ingested
    into the landing bucket of a ``ConversionPipeline`` on a
    ``RealScheduler`` (8 workers), with the port's lockdep and racedep
    armed: landing bucket → ``OBJECT_FINALIZE`` → topic → push
    subscription → ``ConverterFleet`` → ``convert_wsi_to_dicom`` on
    ``cuda`` in worker threads (``ConvertOptions(mesh=)`` the one card) →
    study tar → ingest subscription → the
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
    device memory, inference frames and export MPix/s;
11. the dense family served through the bus — ``phi4-mini-3.8b`` at full
    width (32 layers, d_model 3072, 24 heads and 8 KV heads of 128, d_ff
    8192, vocab 200064, tied embeddings, RoPE on 0.75 of each head; 3.84 B
    parameters in bf16, random from a seeded generator), 4 slots,
    ``max_len`` 4096, phase 9's six prompts with 32 new tokens each,
    published on a request ``Topic`` and answered through
    ``PubSubFrontend`` on a ``SimScheduler`` as ``launch/serve.py`` runs
    it. It launches none of the kernels above (attention is plain
    PyTorch, in float32, as the reference computes it outside any Pallas
    kernel), and the counts must stay 0. Gates: six responses of 32
    tokens, every message acked; the tokens equal a direct
    ``engine.submit`` run's; the 64-token request's tokens equal a
    token-by-token ``M.prefill`` + ``M.decode_step`` loop's at the
    engine's 4 rows (the loop at one row is reported: cuBLAS picks its
    kernel by the row count, and bf16 rounds the two apart); at 2 layers
    of the same width in float32 (TF32 off, a 1100-token prompt that pads
    the last attention chunk) the card's prefill logits and one decode
    step within ``DENSE_CPU_BOUND`` (``max|Δ| / (max|CPU| + 1)``) of the
    CPU's plain run of the same parameters, and ``+kv8``'s int8 cache
    within 0.25 of the float cache's decode logits (the bound of
    tests/test_models_smoke.py). Prints init s, prefill tokens/s per
    prompt (the engine's prefill call alone, median of 3), decode
    tokens/s, tokens per tick and ms per tick, a profiled 2048-token
    prefill and 4-slot decode step (kernels, device ms against wall ms,
    busy share; each one call's by difference of a 3-call and a 1-call
    trace, since a trace late in this process misses its first kernels),
    phase 9's graph-against-eager runs and step through the bus, with the
    float KV cache and with ``+kv8``,
    with an estimate of the attention's device time and share (not read
    from the prefill's trace: one ``blocked_attention`` call at a layer's
    shapes on random q/k/v in a trace of its own, times the layers), and
    peak device memory;
12. the moe, hybrid, vlm and audio families (no kernel of the port on
    this path either: the counts must stay 0). (a) ``mixtral-8x7b`` at
    full width (d_model 4096, 32 heads and 8 KV heads of 128, 8 experts
    with top-2, d_ff 14336, vocab 32000, sliding window 4096) cut to 8
    of its 32 layers (the whole model, 93.4 GB of bf16, does not fit one
    80 GB card; the cut is printed), 11,872,309,248 parameters, random
    from a seeded generator, served through the bus as phase 11 serves
    (4 slots, ``max_len`` 4096, phase 9's prompts, 32 new tokens) with
    phase 11's gates 1–3; gate 5 at 2 layers of the same width in float32
    on a 512-token prompt: the top-2 router assignments of each router
    call (the prefill's layers and the decode step's, read from the
    model's own run by a tap on ``moe.router_logits``) on the card equal
    to the CPU's, and the prefill logits and one decode step within
    ``DENSE_CPU_BOUND`` of the CPU's; where an assignment differs, the
    CPU runs again with the card's router logits replayed, its own router
    on that path may part from the card's only where its probability
    margin is below ``ROUTER_FLIP_LIMIT``, and the logits are held to
    ``DENSE_CPU_BOUND`` against that run; gate 6, ``+kv8`` within 0.25
    of the float cache's decode logits. Prints init s, peak GB, prefill
    tokens/s per prompt, decode tokens/s, tokens per tick, ms per tick,
    and a profiled 2048-token prefill and 4-slot decode step, one call in
    one trace each, with the MoE's device time read from the
    ``record_function("moe")`` ranges of that trace and the kernels the
    trace lost. (b) ``zamba2-1.2b``, ``musicgen-large`` and
    ``llama-3.2-vision-11b`` at full width and depth in the engine
    (requests submitted directly, the engine's zero ``cond``; prompts of
    2048 and 64 tokens, 16 new tokens each): the responses complete, the
    launch counts stay 0, each request's tokens equal the token-by-token
    loop's at the engine's 4 rows; then at 7, 2 and 5 layers in float32
    (two shared-block applications, cross-attention in every layer, one
    cross block) with a seeded random ``cond`` and the vlm's cross gates
    drawn nonzero, the card's prefill logits, and one decode step from
    the card's prefill cache, within ``DENSE_CPU_BOUND`` of the CPU's
    (the decode from each side's own cache is reported: the hybrid's
    conv tails are bf16 in the cache, so ~1e-7 float32 differences round
    one bf16 step apart there). Prints prefill and decode rates, peak GB
    and a profiled 2048-token prefill and decode step. (a) and (b) each
    add phase 9's graph-against-eager runs and step;
13. training on the card. (a) ``rwkv6-3b`` at full width and depth
    (3,099,609,600 bf16 parameters from seed 0, ``remat="nothing"``)
    trained by ``launch.train.run`` as ``python -m
    repro_torch.launch.train --arch rwkv6-3b --steps 4 --batch 4 --seq
    1024 --microbatches 2`` runs it: with the launch counts zeroed just
    before, exactly 128 ``wkv_chunk`` launches a step (the forward and the
    remat recompute of 32 layers, per microbatch; through
    ``ops.WkvChunk``) and no other kernel of the port; the losses finite;
    after step 1 the first moment (0.1 · clip scale · gradient) of ``u``,
    ``wr``, ``wk``, ``wv``, ``w0`` and the decay LoRA, which the loss
    reaches only through the wkv, nonzero in every layer. Then ``--steps
    2 --compress --microbatches 1`` (64 launches a step; the ``int8_ef``
    residual nonzero). Prints the losses, s/step (median of steps 2–4),
    tokens/s, model FLOP/s (6·N·tokens; the recompute apart) and its share
    of the card's dense bf16 peak, peak memory, and one more step of one
    microbatch profiled (device time, busy share, the ``record_function``
    ranges ``wkv_fwd``, ``wkv_bwd``, ``adamw`` and ``xent`` (the loss
    head's forward) as shares of the device time, their counts gated,
    and the main run's step worked out from it). (b) ``ops.wkv_chunk`` on
    inputs that require grad at (2, 1024, 40, 64) from a random state:
    one launch through ``WkvChunk``, output within ``WKV_BOUND`` of the
    plain version's, its six gradients equal autograd's through the plain
    version bit for bit; the kernel's output and state within
    ``WKV_BOUND`` at both training shapes, each timed beside its bound;
    and at 2 layers of the same width in float32 (the bf16 weights in
    float32 leaves) one train step on the card against the CPU's: the
    loss and every gradient, the card's AdamW on the CPU's gradients
    against the CPU's AdamW, within the stated bounds (``TRAIN_CPU_*``),
    and the full steps' parameters by tests/_torch_train.py's rule
    (``TRAIN_PARAM_*``); at that cut and a (1, 512) batch (ROADMAP F14)
    float32 gradients against float64 ones computed on the card with the
    plain wkv: the CPU's and the card's with its GEMMs correctly rounded
    within ``TRAIN_F64_BOUND``, the card's own (cuBLAS's GEMMs) within
    ``TRAIN_F64_CARD_BOUND``. (c) resume at that cut in bf16 (5.1 GB of state)
    under ``torch.use_deterministic_algorithms``: 3 steps uninterrupted
    against 2 steps, an ``AsyncCheckpointer`` save, a restore and 1 step,
    equal bit for bit (or, where they are not, within the difference of
    two uninterrupted runs); one train step of
    each family's reduced config on the card against the CPU within
    tests/_torch_train.py's bounds; one ``ElasticTrainer`` epoch on the
    card with a worker killed mid-shard, every shard applied once;
14. the planning layer against the card: ``rwkv6-3b`` at full width and
    depth (bf16, random from a seeded generator), a 2048-token prefill
    and a decode step at 4 slots of ``max_len`` 4096, each counted by
    ``launch.dryrun.run_cell`` (``roofline.counters``: every aten op, each
    ported kernel by its work formula once a call) on the card and on
    meta tensors with the plain wkv. Gates: the card's FLOPs (all, and
    those at the float32 rate) and bytes equal the meta run's exactly;
    the roofline bound (``derive_terms`` on
    the H100's ``HW``) over the measured step (CUDA events, median of 5)
    at most ``ROOF_SHARE_MAX``; the memory the step allocates above its
    arguments, predicted by the meta run, within ``ROOF_MEM_BOUND`` of the
    card's measured one (the totals with the arguments printed); 32
    ``wkv_chunk`` launches a prefill and none a decode step; the decode
    step also as a CUDA graph replay (the engine's step, CUDA events,
    median of 5), its share of the same bound at most ``ROOF_SHARE_MAX``
    (the counts stay the eager run's: the counter cannot see inside a
    replay). Then the
    ``phi4-mini-3.8b`` ``decode_32k`` cell on the 256-GPU production mesh
    (a fake process group) in a subprocess: ok, its collectives counted.
    Prints each cell's counts, terms, time, share, model FLOP share and
    peak memory;
15. the data mesh — the split mesh is every visible card, or on a machine
    of one card that card named twice (its two shards run one after the
    other on it: the split, the shard views at an offset, the per-shard
    launches and the gather all run). (a) Phase 5's level-0 tile batch
    (4096 × (3, 256, 256) at 16384²) through ``jpeg_transform`` under the
    split mesh, and its coefficients through ``jpeg_inverse``: each equal
    to the one-entry mesh's call element for element, with the launch
    counts zeroed just before, one launch a non-empty shard and no other
    kernel; ``ms`` and ``whole_ms`` (CUDA events, median of 10), and each
    call's device copies read from a profiler trace (``copies``,
    ``whole_copies``: memcpy events and their bytes); the same for the
    batch less one tile (4095: shards within one tile of each other,
    ``uneven``). (b) A 7936² SyntheticScanner slide (levels of 961, 225,
    49, 9 and 1 tiles, none of which two divides) converted
    (``ConvertOptions(mesh=)``), stored in a ``DicomStoreService`` and
    exported (``ExportService(mesh=)``) under the split mesh and under the
    one-entry mesh: the study tars' and the TIFFs' SHA-256 equal;
    ``jpeg_transform`` and ``jpeg_inverse`` launched once a non-empty
    shard at each level (9 each on one card named twice, against 5),
    ``downsample2x2`` once a level step and ``entropy_decode`` once a
    level, unsplit. Prints both circles' digests, counts and times.
    NCCL training across cards needs two cards or more and is not run;
16. the quickstart example — ``examples/torch_quickstart.py --device
    cuda`` at its defaults (a 512² slide in two containers through the
    event-driven pipeline, read back, exported) in a subprocess on the
    kernels built in phase 2: exit 0, ``quickstart OK`` last, its kernel
    launches (printed by the example) nonzero for ``jpeg_transform``,
    ``downsample2x2``, ``jpeg_inverse`` and ``entropy_decode``, within
    ``QUICKSTART_LIMIT_S`` seconds.

Each phase's seconds are logged as it ends (``phase_s``). Prints the
kernel JSON line and the card line before the last line, which is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

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
# the engine's decode graph (serve.steps.DecodeGraph): max|graph − eager|
# of one decode step's logits from one cache (the replay runs the eager
# step's own kernels), and the replays a device time is the median of
GRAPH_LOGIT_BOUND = 0.0
GRAPH_TIME_REPS = 5
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
    return ops.launch_counts()


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


def _bound(work: tuple[float, float]) -> tuple[float, str]:
    """The least time in ms for a kernel's work ``(ops, nbytes)``
    (``repro_torch.roofline.work``: the larger of bytes over the H100's
    memory rate and operations over its float32 rate) and which it is."""
    from repro_torch.roofline import bound_s
    t, by = bound_s(*work)
    return t * 1e3, by


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
    from repro_torch.roofline import jpeg_transform_work
    return _bound(jpeg_transform_work(tiles.shape))


def _inverse_bound(coef) -> tuple[float, str]:
    from repro_torch.roofline import jpeg_inverse_work
    return _bound(jpeg_inverse_work(coef.shape))


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
    from repro_torch.roofline import downsample2x2_work

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
    bound_ms, bound_by = _bound(downsample2x2_work(x.shape))
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
    from repro_torch.roofline import dct8x8_quant_work, rgb2ycbcr_work

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
    for name, work_of in (("rgb2ycbcr", rgb2ycbcr_work),
                          ("dct8x8_quant", dct8x8_quant_work)):
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
                row[key + "bound"] = _bound(work_of(xs.shape))
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
        # one card named: the launch gates hold on a machine of several
        opt = ConvertOptions(manifest={"uids": _uids(seed)}, device="cuda",
                             mesh=("cuda",))
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
    from repro_torch.roofline import entropy_decode_work
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
    bound_ms, bound_by = _bound(entropy_decode_work(
        len(frames), H, W, buf.numel(), args[3].numel()))
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


def _wkv_bound(shape) -> tuple[float, str]:
    """``wkv_chunk``'s bound at (B, S, H, K) (``roofline.wkv_chunk_work``)."""
    from repro_torch.roofline import wkv_chunk_work
    return _bound(wkv_chunk_work(*shape))


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
    b_main, b_tail = _wkv_bound(main), _wkv_bound(tail)
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


def _bus_intake(eng, prompts, max_new: int, tokens: dict):
    """The launcher's intake: each prompt published on a request ``Topic``
    and delivered through ``PubSubFrontend`` on a ``SimScheduler`` (the
    engine's submits and first prefills); a client subscription collects
    the responses into ``tokens``. Returns the scheduler and the front
    end."""
    from repro_torch.core import SimScheduler, Subscription, Topic
    from repro_torch.serve.engine import PubSubFrontend

    sched = SimScheduler()
    req, resp = Topic("requests", sched), Topic("responses", sched)
    Subscription(resp, "client", lambda m, c: (
        tokens.update({m.data["request_id"]: m.data["tokens"]}), c.ack()))
    front = PubSubFrontend(eng, req, resp)
    for i, p in enumerate(prompts):
        req.publish({"request_id": i, "prompt": p.tolist(),
                     "max_new_tokens": max_new})
    sched.run(until=0.0)
    return sched, front


def _serve_timed(cfg, params, prompts, max_new: int = SERVE_NEW, *,
                 bus: bool = False, graphs: bool | None = None) -> dict:
    """The main path: the engine as a user runs it, every request submitted
    (directly, or with ``bus`` through :func:`_bus_intake`, the launcher's
    path) and ticks run until it drains, the intake and each tick timed on
    the host (synchronised). ``graphs`` goes to the engine (its default: the
    decode step as a CUDA graph). Returns the tokens, the ticks' times with
    the prompt lengths each admitted, the engine's decode ticks and graph
    captures and replays, and with ``bus`` the messages acked and
    outstanding once the responses are delivered."""
    import torch
    from repro_torch.serve.engine import ContinuousBatchingEngine

    gc.collect()  # earlier bus runs' engines (and graphs) sit in cycles
    eng = ContinuousBatchingEngine(cfg, params, batch_size=SERVE_SLOTS,
                                   max_len=SERVE_MAX_LEN, graphs=graphs)
    tokens, ticks, out = {}, [], {}
    t0 = time.perf_counter()
    if bus:
        sched, front = _bus_intake(eng, prompts, max_new, tokens)
    else:
        for req in _requests(prompts, tokens, max_new):
            eng.submit(req)
    torch.cuda.synchronize()
    submit_s = time.perf_counter() - t0
    while eng.backlog or any(eng.active):
        before = [len(r.prompt) for r in eng.backlog]
        t1 = time.perf_counter()
        eng.tick()
        torch.cuda.synchronize()
        admitted = before[:len(before) - len(eng.backlog)]
        ticks.append((time.perf_counter() - t1, admitted))
    if bus:
        sched.run()  # the responses
        out = dict(acked=len(front.sub.acked),
                   outstanding=len(front.sub.outstanding))
    return dict(tokens=tokens, ticks=ticks, submit_s=submit_s,
                wall_s=time.perf_counter() - t0, steps=eng.steps,
                graph_captures=eng.graph_captures,
                graph_replays=eng.graph_replays, **out)


def _prefill_s(params, cfg, prompts, impl="auto", reps: int = 3) -> dict:
    """Host wall time (median of ``reps``) of the engine's prefill call for
    each prompt, synchronised, by prompt length."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve.engine import zero_cond

    dev = params["embed"]["table"].device
    cond = zero_cond(cfg, dev)
    out = {}
    for p in prompts:
        toks = torch.as_tensor(p, device=dev)[None].long()
        times = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            M.prefill(params, cfg, toks, cond=cond, max_len=SERVE_MAX_LEN,
                      impl=impl)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        out[len(p)] = statistics.median(times)
    return out


def _decode_rates(run: dict, pre_s: dict) -> dict:
    """Decode throughput of a :func:`_serve_timed` run: a tick's time less
    the prefills it admitted, each timed alone (``pre_s``); ``ms_per_tick``
    is the median tick that admitted none."""
    decode_tokens = sum(len(t) - 1 for t in run["tokens"].values())
    decode_s = sum(t for t, _ in run["ticks"]) - sum(
        pre_s[n] for _, ns in run["ticks"] for n in ns)
    return dict(
        decode_tokens=decode_tokens, decode_ticks=len(run["ticks"]),
        ticks_admitting=sum(1 for _, ns in run["ticks"] if ns),
        decode_s=decode_s, decode_tok_per_s=decode_tokens / decode_s,
        tokens_per_tick=decode_tokens / len(run["ticks"]),
        ms_per_tick=1e3 * statistics.median(t for t, ns in run["ticks"]
                                            if not ns))


def _serve_recorded(cfg, params, prompts, impl, graphs=None) -> dict:
    """One engine run that keeps each request's logits at every token it
    was given (its prefill, then each tick it was active in), through the
    engine's ``_greedy`` (which copies a replay's logits to the host before
    the next replay overwrites them). ``impl`` goes to the prefill's wkv,
    ``graphs`` to the engine."""
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
                    max_len=SERVE_MAX_LEN, impl=impl, graphs=graphs)
    tokens = {}
    for req in _requests(prompts, tokens, SERVE_NEW):
        eng.submit(req)
    eng.run_until_drained()
    for i, seq in eng.logits.items():  # the tokens are these argmaxes
        if [int(l.argmax()) for l in seq[:len(tokens[i])]] != tokens[i]:
            raise AssertionError(f"request {i}: tokens are not the argmax "
                                 "of the recorded logits")
    _graph_counts("recorded run", dict(
        steps=eng.steps, graph_captures=eng.graph_captures,
        graph_replays=eng.graph_replays), graphs is not False)
    return dict(tokens=tokens, logits=eng.logits)


def _graph_counts(tag: str, run: dict, graphs: bool) -> dict:
    """Gate: a graph engine captured its decode step once and replayed it
    on every decode tick from the second on; an eager one did neither.
    Returns the counts."""
    counts = {k: run[k] for k in ("steps", "graph_captures",
                                  "graph_replays")}
    want = (1, run["steps"] - 1) if graphs else (0, 0)
    if (run["graph_captures"], run["graph_replays"]) != want:
        raise AssertionError(f"{tag}: {counts}, expected captures and "
                             f"replays {want}")
    return counts


def _graph_vs_eager(tag: str, cfg, params, prompts, run: dict, pre_s: dict,
                    max_new: int, *, bus: bool) -> dict:
    """The graph engine's run ``run`` (the main path, ``_serve_timed``)
    against one eager engine run (``graphs=False``) of the same requests in
    the same process: the tokens must be equal, each run's captures and
    replays as :func:`_graph_counts` says. Returns both runs' tick times
    and decode rates (:func:`_decode_rates`) side by side, and one decode
    step graph against eager (:func:`_graph_step`)."""
    eager = _serve_timed(cfg, params, prompts, max_new, bus=bus,
                         graphs=False)
    if eager["tokens"] != run["tokens"]:
        parted = sorted(i for i in run["tokens"]
                        if eager["tokens"].get(i) != run["tokens"][i])
        raise AssertionError(f"{tag}: the graph engine's tokens differ "
                             f"from the eager engine's (requests {parted})")
    rates = {"graph": _decode_rates(run, pre_s),
             "eager": _decode_rates(eager, pre_s)}
    keys = ("ms_per_tick", "decode_tok_per_s", "decode_ticks")
    return dict(
        tokens_equal=True,
        counts={"graph": _graph_counts(tag, run, True),
                "eager": _graph_counts(tag + " eager", eager, False)},
        **{k: {r: rates[r][k] for r in rates} for k in keys},
        wall_s={"graph": run["wall_s"], "eager": eager["wall_s"]},
        step=_graph_step(tag, cfg, params, prompts))


def _graph_step(tag: str, cfg, params, prompts) -> dict:
    """One decode step from one cache and one set of inputs, the graph's
    (``serve.steps.DecodeGraph``) against the eager step's: an eager
    engine after its first tick (the warm-up), the first SERVE_SLOTS
    prompts in its slots, its cache cloned once for each. Gates: no kernel
    launch counted inside the capture; the logits within GRAPH_LOGIT_BOUND
    (max|Δ|) and the caches the two steps write equal. Returns those and
    one replay's device time (CUDA events, median of GRAPH_TIME_REPS)."""
    import torch
    from repro_torch.models.params import tree_defs, tree_map
    from repro_torch.serve.engine import ContinuousBatchingEngine
    from repro_torch.serve.steps import DecodeGraph, make_decode_step

    eng = ContinuousBatchingEngine(cfg, params, batch_size=SERVE_SLOTS,
                                   max_len=SERVE_MAX_LEN, graphs=False)
    for req in _requests(prompts[:SERVE_SLOTS], {}, 8):
        eng.submit(req)
    eng.tick()
    dev, tok, pos = eng.device, eng._last_tok.copy(), eng.pos.copy()
    c_eager = tree_map(torch.clone, eng.cache)
    c_graph = tree_map(torch.clone, eng.cache)
    del eng
    step = make_decode_step(cfg)
    want, _ = step(params, c_eager,
                   torch.as_tensor(tok, device=dev)[:, None].long(),
                   torch.as_tensor(pos, device=dev))
    graph = DecodeGraph(step, params, c_graph, SERVE_SLOTS)
    got = graph(tok, pos)
    diff = float((got.float() - want.float()).abs().max())
    apart = [path for (path, a), (_, b) in zip(tree_defs(c_graph),
                                               tree_defs(c_eager))
             if not torch.equal(a, b)]
    if graph.captured_launches or not diff <= GRAPH_LOGIT_BOUND or apart:
        raise AssertionError(
            f"{tag}: the graph step against the eager step: logits "
            f"max|Δ| {diff} (bound {GRAPH_LOGIT_BOUND}), cache leaves "
            f"apart {apart}, {graph.captured_launches} launches captured")
    replay_ms = _time_ms(graph.graph.replay, reps=GRAPH_TIME_REPS, warmup=1)
    del graph, c_eager, c_graph, got, want
    _free()
    return dict(logit_max_abs_diff=diff, caches_equal=True,
                captured_launches=0, replay_device_ms=replay_ms)


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
    pre_s = _prefill_s(params, cfg, prompts)

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
    # the decode graph against the eager engine: bf16 (the main path's run
    # against an eager timed run) and float32 (F8's token gate: the graph
    # run's tokens against an eager recorded run's, and their logits)
    graph = {"bf16": _graph_vs_eager("phase 9", cfg, params, prompts, run,
                                     pre_s, SERVE_NEW, bus=False)}
    eager32 = _serve_recorded(cfg32, params, prompts, "auto", graphs=False)
    if eager32["tokens"] != run32["tokens"]:
        raise AssertionError("phase 9: the float32 graph engine's tokens "
                             "differ from the eager engine's")
    graph["f32"] = dict(
        tokens_equal=True, logit_max_abs_diff=max(
            float((a - b).abs().max()) for i in run32["logits"]
            for a, b in zip(run32["logits"][i], eager32["logits"][i])),
        step=_graph_step("phase 9 f32", cfg32, params, prompts))
    if graph["f32"]["logit_max_abs_diff"] > GRAPH_LOGIT_BOUND:
        raise AssertionError(f"phase 9: the float32 graph run's logits lie "
                             f"{graph['f32']['logit_max_abs_diff']} from "
                             "the eager run's")
    del eager32
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

    rates = _decode_rates(run, pre_s)
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
            rates["ms_per_tick"])}
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
        prefill_s=pre_s, **rates, profiles=profiles,
        plain_prefill_s=_prefill_s(params, cfg, prompts, "ref", 1),
        f32_prefill_s=_prefill_s(params, cfg32, prompts, "auto", 1),
        shadow_checked_calls=shadow["calls"],
        shadow_max_rel_err=shadow["max_rel_err"],
        witness_spread=spread, logit_rel_bound=bounds, compare=rows,
        graph=graph)


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
                             device="cuda", mesh=("cuda",))
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


# phase 11: the dense family served through the bus
DENSE_ARCH = "phi4-mini-3.8b"
# gates 4 and 5: the full width at this depth in float32; a prompt that is
# not a multiple of the 1024-key attention chunk (its last chunk padded)
DENSE_CHECK_LAYERS = 2
DENSE_CHECK_PROMPT = 1100
# gate 4: max|Δ| / (max|CPU| + 1) of the card's float32 logits (TF32 off)
# against the CPU's plain run of the same parameters: float32 sums in
# other orders (cuBLAS against the CPU's BLAS) over two layers
DENSE_CPU_BOUND = 1e-4
# gate 5: tests/test_models_smoke.py's bound for an int8 KV cache
KV8_BOUND = 0.25


def _greedy_loop(cfg, params, prompt, n: int, rows: int) -> list:
    """Token by token with ``M.prefill`` + ``M.decode_step``: the prompt's
    prefill cache in row 0 of a ``rows``-row cache (the other rows idle at
    position 0), ``n`` greedy tokens. At the engine's width (``rows`` =
    its slots) each step runs the engine's kernels: a GEMM's rows do not
    depend on each other, but which kernel cuBLAS picks depends on the row
    count, and bf16 rounds the two apart."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.serve.engine import splice_slot, zero_cond

    dev = params["embed"]["table"].device
    logits, one = M.prefill(params, cfg,
                            torch.as_tensor(prompt, device=dev)[None].long(),
                            cond=zero_cond(cfg, dev), max_len=SERVE_MAX_LEN)
    cache = M.init_cache(cfg, rows, SERVE_MAX_LEN, dev)
    splice_slot(cache, one, 0, rows)
    out = [int(torch.argmax(logits[0]))]
    tok = torch.zeros((rows, 1), dtype=torch.long, device=dev)
    pos = torch.zeros(rows, dtype=torch.int32, device=dev)
    for i in range(n - 1):
        tok[0, 0], pos[0] = out[-1], len(prompt) + i
        logits, cache = M.decode_step(params, cfg, cache, tok, pos)
        out.append(int(torch.argmax(logits[0])))
    return out


def _serving_gates(tag: str, cfg, params, prompts, run: dict,
                   launches: dict, max_new: int, *, bus: bool,
                   loops) -> dict:
    """The serving gates of phases 11 and 12 on a :func:`_serve_timed` run
    (``launches`` read just after it): (1) every response with its
    ``max_new`` tokens, and with ``bus`` every message acked; no kernel of
    the port launched; (2) with ``bus``, the tokens equal a direct
    ``engine.submit`` run's; (3) each request in ``loops`` equal to the
    token-by-token loop at the engine's width. Returns the loops' tokens
    by request."""
    lengths = {i: len(t) for i, t in run["tokens"].items()}
    if lengths != {i: max_new for i in range(len(prompts))} or (bus and (
            run["acked"] != len(prompts) or run["outstanding"])):
        raise AssertionError(f"{tag}: responses {lengths}, "
                             f"{run.get('acked')} acked, "
                             f"{run.get('outstanding')} outstanding")
    if any(launches.values()):
        raise AssertionError(f"{tag}: the serving path launched {launches}")
    if bus and _serve_timed(cfg, params, prompts, max_new)["tokens"] != \
            run["tokens"]:
        raise AssertionError(f"{tag}: the bus run's tokens differ from a "
                             "direct engine run's")
    out = {}
    for i in loops:
        out[i] = _greedy_loop(cfg, params, prompts[i], max_new, SERVE_SLOTS)
        if out[i] != run["tokens"][i]:
            raise AssertionError(f"{tag}: the {len(prompts[i])}-token "
                                 "request's tokens differ from the "
                                 "prefill + decode_step loop's")
    return out


def _dense_cpu_checks(params, cfg, seed: int) -> dict:
    """Gates 4 and 5 at the full width cut to DENSE_CHECK_LAYERS layers in
    float32 (the first layers of the served parameters): the card's
    prefill logits and one decode step against the CPU's plain run of the
    same parameters, and the ``+kv8`` run's decode logits against the
    float cache's on the card."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map

    n = DENSE_CHECK_LAYERS
    sub = _cut_params(params, cfg, n)
    rng = np.random.default_rng(seed + 11)
    prompt = rng.integers(0, cfg.vocab_size, size=(1, DENSE_CHECK_PROMPT))
    tok = rng.integers(0, cfg.vocab_size, size=(1, 1))

    def cut(c):
        return dataclasses.replace(c, num_layers=n, dtype=torch.float32,
                                   name=f"{c.name}-{n}L+f32")

    def run(p, c, dev):
        t0 = time.perf_counter()
        logits, cache = M.prefill(p, c, torch.as_tensor(prompt, device=dev),
                                  max_len=DENSE_CHECK_PROMPT + 8)
        step, cache = M.decode_step(
            p, c, cache, torch.as_tensor(tok, device=dev),
            torch.full((1,), DENSE_CHECK_PROMPT, dtype=torch.int32,
                       device=dev))
        out = (logits.cpu(), step.cpu(), cache["k"].dtype)
        return out + (time.perf_counter() - t0,)

    cfg32, cfg8 = cut(cfg), cut(get_config(DENSE_ARCH + "+kv8"))
    card = run(sub, cfg32, torch.device("cuda"))
    host = run(tree_map(lambda a: a.cpu(), sub), cfg32, torch.device("cpu"))
    kv8 = run(sub, cfg8, torch.device("cuda"))
    rel = {}
    for what, got, want in (("prefill", card[0], host[0]),
                            ("decode", card[1], host[1])):
        rel[what] = r = _rel(got, want)
        if not (bool(torch.isfinite(got).all()) and r < DENSE_CPU_BOUND):
            raise AssertionError(f"phase 11: the card's {what} logits lie "
                                 f"{r:.3e} from the CPU's (bound "
                                 f"{DENSE_CPU_BOUND})")
    if kv8[2] != torch.int8:
        raise AssertionError(f"phase 11: the +kv8 cache is {kv8[2]}")
    kv8_err = float((kv8[1] - card[1]).abs().max())
    if not kv8_err < KV8_BOUND:
        raise AssertionError(f"phase 11: the int8 cache's decode logits lie "
                             f"{kv8_err:.4f} from the float cache's (bound "
                             f"{KV8_BOUND})")
    return dict(layers=n, prompt=DENSE_CHECK_PROMPT,
                cpu_rel=rel, cpu_rel_bound=DENSE_CPU_BOUND,
                kv8_decode_max_abs=kv8_err, kv8_bound=KV8_BOUND,
                kv8_prefill_equal=bool(torch.equal(kv8[0], card[0])),
                logit_max_abs=float(host[1].abs().max()),
                card_s=card[3], cpu_s=host[3])


def _profile_per_call(fn, wall_ms: float) -> dict:
    """One call of ``fn``'s kernels by difference: a trace of 3 calls less
    a trace of 1 call, halved. A trace taken late in a long process can
    miss its first kernels, the same number in every trace (12 in phase
    11 after phases 1–10, one after a single conversion), so the
    difference is one call's kernels where one trace is not;
    ``trace_lost`` is how many the one-call trace missed. ``busy_share``
    is the device time over the call's unprofiled host wall time
    ``wall_ms``."""
    one, _ = _device_kernels(fn, 1)
    three, _ = _device_kernels(fn, 3)
    per = {key: [ms, n] for key, ms, n in three}
    for key, ms, n in one:
        row = per.setdefault(key, [0.0, 0])
        row[0] -= ms
        row[1] -= n
    rows = sorted(((k, ms / 2, n // 2) for k, (ms, n) in per.items() if n),
                  key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    kernels = sum(r[2] for r in rows)
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                busy_share=device_ms / wall_ms, kernels=kernels,
                trace_lost=kernels - sum(r[2] for r in one),
                top=[dict(name=k[:90], ms=ms, calls=c)
                     for k, ms, c in rows[:6]])


def run_dense_serving(seed: int, card: str) -> dict:
    """Phase 11: phi4-mini-3.8b at full width served through the bus."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as lyr
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_defs

    cfg = get_config(DENSE_ARCH)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in tree_defs(params))
    if n_params != M.param_count(cfg):
        raise AssertionError(f"phase 11: {n_params} parameters, expected "
                             f"{M.param_count(cfg)}")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in SERVE_PROMPTS]

    # warm-up (cuBLAS handles and the allocator's pools at every prompt
    # length), then the main path through the bus
    _serve_timed(cfg, params, prompts, 2, bus=True)
    gc.collect()  # the warm-up's engine and bus hold each other in cycles
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    run = _serve_timed(cfg, params, prompts, bus=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = _read_launches()
    # gates 1–3; the loop at one row is reported beside gate 3's
    last = len(prompts) - 1
    loop = _serving_gates("phase 11", cfg, params, prompts, run, launches,
                          SERVE_NEW, bus=True, loops=[last])[last]
    solo = _greedy_loop(cfg, params, prompts[last], SERVE_NEW, 1)
    solo_part = next((j for j, (a, b) in enumerate(zip(solo, loop))
                      if a != b), None)
    # gates 4 and 5
    checks = _dense_cpu_checks(params, cfg, seed)

    pre_s = _prefill_s(params, cfg, prompts)
    rates = _decode_rates(run, pre_s)
    # the decode graph against the eager engine through the bus, with the
    # float KV cache and with +kv8
    graph = {"bf16": _graph_vs_eager("phase 11", cfg, params, prompts, run,
                                     pre_s, SERVE_NEW, bus=True)}
    kv8 = get_config(DENSE_ARCH + "+kv8")
    graph["kv8"] = _graph_vs_eager(
        "phase 11 +kv8", kv8, params, prompts,
        _serve_timed(kv8, params, prompts, bus=True),
        _prefill_s(params, kv8, prompts), SERVE_NEW, bus=True)

    # one profiled 2048-token prefill and 4-slot decode step, and an
    # estimate of the attention's device time in that prefill, taken from
    # another trace: one blocked_attention call at a layer's shapes on
    # random q/k/v (profiled the same way) times the layers
    tokens = torch.as_tensor(prompts[0], device=dev)[None].long()
    cache = M.init_cache(cfg, SERVE_SLOTS, SERVE_MAX_LEN, dev)
    step = torch.zeros((SERVE_SLOTS, 1), dtype=torch.long, device=dev)
    pos = torch.full((SERVE_SLOTS,), 100, dtype=torch.int32, device=dev)
    profiles = {
        "prefill_2048": _profile_per_call(
            lambda: M.prefill(params, cfg, tokens, max_len=SERVE_MAX_LEN),
            1e3 * pre_s[len(prompts[0])]),
        "decode_step": _profile_per_call(
            lambda: M.decode_step(params, cfg, cache, step, pos),
            rates["ms_per_tick"])}
    del cache
    S = len(prompts[0])
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((1, S, cfg.num_heads, cfg.head_dim), generator=gen,
                    device=dev).to(cfg.dtype)
    k, v = (torch.randn((1, S, cfg.num_kv_heads, cfg.head_dim), generator=gen,
                        device=dev).to(cfg.dtype) for _ in range(2))
    qpos = torch.arange(S, dtype=torch.int32, device=dev)[None]
    attn = _profile_per_call(lambda: lyr.blocked_attention(
        q, k, v, qpos, qpos, chunk=cfg.attn_chunk), math.nan)
    pf = profiles["prefill_2048"]
    pf.update(attention_ms_est=cfg.num_layers * attn["device_ms"],
              attention_share_est=cfg.num_layers * attn["device_ms"]
              / pf["device_ms"],
              attention_kernels_est=cfg.num_layers * attn["kernels"],
              attention_trace_lost=attn["trace_lost"])
    return dict(
        card=card, arch=cfg.name, params=n_params, init_s=init_s,
        launches=launches, peak_gb=peak_gb, wall_s=run["wall_s"],
        submit_s=run["submit_s"], responses=len(run["tokens"]),
        prefill_tok_per_s={n: n / pre_s[n] for n in SERVE_PROMPTS},
        prefill_s=pre_s, **rates, profiles=profiles,
        loop_prompt=len(prompts[last]), one_row_loop_parts_at=solo_part,
        checks=checks, graph=graph)


# phase 12: the moe, hybrid, vlm and audio families
MOE_ARCH = "mixtral-8x7b"
# the whole model is 46.7 B parameters (93.4 GB of bf16): a quarter of
# its depth (half fits one 80 GB card beside the caches; a quarter keeps
# the smoke inside its time)
MOE_LAYERS = 8
# gates 5 and 6 at the full width in float32 at this depth, on a prompt
# whose CPU run stays short (2 expert layers are 11.3 GB of float32)
MOE_CHECK_LAYERS = 2
MOE_CHECK_PROMPT = 512
# a router assignment may differ between the card and the CPU only where
# the CPU's probability margin between the k-th and (k+1)-th expert is
# below this: 10x the largest card-vs-CPU logit error measured at this cut
# (1.06e-6 relative, phase 12a on an H100). The logits are gated all the
# same, against the CPU's run with the card's routing forced
ROUTER_FLIP_LIMIT = 1e-5
# 12b: each arch at full width and depth served on these prompts; its
# card-vs-CPU check at a depth that exercises each structure: the
# hybrid's second shared-block application (7 layers: groups [6, 1]),
# one vlm cross block (5 layers), audio's cross-attention in every layer
FAMILY_ARCHS = {"zamba2-1.2b": 7, "musicgen-large": 2,
                "llama-3.2-vision-11b": 5}
FAMILY_PROMPTS = (2048, 64)
FAMILY_NEW = 16
FAMILY_CHECK_PROMPT = 256


def _profile_range(fn, wall_ms: float, *names: str,
                   warm: bool = True) -> dict:
    """One call of ``fn`` in one trace (``PROFILE_PAD_S`` of idle time at
    each end): its kernels and their device time beside the call's
    unprofiled host wall time ``wall_ms`` (the ratio is the busy share),
    ``wkv_ms``, the kernels named ``WKV_KERNEL_MATCH``, and ``by_range``:
    for each of ``names``, the number of
    ``torch.profiler.record_function(name)`` ranges in that trace
    (``ranges``), the device time and number of the kernels launched
    inside them, on the range's thread and within its span (``range_ms``,
    ``range_kernels``; a range in an autograd backward runs on the
    engine's thread), and its share of the device time
    (``range_share``). ``trace_lost``: the kernel launches the
    trace holds on the host side less the kernels it holds, and
    ``lost_at_ms`` when the launches that no kernel shares a correlation id
    with were made, in ms after the call's first launch (the first ten;
    None where those are not ``trace_lost`` many). Reads the trace's raw
    events (``kineto_results``): building the profiler's event tree takes
    minutes for a training step's ~200k kernels. ``warm=False`` skips the
    unprofiled call before the trace (for a caller that has just run
    ``fn``). ``trace_s`` and ``parse_s``: the host time of the traced call
    (the profiler's start and stop included) and of reading its events."""
    import bisect

    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_PAD_S)
        fn()
        torch.cuda.synchronize()
        time.sleep(PROFILE_PAD_S)
    t1 = time.perf_counter()
    cuda = torch.autograd.DeviceType.CUDA
    device, launches, spans = [], {}, {n: {} for n in names}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if e.device_type() == cuda:
            # kernels, copies and fills; the ranges' own device-side
            # annotations are spans, not work: left out of the sums
            if name not in names and not e.is_user_annotation():
                device.append(e)
        elif "LaunchKernel" in name:
            launches[e.correlation_id()] = (e.start_thread_id(),
                                            e.start_ns())
        elif name in spans:
            spans[name].setdefault(e.start_thread_id(), []).append(
                (e.start_ns(), e.end_ns()))
    kernels = [e for e in device
               if not e.name().startswith(("Memcpy", "Memset"))]
    ran = {e.correlation_id() for e in kernels}
    lost = [t for c, (_, t) in launches.items() if c not in ran]
    first = min(t for _, t in launches.values())
    device_ms = sum(e.duration_ns() for e in device) / 1e6
    for by_thread in spans.values():
        for rows in by_thread.values():
            rows.sort()
    by_range = {n: dict(ranges=sum(map(len, spans[n].values())),
                        range_ms=0.0, range_kernels=0) for n in names}
    top, wkv = {}, [0.0, 0]
    for e in kernels:
        ms = e.duration_ns() / 1e6
        row = top.setdefault(e.name()[:90], [0.0, 0])
        row[0] += ms
        row[1] += 1
        if WKV_KERNEL_MATCH in e.name():
            wkv[0] += ms
            wkv[1] += 1
        thread, t = launches.get(e.correlation_id(), (None, None))
        for n in names:
            rows = spans[n].get(thread)
            if rows:
                i = bisect.bisect_right(rows, (t, float("inf"))) - 1
                if i >= 0 and rows[i][0] <= t <= rows[i][1]:
                    by_range[n]["range_ms"] += ms
                    by_range[n]["range_kernels"] += 1
    for r in by_range.values():
        r["range_share"] = r["range_ms"] / device_ms
    n_launched = len(launches)
    return dict(wall_ms=wall_ms, device_ms=device_ms,
                trace_s=t1 - t0, parse_s=time.perf_counter() - t1,
                busy_share=device_ms / wall_ms, kernels=len(kernels),
                launched=n_launched,
                trace_lost=n_launched - len(kernels),
                lost_at_ms=sorted((t - first) / 1e6 for t in lost)[:10]
                if len(lost) == n_launched - len(kernels) else None,
                wkv_ms=wkv[0], wkv_kernels=wkv[1], by_range=by_range,
                top=[dict(name=k, ms=ms, calls=c) for k, (ms, c) in
                     sorted(top.items(), key=lambda r: -r[1][0])[:6]])


def _cut_params(params, cfg, n: int) -> dict:
    """The first ``n`` layers of a parameter tree (views): the stacked
    layers, the vlm's cross blocks before them; the rest as it is."""
    from repro_torch.models.params import tree_map

    sub = dict(params, layers=tree_map(lambda a: a[:n], params["layers"]))
    if "cross" in params:
        nx = n // cfg.cross_attn_every
        sub["cross"] = tree_map(lambda a: a[:nx], params["cross"])
    return sub


@contextlib.contextmanager
def _router_tap(replay=None):
    """``models/moe.py::router_logits`` patched for one run: the float32
    router logits of each call (the prefill's layers, then the decode
    step's) are kept on the host, in call order. With ``replay`` (such a
    list from another run) each call returns that run's logits in place of
    its own, so the run takes the other run's routing; it still keeps its
    own."""
    from repro_torch.models import moe

    real, seen = moe.router_logits, []

    def tap(p, x):
        own = real(p, x)
        seen.append(own.cpu())
        if replay is None:
            return own
        forced = replay[len(seen) - 1]
        if forced.shape != own.shape:
            raise AssertionError(f"router call {len(seen) - 1}: replayed "
                                 f"{tuple(forced.shape)}, the run's "
                                 f"{tuple(own.shape)}")
        return forced.to(own.device)

    moe.router_logits = tap
    try:
        yield seen
    finally:
        moe.router_logits = real


def _route_flips(card, host, k: int) -> list:
    """Where the card's top-k expert sets differ from the CPU's, router
    call by router call: (call, token, the CPU's probability margin between
    its k-th and (k+1)-th expert)."""
    import torch
    from repro_torch.models import moe

    flips = []
    for call, (l_card, l_cpu) in enumerate(zip(card, host)):
        _, e_card = moe.top_k(torch.softmax(l_card, -1), k)
        p_cpu, e_cpu = moe.top_k(torch.softmax(l_cpu, -1), k + 1)
        same = (torch.sort(e_card, -1).values ==
                torch.sort(e_cpu[..., :k], -1).values).all(-1)
        for b, t in (~same).nonzero().tolist():
            flips.append((call, t, float(p_cpu[b, t, k - 1]
                                         - p_cpu[b, t, k])))
    return flips


def _router_stats(card, host, k: int) -> dict:
    """The CPU's smallest k-th to (k+1)-th probability margin and the
    largest card-vs-CPU router probability difference, over all calls."""
    import torch
    from repro_torch.models import moe

    margin, diff = math.inf, 0.0
    for l_card, l_cpu in zip(card, host):
        p_cpu = torch.softmax(l_cpu, -1)
        top = moe.top_k(p_cpu, k + 1)[0]
        margin = min(margin, float((top[..., k - 1] - top[..., k]).min()))
        diff = max(diff, float((torch.softmax(l_card, -1) - p_cpu)
                               .abs().max()))
    return dict(router_min_margin=margin, router_prob_max_abs=diff)


def _moe_cpu_checks(params, cfg, seed: int) -> dict:
    """Gates 5 and 6 of phase 12a at the full width cut to
    MOE_CHECK_LAYERS layers in float32 (the first layers of the served
    parameters): each router call's top-k assignments on the card against
    the CPU's, then the card's prefill logits and one decode step against
    the CPU's plain run of the same parameters, and the ``+kv8`` run's
    decode logits against the float cache's on the card. Where an
    assignment differs, the CPU runs again with the card's routing forced:
    its own router there may part from the card's only under
    ROUTER_FLIP_LIMIT of margin, and the logits are held against that
    run."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map

    n, S = MOE_CHECK_LAYERS, MOE_CHECK_PROMPT
    sub = _cut_params(params, cfg, n)
    rng = np.random.default_rng(seed + 12)
    prompt = rng.integers(0, cfg.vocab_size, size=(1, S))
    tok = rng.integers(0, cfg.vocab_size, size=(1, 1))

    def cut(c):
        return dataclasses.replace(c, num_layers=n, dtype=torch.float32,
                                   name=f"{c.name}-{n}L+f32")

    def run(p, c, dev, replay=None):
        t0 = time.perf_counter()
        with _router_tap(replay) as router:
            logits, cache = M.prefill(p, c, torch.as_tensor(prompt,
                                                            device=dev),
                                      max_len=S + 8)
            step, cache = M.decode_step(
                p, c, cache, torch.as_tensor(tok, device=dev),
                torch.full((1,), S, dtype=torch.int32, device=dev))
        if len(router) != 2 * n:
            raise AssertionError(f"phase 12: {len(router)} router calls, "
                                 f"expected {2 * n}")
        return dict(prefill=logits.cpu(), decode=step.cpu(), router=router,
                    kv=cache["k"].dtype, s=time.perf_counter() - t0)

    cfg32 = cut(cfg)
    card = run(sub, cfg32, torch.device("cuda"))
    host_params = tree_map(lambda a: a.cpu(), sub)
    host = run(host_params, cfg32, torch.device("cpu"))
    kv8 = run(sub, cut(get_config(MOE_ARCH + "+kv8")), torch.device("cuda"))
    K = cfg.num_experts_per_tok
    flips = _route_flips(card["router"], host["router"], K)
    ref, forced_flips = host, []
    if flips:
        ref = run(host_params, cfg32, torch.device("cpu"),
                  replay=card["router"])
        forced_flips = _route_flips(card["router"], ref["router"], K)
    for call, t, margin in forced_flips or flips:
        where = (f"prefill layer {call}" if call < n
                 else f"decode layer {call - n}")
        _log(f"phase 12: {where} token {t}: the card's top-{K} experts "
             f"differ from the CPU's, router margin {margin:.3e}")
    for call, t, margin in forced_flips:
        if not margin < ROUTER_FLIP_LIMIT:
            raise AssertionError(
                f"phase 12: router call {call} token {t}: top-{K} experts "
                f"differ where the CPU's router margin is {margin:.3e} "
                f"(limit {ROUTER_FLIP_LIMIT:.1e})")
    rel = {}
    for what in ("prefill", "decode"):
        got = card[what]
        rel[what] = r = _rel(got, ref[what])
        if not bool(torch.isfinite(got).all()):
            raise AssertionError(f"phase 12: the card's {what} logits are "
                                 "not finite")
        if not r < DENSE_CPU_BOUND:
            raise AssertionError(
                f"phase 12: the card's {what} logits lie {r:.3e} from the "
                f"CPU's{' with the routing forced' if flips else ''} "
                f"(bound {DENSE_CPU_BOUND})")
    if kv8["kv"] != torch.int8:
        raise AssertionError(f"phase 12: the +kv8 cache is {kv8['kv']}")
    kv8_err = float((kv8["decode"] - card["decode"]).abs().max())
    if not kv8_err < KV8_BOUND:
        raise AssertionError(f"phase 12: the int8 cache's decode logits lie "
                             f"{kv8_err:.4f} from the float cache's (bound "
                             f"{KV8_BOUND})")
    assigned = sum(int(r.numel() // r.shape[-1]) * K for r in card["router"])
    return dict(layers=n, prompt=S, assignments=assigned,
                route_flips=len(flips), forced_routing=bool(flips),
                forced_route_flips=len(forced_flips),
                router_flip_limit=ROUTER_FLIP_LIMIT,
                **_router_stats(card["router"], ref["router"], K),
                cpu_rel=rel, cpu_rel_bound=DENSE_CPU_BOUND,
                kv8_decode_max_abs=kv8_err, kv8_bound=KV8_BOUND,
                logit_max_abs=float(host["decode"].abs().max()),
                card_s=card["s"], cpu_s=host["s"])


def _free() -> None:
    """Release the card's memory that a finished phase left cached."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def run_moe_serving(seed: int, card: str) -> dict:
    """Phase 12a: mixtral-8x7b at full width (MOE_LAYERS of its 32 layers)
    served through the bus."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_defs

    full = get_config(MOE_ARCH)
    cfg = dataclasses.replace(full, num_layers=MOE_LAYERS,
                              name=f"{full.name}-{MOE_LAYERS}L")
    n_full, n_cut = M.param_count(full), M.param_count(cfg)
    _log(f"phase 12: {full.name} cut to {MOE_LAYERS} of {full.num_layers} "
         f"layers for one 80 GB card: {n_cut:,} of {n_full:,} parameters "
         f"({2 * n_cut / 1e9:.2f} of {2 * n_full / 1e9:.2f} GB in bf16), "
         f"{M.active_param_count(cfg):,} active a token")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in tree_defs(params))
    if n_params != n_cut:
        raise AssertionError(f"phase 12: {n_params} parameters, expected "
                             f"{n_cut}")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in SERVE_PROMPTS]

    _serve_timed(cfg, params, prompts, 2, bus=True)  # warm-up
    gc.collect()
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    run = _serve_timed(cfg, params, prompts, bus=True)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = _read_launches()
    last = len(prompts) - 1
    _serving_gates("phase 12", cfg, params, prompts, run, launches,
                   SERVE_NEW, bus=True, loops=[last])
    checks = _moe_cpu_checks(params, cfg, seed)

    pre_s = _prefill_s(params, cfg, prompts)
    rates = _decode_rates(run, pre_s)
    graph = _graph_vs_eager("phase 12", cfg, params, prompts, run, pre_s,
                            SERVE_NEW, bus=True)
    tokens = torch.as_tensor(prompts[0], device=dev)[None].long()
    cache = M.init_cache(cfg, SERVE_SLOTS, SERVE_MAX_LEN, dev)
    step = torch.zeros((SERVE_SLOTS, 1), dtype=torch.long, device=dev)
    pos = torch.full((SERVE_SLOTS,), 100, dtype=torch.int32, device=dev)
    profiles = {
        "prefill_2048": _profile_range(
            lambda: M.prefill(params, cfg, tokens, max_len=SERVE_MAX_LEN),
            1e3 * pre_s[len(prompts[0])], "moe"),
        "decode_step": _profile_range(
            lambda: M.decode_step(params, cfg, cache, step, pos),
            rates["ms_per_tick"], "moe")}
    for name, prof in profiles.items():
        if prof["by_range"]["moe"]["ranges"] != cfg.num_layers:
            raise AssertionError(f"phase 12: the profiled {name} holds "
                                 f"{prof['by_range']['moe']['ranges']} moe "
                                 f"ranges, expected {cfg.num_layers}")
    del cache, params
    _free()
    return dict(
        card=card, arch=cfg.name, layers=f"{MOE_LAYERS} of {full.num_layers}",
        params=n_params, params_full=n_full,
        active_params=M.active_param_count(cfg), init_s=init_s,
        launches=launches, peak_gb=peak_gb, wall_s=run["wall_s"],
        submit_s=run["submit_s"], responses=len(run["tokens"]),
        prefill_tok_per_s={n: n / pre_s[n] for n in SERVE_PROMPTS},
        prefill_s=pre_s, **rates, profiles=profiles, checks=checks,
        graph=graph)


def _family_cpu_checks(params, cfg, n: int, seed: int) -> dict:
    """Phase 12b's card-vs-CPU check: the arch cut to its first ``n``
    layers in float32, a seeded random ``cond`` (vlm and audio) and the
    vlm's cross gates drawn nonzero (at zero they silence the block); the
    card's prefill logits and one decode step against the CPU's plain run
    of the same parameters, within DENSE_CPU_BOUND."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_defs, tree_map

    dev = torch.device("cuda")
    sub = _cut_params(params, cfg, n)
    gen = torch.Generator(device=dev).manual_seed(seed + 12)
    cond = None
    if cfg.family in ("vlm", "audio"):
        cond = torch.randn((1, cfg.n_cross_tokens, cfg.d_model),
                           generator=gen, device=dev)
    if "cross" in sub:
        gate = sub["cross"]["xattn"]["gate"]
        sub["cross"] = dict(sub["cross"], xattn=dict(
            sub["cross"]["xattn"],
            gate=torch.randn(gate.shape, generator=gen, device=dev)))
    c32 = dataclasses.replace(cfg, num_layers=n, dtype=torch.float32,
                              name=f"{cfg.name}-{n}L+f32")
    rng = np.random.default_rng(seed + 12)
    S = FAMILY_CHECK_PROMPT
    prompt = rng.integers(0, cfg.vocab_size, size=(1, S))
    tok = rng.integers(0, cfg.vocab_size, size=(1, 1))

    def decode(p, cache, d):
        step, _ = M.decode_step(
            p, c32, cache, torch.as_tensor(tok, device=d),
            torch.full((1,), S, dtype=torch.int32, device=d))
        return step.cpu()

    def run(p, d, cnd):
        t0 = time.perf_counter()
        logits, cache = M.prefill(p, c32, torch.as_tensor(prompt, device=d),
                                  cond=cnd, max_len=S + 8)
        # a host copy before the decode step writes into the cache
        kept = tree_map(lambda a: a.to("cpu", copy=True), cache)
        return (logits.cpu(), decode(p, cache, d), kept,
                time.perf_counter() - t0)

    cpu = torch.device("cpu")
    host_params = tree_map(lambda a: a.cpu(), sub)
    on_card = run(sub, dev, cond)
    host = run(host_params, cpu, None if cond is None else cond.cpu())
    # the CPU's decode step from the card's prefill cache: the hybrid's
    # conv tails are stored in bf16 (the reference's layout), where
    # float32 values ~1e-7 apart can round one bf16 step apart, and a step
    # from each side's own cache then parts by ~1e-4 (reported, not gated)
    from_card = decode(host_params, tree_map(lambda a: a.clone(),
                                             on_card[2]), cpu)
    own_rel = _rel(on_card[1], host[1])
    flipped = sum(int((a != b).sum()) for a, b in zip(
        (t for _, t in tree_defs(on_card[2])),
        (t for _, t in tree_defs(host[2]))) if a.dtype == torch.bfloat16)
    rel = {}
    for what, got, want in (("prefill", on_card[0], host[0]),
                            ("decode", on_card[1], from_card)):
        rel[what] = r = _rel(got, want)
        if not (bool(torch.isfinite(got).all()) and r < DENSE_CPU_BOUND):
            raise AssertionError(f"phase 12 {cfg.name}: the card's {what} "
                                 f"logits lie {r:.3e} from the CPU's "
                                 f"(bound {DENSE_CPU_BOUND})")
    if cfg.family == "hybrid":
        structure = dict(shared_blocks=len(M.zamba_groups(c32)))
    else:
        structure = dict(cross_blocks=len(sub["cross"]["norm_x"])
                         if "cross" in sub else n)
    return dict(layers=n, prompt=S, **structure, cpu_rel=rel,
                cpu_rel_bound=DENSE_CPU_BOUND,
                decode_own_cache_rel=own_rel, bf16_cache_entries_apart=flipped,
                logit_max_abs=float(host[1].abs().max()),
                card_s=on_card[3], cpu_s=host[3])


def run_family_serving(arch: str, check_layers: int, seed: int,
                       card: str) -> dict:
    """Phase 12b: one of the hybrid, vlm and audio archs at full width and
    depth in the engine, requests submitted directly."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_defs
    from repro_torch.serve.engine import zero_cond

    cfg = get_config(arch)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(seed),
                           dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in tree_defs(params))
    if n_params != M.param_count(cfg):
        raise AssertionError(f"phase 12 {arch}: {n_params} parameters, "
                             f"expected {M.param_count(cfg)}")
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in FAMILY_PROMPTS]
    _serve_timed(cfg, params, prompts, 2)  # warm-up
    gc.collect()
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    run = _serve_timed(cfg, params, prompts, FAMILY_NEW)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = _read_launches()
    _serving_gates(f"phase 12 {arch}", cfg, params, prompts, run, launches,
                   FAMILY_NEW, bus=False, loops=range(len(prompts)))
    checks = _family_cpu_checks(params, cfg, check_layers, seed)
    pre_s = _prefill_s(params, cfg, prompts)
    rates = _decode_rates(run, pre_s)
    graph = _graph_vs_eager(f"phase 12 {arch}", cfg, params, prompts, run,
                            pre_s, FAMILY_NEW, bus=False)
    # one profiled 2048-token prefill and 4-slot decode step
    tokens = torch.as_tensor(prompts[0], device=dev)[None].long()
    cond = zero_cond(cfg, dev)
    cache = M.init_cache(cfg, SERVE_SLOTS, SERVE_MAX_LEN, dev)
    step = torch.zeros((SERVE_SLOTS, 1), dtype=torch.long, device=dev)
    pos = torch.full((SERVE_SLOTS,), 100, dtype=torch.int32, device=dev)
    profiles = {
        "prefill_2048": _profile_range(
            lambda: M.prefill(params, cfg, tokens, cond=cond,
                              max_len=SERVE_MAX_LEN),
            1e3 * pre_s[len(prompts[0])]),
        "decode_step": _profile_range(
            lambda: M.decode_step(params, cfg, cache, step, pos),
            rates["ms_per_tick"])}
    del cache, params
    _free()
    return dict(arch=arch, family=cfg.family, params=n_params, init_s=init_s,
                launches=launches, peak_gb=peak_gb, wall_s=run["wall_s"],
                prefill_tok_per_s={n: n / pre_s[n] for n in FAMILY_PROMPTS},
                prefill_s=pre_s, **rates, profiles=profiles, checks=checks,
                graph=graph)


# phase 13: training rwkv6-3b on the card
TRAIN_ARGV = ["--arch", "rwkv6-3b", "--steps", "4", "--batch", "4", "--seq",
              "1024", "--microbatches", "2", "--device", "cuda"]
TRAIN_COMPRESS_ARGV = ["--arch", "rwkv6-3b", "--steps", "2", "--batch", "4",
                       "--seq", "1024", "--microbatches", "1", "--compress",
                       "--device", "cuda"]
# the leaves whose gradient reaches them only through the wkv: r, k and v's
# projections, the bonus u and the decay (w0 and its LoRA)
TRAIN_WKV_LEAVES = ("u", "wr", "wk", "wv", "w0", "td_w1", "td_w2")
TRAIN_RANGES = ("wkv_fwd", "wkv_bwd", "adamw", "xent")
# NVIDIA H100 SXM data sheet: dense bf16 peak at the 700 W limit
PEAK_BF16_OPS_PER_S = 989e12  # roofline.HW().peak_flops
# 13b: the card's float32 train step vs the CPU's at a 2-layer cut, each
# as max|Δ| / max|CPU leaf| (measured on an H100 at 700 W: the loss
# 8.2e-8, the gradients 1.71e-4 at worst (the embedding; wr 1.35e-4, the
# rest ≤ 1.3e-4); the parameters after AdamW on the same gradients
# 2.3e-7, the zero-initialised leaves, whose largest is lr); the full
# steps by tests/_torch_train.py's parameter rule (22,624 of 508,300,800
# parameters beyond it). One sequence, (1, 512), parts by 1.5e-2, 1.3e-2
# of it with the plain wkv on the card too (tools/train_cpu_gap.py;
# ROADMAP F14)
TRAIN_CHECK_LAYERS = 2
TRAIN_CHECK_BATCH = (2, 512)
# F14 (ROADMAP; tools/train_cpu_gap.py): at (1, 512) from seed 0 the
# model amplifies float32 rounding (a step with every op correctly
# rounded lies 3.52e-4 from float64 on both sides), and the card's cuBLAS
# float32 GEMMs round 1.3-2.7x farther from float64 than the CPU's
# (their error grows as sqrt(K)), so the card's step lies 1.59e-2 from
# float64, the CPU's 7.74e-4 and the card's with correctly rounded GEMMs
# 9.81e-4. Gates,
# each the worst leaf's max|Δ| / max|float64 leaf| (float64: the plain
# wkv on the card): the CPU's step and the card's with correctly rounded
# GEMMs (the port's own code on the card, the wkv kernel included)
# within TRAIN_F64_BOUND, twice the largest of the CPU's, the CPU's with
# every parameter changed in its last bit and the card's with correctly
# rounded GEMMs over seeds 0-4 (3.15e-3); the card's own step within
# TRAIN_F64_CARD_BOUND, twice the largest of the card's and the card's
# perturbed over those seeds (1.59e-2). Measured on an H100 at 700 W
# (bound_readings): a bf16 cast planted in the wkv's backward reads
# 0.283 (0.294 with correctly rounded GEMMs) at seed 0 and 0.0127 at
# the least over seeds 0-4; the wkv's logw gradient scaled by 1 + 1e-3
# reads 1.0e-3, under both bounds.
TRAIN_F64_BATCH = (1, 512)
TRAIN_F64_BOUND = 6.3e-3
TRAIN_F64_CARD_BOUND = 3.2e-2
TRAIN_CPU_LOSS_BOUND = 1e-6
TRAIN_CPU_GRAD_BOUND = 1e-3
TRAIN_CPU_PARAM_BOUND = 1e-6
TRAIN_PARAM_ATOL, TRAIN_PARAM_DIFF_SHARE = 1e-6, 1e-3
# 13c: tests/_torch_train.py's bounds for a step of the reduced configs
SMOKE_LOSS_REL = 1e-6
SMOKE_GRAD_ATOL, SMOKE_SUMMED_ATOL = 2e-5, 2e-3
SMOKE_SUMMED = ("embed/", "shared/")
SMOKE_PARAM_ATOL, SMOKE_PARAM_DIFF_SHARE = 1e-6, 1e-3
SMOKE_FAMILIES = ("gemma-2b", "mixtral-8x7b", "rwkv6-3b", "zamba2-1.2b",
                  "llama-3.2-vision-11b", "musicgen-large")


def _flat(tree) -> dict:
    from repro_torch.models.params import tree_defs
    return {"/".join(path): t for path, t in tree_defs(tree)}


def _train_flops(params, cfg, tokens: int) -> dict:
    """Model FLOPs of a step, 6·N·tokens, and those of the recompute apart:
    ``remat="nothing"`` runs each layer's forward again (2·N_layers·tokens)
    and the loss head recomputes each chunk's logits (2·N_head·tokens)."""
    flat = _flat(params)
    n = sum(t.numel() for t in flat.values())
    n_layers = sum(t.numel() for k, t in flat.items()
                   if k.startswith("layers/"))
    head = flat.get("embed/head", flat["embed/table"]).numel()
    return dict(params=n, tokens=tokens, model_flops=6.0 * n * tokens,
                recompute_flops=2.0 * (n_layers + head) * tokens)


def _train_main_run(card: str) -> tuple:
    """13a's main run: ``launch.train.run`` as ``python -m
    repro_torch.launch.train`` runs it with TRAIN_ARGV, the wkv launches
    counted per step, the wkv-only leaves' first moments read after step
    1. Returns the result dict and the trained run's output."""
    import statistics

    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch

    per_step, zero, retries = [], {}, []

    def on_step(i, state, m):
        per_step.append(ops.wkv_chunk.launches - sum(per_step))
        retries.append(torch.cuda.memory_stats().get("num_alloc_retries", 0))
        if i == 1:  # m = 0.1 · clip scale · grad after the first step
            mom = state["opt"]["m"]["layers"]
            for leaf in TRAIN_WKV_LEAVES:
                amax = mom[leaf].abs().flatten(1).amax(1).cpu()
                zero[leaf] = [j for j, a in enumerate(amax.tolist())
                              if not a > 0]

    args = launch.parse_args(TRAIN_ARGV)
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    out = launch.run(args, on_step=on_step)
    launches = _read_launches()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cfg = out["cfg"]
    want = 2 * cfg.num_layers * args.microbatches
    if per_step != [want] * args.steps or launches != {
            **{k: 0 for k in KERNELS}, "wkv_chunk": want * args.steps}:
        raise AssertionError(f"phase 13: wkv_chunk launches per step "
                             f"{per_step}, all {launches}; expected {want} "
                             f"a step (forward and remat recompute, per "
                             f"microbatch)")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"phase 13: losses {out['losses']}")
    if any(zero.values()) or len(zero) != len(TRAIN_WKV_LEAVES):
        raise AssertionError(f"phase 13: after step 1 the gradient is zero "
                             f"in layers {zero} (leaves reached only "
                             f"through the wkv)")
    s_step = statistics.median(out["step_s"][1:])
    tokens = args.batch * args.seq
    flops = _train_flops(out["state"]["params"], cfg, tokens)
    rates = dict(
        s_per_step=s_step, tokens_per_s=tokens / s_step,
        model_flops_per_s=flops["model_flops"] / s_step,
        model_flops_share=flops["model_flops"] / s_step / PEAK_BF16_OPS_PER_S,
        with_recompute_share=(flops["model_flops"] + flops["recompute_flops"])
        / s_step / PEAK_BF16_OPS_PER_S, peak="bf16 dense 989 TFLOP/s, "
        f"NVIDIA H100 SXM data sheet; this card: {card}")
    result = dict(argv=TRAIN_ARGV, arch=cfg.name, remat=cfg.remat,
                  losses=out["losses"], step_s=out["step_s"],
                  launches_per_step=per_step[0],
                  wkv_leaves_zero_layers=zero,
                  peak_gb=peak_gb, alloc_retries=retries, **flops, **rates)
    return result, out


def _train_profile(out) -> dict:
    """One step of one microbatch on 13a's trained state in one trace:
    the main run's microbatch (batch / microbatches rows, the same
    kernels), so the trace holds half a step's ~196k kernels; its device
    time, busy share and the TRAIN_RANGES' shares (``xent``: the loss
    head's forward; its backward and its recompute run outside the
    range). ``per_step``: the main run's step from it, every range but
    ``adamw`` (once a step) and the rest of the device time (the layers'
    matmuls and the accumulation, per microbatch) taken ``microbatches``
    times."""
    import dataclasses

    import torch
    from repro_torch.data import TokenDataset
    from repro_torch.launch import train as launch
    from repro_torch.train import make_train_step

    args = launch.parse_args(TRAIN_ARGV)
    k = args.microbatches
    step_fn = make_train_step(out["cfg"], dataclasses.replace(
        out["tc"], microbatches=1))
    dev = torch.device("cuda")
    b = TokenDataset(out["cfg"].vocab_size, args.seq, seed=0).shard_batch(
        args.steps, args.batch // k)
    batch = {k: torch.as_tensor(v, device=dev) for k, v in b.items()}
    box = [out["state"]]

    def one():
        box[0] = step_fn(box[0], batch)[0]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    prof = _profile_range(one, wall_ms, *TRAIN_RANGES, warm=False)
    out["state"] = box[0]
    layers = out["cfg"].num_layers
    want = dict(wkv_fwd=2 * layers, wkv_bwd=layers, adamw=1, xent=1)
    got = {n: prof["by_range"][n]["ranges"] for n in want}
    if got != want:
        raise AssertionError(f"phase 13: the profiled step holds ranges "
                             f"{got}, expected {want}")
    adamw = prof["by_range"]["adamw"]["range_ms"]
    step_ms = k * (prof["device_ms"] - adamw) + adamw
    prof["per_step"] = dict(microbatches=k, device_ms=step_ms, shares={
        n: (adamw if n == "adamw" else k * r["range_ms"]) / step_ms
        for n, r in prof["by_range"].items()})
    return prof


def _train_compress_run() -> dict:
    """13a's second run: TRAIN_COMPRESS_ARGV (int8 error feedback, one
    microbatch); the residual must be nonzero."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch

    per_step = []
    args = launch.parse_args(TRAIN_COMPRESS_ARGV)
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    out = launch.run(args, on_step=lambda i, st, m: per_step.append(
        ops.wkv_chunk.launches - sum(per_step)))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    want = 2 * out["cfg"].num_layers
    if per_step != [want] * args.steps:
        raise AssertionError(f"phase 13 (compress): wkv_chunk launches per "
                             f"step {per_step}, expected {want}")
    if not all(math.isfinite(x) for x in out["losses"]):
        raise AssertionError(f"phase 13 (compress): losses {out['losses']}")
    ef = _flat(out["state"]["ef"])
    nonzero = sum(int(bool(t.abs().amax() > 0)) for t in ef.values())
    if not nonzero:
        raise AssertionError("phase 13 (compress): the int8_ef residual is "
                             "zero")
    res = dict(argv=TRAIN_COMPRESS_ARGV, losses=out["losses"],
               step_s=out["step_s"], launches_per_step=per_step[0],
               peak_gb=peak_gb,
               ef_leaves_nonzero=f"{nonzero} of {len(ef)}",
               ef_abs_max=max(float(t.abs().amax()) for t in ef.values()))
    del out
    return res


def _train_wkv_gradient(seed: int) -> dict:
    """13b (i): the kernel's wrapper on inputs that require grad at one
    full-width layer's shape from a random state: it launches once through
    WkvChunk, its output lies within WKV_BOUND of the plain version's and
    its six gradients equal autograd's through the plain version bit for
    bit. Then each training shape (a microbatch of the main run, the
    ``--compress`` run's batch): the kernel's output and final state
    within WKV_BOUND of the plain version's, timed beside its bound, with
    the plain backward's time."""
    import torch
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed + 13)
    shape = (2, 1024, 40, 64)
    a = _wkv_inputs(shape, 2.0, gen)
    g_out = torch.randn(shape, generator=gen, device=dev)
    g_state = torch.randn(a[5].shape, generator=gen, device=dev)
    xs = [t.clone().requires_grad_() for t in a]
    n0 = ops.wkv_chunk.launches
    out, state = ops.wkv_chunk(*xs)
    if ops.wkv_chunk.launches != n0 + 1 or out.grad_fn is None:
        raise AssertionError("phase 13: wkv_chunk on inputs that require "
                             "grad did not launch once through WkvChunk")
    got = torch.autograd.grad((out, state), xs, (g_out, g_state))
    ys = [t.clone().requires_grad_() for t in a]
    out2, state2 = ref.wkv_chunked_ref(*ys)
    want = torch.autograd.grad((out2, state2), ys, (g_out, g_state))
    rel = max(_rel(out.detach(), out2.detach()),
              _rel(state.detach(), state2.detach()))
    unequal = [n for n, g, w in zip(("r", "k", "v", "logw", "u", "state"),
                                    got, want) if not torch.equal(g, w)]
    if not rel < WKV_BOUND or unequal:
        raise AssertionError(f"phase 13: WkvChunk output {rel:.3e} of the "
                             f"plain version's (bound {WKV_BOUND}); "
                             f"gradients unequal: {unequal}")
    del xs, ys, out, state, out2, state2, got, want
    timed = {}
    for shp in ((2, 1024, 40, 64), (4, 1024, 40, 64)):
        b = _wkv_inputs(shp, 2.0, gen)
        out, state = ops.wkv_chunk(*b)
        out2, state2 = ref.wkv_chunked_ref(*b)
        err = max(_rel(out, out2), _rel(state, state2))
        if not err < WKV_BOUND:
            raise AssertionError(f"phase 13: wkv_chunk at {shp} {err:.3e} "
                                 f"of the plain version's (bound "
                                 f"{WKV_BOUND})")
        del out, state, out2, state2
        bound_ms, bound_by = _wkv_bound(shp)
        xs = [t.clone().requires_grad_() for t in b]
        g = (torch.randn(shp, generator=gen, device=dev),
             torch.zeros_like(b[5]))

        def bwd():
            o = ops.WkvChunk.apply(*xs)
            torch.autograd.grad(o, xs, g)

        timed["x".join(map(str, shp))] = dict(
            rel_err=err, ms=_time_ms(lambda: ops.wkv_chunk(*b)),
            bound_ms=bound_ms, bound_by=bound_by,
            fwd_bwd_ms=_time_ms(bwd, reps=3, warmup=1))
        del b, xs, g
    return dict(shape=list(shape), rel_err=rel, rel_bound=WKV_BOUND,
                grads_bit_equal=True, timed=timed)


def _train_cpu_gap(seed: int, batch=TRAIN_CHECK_BATCH) -> dict:
    """13b (ii), the measurement: rwkv6-3b at full width cut to
    TRAIN_CHECK_LAYERS layers, float32 compute, its bf16 weights (drawn on
    the card) held in float32 leaves (the same values; the gradients then
    come out in float32): one train step of one microbatch of ``batch``
    (``loss_and_grads``, then ``adamw_update``) on the card (the wkv
    kernel through WkvChunk) and on the CPU (the plain wkv). Each leaf
    against the CPU's as max|Δ| / max|CPU leaf|: the loss and every
    gradient leaf; the card's AdamW on the CPU's gradients against the
    CPU's AdamW (the optimizer alone). The card's full step against the
    CPU's full step by tests/_torch_train.py's rule: the parameters
    beyond |Δ| ≤ 2^-7·|ref| + TRAIN_PARAM_ATOL·max|ref leaf| are counted
    (``beyond``, by leaf). AdamW's first step moves each element by
    lr·ĝ/(|ĝ| + eps), so an element whose clipped gradient is near eps
    (zero-initialised ``mu_x``'s) turns a gradient difference within its
    bound into a large share of lr. :func:`_train_cpu_check` gates it."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map
    from repro_torch.train import TrainConfig, adamw_update
    from repro_torch.train.optim import init_opt
    from repro_torch.train.step import loss_and_grads

    n = TRAIN_CHECK_LAYERS
    full = get_config("rwkv6-3b")
    cfg = dataclasses.replace(full, num_layers=n, dtype=torch.float32,
                              name=f"{full.name}-{n}L+f32")
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    card = tree_map(lambda t: t.float(), M.init_params(cfg, gen, dev))
    host = tree_map(lambda t: t.to(cpu, copy=True), card)
    B, S = batch
    b = TokenDataset(cfg.vocab_size, S, seed=seed).shard_batch(0, B)
    tc = TrainConfig(lr=3e-3, warmup_steps=2, total_steps=10)
    took = {}

    def timed(what, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        took[what] = time.perf_counter() - t0
        return out

    def grads_on(params, d):
        loss, grads = loss_and_grads(params, cfg, {
            k: torch.as_tensor(v, device=d) for k, v in b.items()})
        return float(loss), grads

    loss_c, grads_c = timed("card_grads_s", lambda: grads_on(card, dev))
    loss_h, grads_h = timed("cpu_grads_s", lambda: grads_on(host, cpu))
    timed("cpu_adamw_s", lambda: adamw_update(tc, host, grads_h,
                                              init_opt(host)))
    grads_h = tree_map(lambda t: t.to(dev), grads_h)
    same = tree_map(lambda t: t.clone(), card)
    adamw_update(tc, same, grads_h, init_opt(same))
    adamw_update(tc, card, grads_c, init_opt(card))
    gc, gh, pc, ps, ph = (_flat(t) for t in (
        grads_c, grads_h, card, same, tree_map(lambda t: t.to(dev), host)))
    del grads_c, grads_h, card, same, host

    def rel(got, want):
        return {k: float((got[k] - w).abs().max() / w.abs().max())
                for k, w in want.items()}

    grad_rel, same_rel = rel(gc, gh), rel(ps, ph)
    beyond, excess = {}, 0.0
    for k, w in ph.items():
        d = (pc[k] - w).abs()
        lim = 2.0 ** -7 * w.abs() + TRAIN_PARAM_ATOL * w.abs().max()
        beyond[k] = int((d > lim).sum())
        excess = max(excess, float(((d - lim) / w.abs().max()).max()))
    n_params = sum(t.numel() for t in ph.values())
    worst = dict(loss=abs(loss_c - loss_h) / abs(loss_h),
                 grad=max(grad_rel.values()),
                 grad_leaf=max(grad_rel, key=grad_rel.get),
                 same_grads_param=max(same_rel.values()),
                 same_grads_param_leaf=max(same_rel, key=same_rel.get),
                 beyond=sum(beyond.values()), of=n_params,
                 beyond_by_leaf={k: c for k, c in beyond.items() if c},
                 beyond_max_excess=excess)
    return dict(layers=n, batch=list(batch), worst=worst,
                bounds=dict(loss=TRAIN_CPU_LOSS_BOUND,
                            grad=TRAIN_CPU_GRAD_BOUND,
                            same_grads_param=TRAIN_CPU_PARAM_BOUND,
                            param_atol=TRAIN_PARAM_ATOL,
                            beyond_share=TRAIN_PARAM_DIFF_SHARE),
                grad_rel=grad_rel, same_grads_param_rel=same_rel,
                loss=loss_h, card_loss=loss_c, **took)


def _train_cpu_check(seed: int) -> dict:
    """13b (ii): :func:`_train_cpu_gap` at TRAIN_CHECK_BATCH within the
    TRAIN_CPU_* bounds and at most TRAIN_PARAM_DIFF_SHARE of the
    parameters beyond the per-element rule."""
    r = _train_cpu_gap(seed)
    worst = r["worst"]
    if not (worst["loss"] < TRAIN_CPU_LOSS_BOUND
            and worst["grad"] < TRAIN_CPU_GRAD_BOUND
            and worst["same_grads_param"] < TRAIN_CPU_PARAM_BOUND
            and worst["beyond"] <= TRAIN_PARAM_DIFF_SHARE * worst["of"]
            and math.isfinite(r["card_loss"])):
        raise AssertionError(f"phase 13: the card's train step against the "
                             f"CPU's: {worst} (bounds loss "
                             f"{TRAIN_CPU_LOSS_BOUND}, grad "
                             f"{TRAIN_CPU_GRAD_BOUND}, param on the same "
                             f"gradients {TRAIN_CPU_PARAM_BOUND}, beyond "
                             f"{TRAIN_PARAM_DIFF_SHARE} of the parameters)")
    return r


def _lm_grads(params, cfg, b, device, impl: str) -> dict:
    """Every parameter's gradient of ``M.lm_loss`` on batch ``b`` (numpy)
    at ``params`` moved to ``device``, by leaf path."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_defs
    from repro_torch.train.step import _unflatten

    paths, leaves = zip(*((p, t.detach().to(device).requires_grad_())
                          for p, t in tree_defs(params)))
    batch = {k: torch.as_tensor(v, device=device) for k, v in b.items()}
    with torch.enable_grad():
        loss = M.lm_loss(_unflatten(paths, leaves), cfg, batch, impl=impl)
        grads = torch.autograd.grad(loss, leaves)
    return {"/".join(p): g for p, g in zip(paths, grads)}


def _train_f64_check(seed: int) -> dict:
    """13b (iii), F14's gate: at TRAIN_CHECK_LAYERS layers of the full
    width, one microbatch of TRAIN_F64_BATCH (13b's weights, float32
    leaves), each side's gradients against those computed in float64 on
    the card with the plain wkv: the CPU's (the plain wkv) and the card's
    with every GEMM correctly rounded (computed in float64, rounded once;
    the wkv kernel) within TRAIN_F64_BOUND, the card's own within
    TRAIN_F64_CARD_BOUND."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map
    sys.path.insert(0, str(ROOT / "tools"))
    from train_cpu_gap import exact_mode

    full = get_config("rwkv6-3b")
    cfg = dataclasses.replace(full, num_layers=TRAIN_CHECK_LAYERS,
                              dtype=torch.float32)
    dev, cpu = torch.device("cuda"), torch.device("cpu")
    gen = torch.Generator(device=dev).manual_seed(seed + 14)
    card = tree_map(lambda t: t.float(), M.init_params(cfg, gen, dev))
    B, S = TRAIN_F64_BATCH
    b = TokenDataset(cfg.vocab_size, S, seed=seed).shard_batch(0, B)
    f64 = _lm_grads(tree_map(lambda t: t.double(), card),
                    dataclasses.replace(cfg, dtype=torch.float64), b, dev,
                    "ref")
    with exact_mode({"gemm"}):
        exact = _lm_grads(card, cfg, b, dev, "auto")
    sides = {"card": _lm_grads(card, cfg, b, dev, "auto"),
             "card_exact_gemm": exact,
             "cpu": _lm_grads(card, cfg, b, cpu, "auto")}
    bounds = {"card": TRAIN_F64_CARD_BOUND,
              "card_exact_gemm": TRAIN_F64_BOUND, "cpu": TRAIN_F64_BOUND}
    dist = {side: {k: float((g[k].to(dev).double() - w).abs().max()
                            / w.abs().max()) for k, w in f64.items()}
            for side, g in sides.items()}
    worst = {side: max(d.values()) for side, d in dist.items()}
    if not all(worst[side] <= bounds[side] for side in sides):
        raise AssertionError(f"phase 13: at {TRAIN_F64_BATCH} the float32 "
                             f"gradients lie {worst} from float64 (bounds "
                             f"{bounds})")
    return dict(batch=list(TRAIN_F64_BATCH), bounds=bounds, worst=worst,
                by_leaf=dist)


def _train_resume(seed: int) -> dict:
    """13c (i): rwkv6-3b at full width cut to TRAIN_CHECK_LAYERS layers
    (bf16), under ``torch.use_deterministic_algorithms(True)``: 3 steps
    uninterrupted against 2 steps, an ``AsyncCheckpointer`` save, a
    restore and 1 step: the state and the last loss equal bit for bit;
    where they are not, a second uninterrupted run measures how far two
    runs part, the resumed run must lie within that (each leaf's
    max|Δ|), and the ops that warned of no deterministic version are
    named."""
    import dataclasses
    import os
    import shutil
    import warnings

    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.train import (TrainConfig, init_train_state,
                                   make_train_step, train_state_defs)
    from repro_torch.train.checkpoint import (AsyncCheckpointer,
                                              restore_checkpoint)

    full = get_config("rwkv6-3b")
    cfg = dataclasses.replace(full, num_layers=TRAIN_CHECK_LAYERS,
                              name=f"{full.name}-{TRAIN_CHECK_LAYERS}L")
    tc = TrainConfig(lr=3e-3, warmup_steps=2, total_steps=3, microbatches=2)
    dev = torch.device("cuda")
    ds = TokenDataset(cfg.vocab_size, 1024, seed=0)
    step = make_train_step(cfg, tc)
    ckpt = ROOT / "build" / "phase13_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)

    def batch(i):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in ds.shard_batch(i, 4).items()}

    def fresh():
        return init_train_state(
            cfg, tc, torch.Generator(device=dev).manual_seed(seed), dev)

    def steps(state, first, last):
        loss = None
        for i in range(first, last):
            state, m = step(state, batch(i))
            loss = float(m["loss"])
        return state, loss

    def apart(x, y) -> dict:
        fx, fy = _flat(x), _flat(y)
        return {k: float((fy[k].float() - t.float()).abs().max())
                for k, t in fx.items()}

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            a, loss_a = steps(fresh(), 0, 3)
            b, _ = steps(fresh(), 0, 2)
            state_gb = sum(t.numel() * t.element_size()
                           for t in _flat(b).values()) / 1e9
            ck = AsyncCheckpointer(ckpt, keep=1)
            t0 = time.perf_counter()
            ck.save(2, b)
            save_s = time.perf_counter() - t0
            del b
            ck.wait()
            write_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            b, at = restore_checkpoint(ckpt, train_state_defs(cfg, tc),
                                       device=dev)
            restore_s = time.perf_counter() - t0
            b, loss_b = steps(b, at, 3)
            diff = apart(a, b)
            bit_equal = not any(diff.values()) and loss_b == loss_a
            spread = None
            if not bit_equal:  # how far two uninterrupted runs part
                spread = apart(a, steps(fresh(), 0, 3)[0])
    finally:
        torch.use_deterministic_algorithms(False)
        shutil.rmtree(ckpt, ignore_errors=True)
    ops_warned = sorted({str(w.message).split(" does not have")[0][:80]
                         for w in caught if "deterministic" in str(w.message)})
    if spread is not None:
        beyond = {k: d for k, d in diff.items() if d > spread[k]}
        if beyond:
            raise AssertionError(f"phase 13: the resumed run parts from the "
                                 f"uninterrupted one at {beyond}, beyond "
                                 f"two uninterrupted runs' spread; ops with "
                                 f"no deterministic version: {ops_warned}")
    return dict(layers=TRAIN_CHECK_LAYERS, state_gb=state_gb,
                bit_equal=bit_equal, resumed_max_abs=max(diff.values()),
                spread_max=None if spread is None else max(spread.values()),
                nondeterministic_ops=ops_warned, losses=[loss_a, loss_b],
                save_call_s=save_s, save_total_s=write_s,
                restore_s=restore_s)


def _train_smoke_families(seed: int) -> dict:
    """13c (ii): one train step of each family's reduced config on the card
    against the CPU, within tests/_torch_train.py's bounds (the loss; each
    bf16 gradient and updated parameter within one bf16 step plus its
    atol; at most SMOKE_PARAM_DIFF_SHARE of the parameters apart)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data import TokenDataset
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map
    from repro_torch.train import TrainConfig, make_train_step
    from repro_torch.train.optim import init_opt
    from repro_torch.train.step import loss_and_grads

    dev = torch.device("cuda")
    tc = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=10)
    rows = {}
    for arch in SMOKE_FAMILIES:
        cfg = get_config(arch + "-smoke")
        host = M.init_params(cfg, torch.Generator().manual_seed(seed),
                             "cpu")
        rng = np.random.default_rng(seed)
        if "cross" in host:  # the vlm's gates start at 0: draw them nonzero
            gate = host["cross"]["xattn"]["gate"]
            gate.copy_(torch.from_numpy(rng.normal(size=gate.shape)))
        b = TokenDataset(cfg.vocab_size, 32, seed=1).shard_batch(0, 4)
        if cfg.family in ("vlm", "audio"):
            b["cond"] = rng.normal(size=(4, cfg.n_cross_tokens, cfg.d_model)
                                   ).astype(np.float32)
        out = {}
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            params = tree_map(lambda t: t.to(d, copy=True), host)
            batch = {k: torch.as_tensor(v, device=d) for k, v in b.items()}
            loss, grads = loss_and_grads(params, cfg, batch)
            state, m = make_train_step(cfg, tc)(
                {"params": params, "opt": init_opt(params)}, batch)
            out[where] = (float(loss), _flat(tree_map(
                lambda t: t.double().cpu(), grads)), _flat(tree_map(
                    lambda t: t.double().cpu(), state["params"])),
                float(m["loss"]))
        (lc, gc, pc, sc), (lh, gh, ph, sh) = out["card"], out["cpu"]
        worst = dict(loss=max(abs(lc - lh) / abs(lh), abs(sc - sh) / abs(sh)))
        for what, got, want, atol, summed in (
                ("grad", gc, gh, SMOKE_GRAD_ATOL, SMOKE_SUMMED_ATOL),
                ("param", pc, ph, SMOKE_PARAM_ATOL, SMOKE_PARAM_ATOL)):
            excess, apart = 0.0, 0
            for k, w in want.items():
                a = summed if k.startswith(SMOKE_SUMMED) else atol
                d = (got[k] - w).abs()
                lim = 2.0 ** -7 * w.abs() + a * w.abs().max()
                excess = max(excess, float((d - lim).max()))
                apart += int((d > 0).sum())
            worst[what + "_excess"] = excess
            worst[what + "_apart"] = apart
        n = sum(t.numel() for t in ph.values())
        if not (worst["loss"] <= SMOKE_LOSS_REL and worst["grad_excess"] <= 0
                and worst["param_excess"] <= 0
                and worst["param_apart"] <= SMOKE_PARAM_DIFF_SHARE * n):
            raise AssertionError(f"phase 13: {cfg.name}'s train step on the "
                                 f"card against the CPU's: {worst}")
        rows[cfg.name] = worst
    return rows


def _train_elastic(seed: int) -> dict:
    """13c (iii): one ElasticTrainer epoch of gemma-2b's reduced config on
    the card, 10 shards over 2 workers, w0 killed mid-shard: every shard
    applied once."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import SimScheduler
    from repro_torch.data import TokenDataset
    from repro_torch.train import TrainConfig, init_train_state
    from repro_torch.train.elastic import ElasticTrainer

    dev = torch.device("cuda")
    cfg = get_config("gemma-2b-smoke")
    tc = TrainConfig(lr=1e-3, warmup_steps=2, total_steps=50)
    state = init_train_state(
        cfg, tc, torch.Generator(device=dev).manual_seed(seed), dev)
    ds = TokenDataset(cfg.vocab_size, 32, seed=0)
    sched = SimScheduler()
    t = ElasticTrainer(sched, cfg, tc, state,
                       lambda shard: ds.shard_batch(shard, 4))
    for i in range(2):
        t.add_worker(f"w{i}")
    sched.schedule(15.0, lambda: t.kill_worker("w0"))
    done = t.run_epoch(n_shards=10)
    if done != list(range(10)) or len(t.losses) != 10 or not all(
            math.isfinite(x) for x in t.losses):
        raise AssertionError(f"phase 13: elastic epoch applied {done}, "
                             f"{len(t.losses)} updates")
    return dict(shards=10, applied=len(t.losses),
                device=str(state["opt"]["count"].device),
                losses=t.losses)


def run_training(seed: int, card: str) -> dict:
    """Phase 13: training rwkv6-3b on the card (module doc)."""
    t0 = time.perf_counter()
    out, parts_s = {}, {}

    def part(name, fn):
        t = time.perf_counter()
        out[name] = fn()
        _free()
        parts_s[name] = time.perf_counter() - t

    part("main", lambda: _train_main_run(card))
    out["main"], trained = out["main"]
    part("profile", lambda: _train_profile(trained))
    del trained
    _free()
    part("compress", _train_compress_run)
    part("wkv", lambda: _train_wkv_gradient(seed))
    part("cpu_check", lambda: _train_cpu_check(seed))
    part("f64_check", lambda: _train_f64_check(seed))
    part("resume", lambda: _train_resume(seed))
    part("smoke_families", lambda: _train_smoke_families(seed))
    part("elastic", lambda: _train_elastic(seed))
    return dict(card=card, **out, parts_s=parts_s,
                phase_s=time.perf_counter() - t0)


# phase 14: the planning layer's counts and roofline against the card
ROOF_ARCH = "rwkv6-3b"
# (name, seq_len, batch, kind): a 2048-token prefill; a decode step at 4
# slots of max_len 4096 (phase 9's engine)
ROOF_CELLS = (("prefill_2k", 2048, 1, "prefill"),
              ("decode_4k", SERVE_MAX_LEN, SERVE_SLOTS, "decode"))
ROOF_TIME_REPS = 5
# the largest share of the roofline a reading may show: a share above it
# (the card beating the least time its work could take) fails the phase
ROOF_SHARE_MAX = 1.05
# |predicted − measured| / measured of the memory the step allocates above
# its arguments: the meta run's live-storage peak against the card's
# allocator peak less what it held before the step (PERF.md §6 states
# it, written before the first run)
ROOF_MEM_BOUND = 0.10
# phase 9's wkv_chunk calls per prefill: one per layer
ROOF_WKV_PER_PREFILL = 32
# one production cell, counted on meta tensors in a process of its own
ROOF_PRODUCTION_CELL = ("phi4-mini-3.8b", "decode_32k", "single")


def _op_diff(a: dict, b: dict) -> dict:
    """The ops whose [calls, flops, bytes, flops_f32] differ between two
    op tables."""
    return {k: (a.get(k), b.get(k)) for k in sorted(set(a) | set(b))
            if a.get(k) != b.get(k)}


def run_roofline(seed: int, card: str) -> dict:
    """Phase 14: ``rwkv6-3b`` at full width and depth, a 2048-token
    prefill and a 4-slot decode step, each counted through
    ``launch.dryrun.run_cell`` on the card and on meta tensors (the plain
    wkv), then timed (CUDA events, median of ROOF_TIME_REPS). Gates: the
    card's FLOPs (all, and those at the float32 rate) and bytes equal the
    meta run's exactly (the wkv counted
    once a call by its formula); the share bound / time at most
    ROOF_SHARE_MAX; the step's own memory (above its arguments)
    predicted within ROOF_MEM_BOUND of the measured one;
    ROOF_WKV_PER_PREFILL ``wkv_chunk`` launches a
    prefill and none a decode step. The decode step is also timed as the
    engine runs it, a CUDA graph replay (``graph_step_ms``, its share of
    the same bound, at most ROOF_SHARE_MAX; no launch counted inside the
    capture). Then ROOF_PRODUCTION_CELL through
    ``python -m repro_torch.launch.dryrun --one`` in a subprocess:
    ``ok`` with its collectives counted."""
    import torch
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.models import model as M
    from repro_torch.roofline import HW

    t0 = time.perf_counter()
    cfg = get_config(ROOF_ARCH)
    gen = torch.Generator(device=torch.device("cuda")).manual_seed(seed)
    params = M.init_params(cfg, gen, "cuda")
    n_params = M.param_count(cfg)
    peak = HW().peak_flops
    cells = {}
    for name, seq, batch, kind in ROOF_CELLS:
        shape = ShapeConfig(name, seq, batch, kind)
        meta = dryrun.run_cell(cfg, shape, "local", device="meta")
        _zero_launches()
        run = dryrun.run_cell(cfg, shape, "local", device="cuda",
                              params=params, seed=seed,
                              time_reps=ROOF_TIME_REPS)
        launches = _read_launches()
        for rec in (meta, run):
            if not rec.get("ok"):
                raise AssertionError(f"phase 14 {name}: the {rec['device']} "
                                     f"cell failed: {rec.get('error')}")
        counts = {k: (run[k], meta[k]) for k in (
            "flops_per_device", "f32_flops_per_device", "bytes_per_device")}
        if any(a != b for a, b in counts.values()):
            raise AssertionError(
                f"phase 14 {name}: the card counts {counts} (card, meta); "
                f"ops that differ: {_op_diff(run['ops'], meta['ops'])}")
        step_s = run["step_ms"] / 1e3
        share = run["bound_s"] / step_s
        if not share <= ROOF_SHARE_MAX:
            raise AssertionError(f"phase 14 {name}: {step_s * 1e3:.4f} ms "
                                 f"against a bound of {run['bound_s'] * 1e3:.4f}"
                                 f" ms: share {share:.3f} > {ROOF_SHARE_MAX}")
        predicted = meta["memory"]["temp_bytes"]
        measured = run["measured_temp_bytes"]
        mem_err = abs(predicted - measured) / measured
        if not mem_err <= ROOF_MEM_BOUND:
            raise AssertionError(f"phase 14 {name}: the step's own memory "
                                 f"predicted {predicted} B, measured "
                                 f"{measured} B ({mem_err:.4f} > "
                                 f"{ROOF_MEM_BOUND})")
        per_step = launches["wkv_chunk"] / run["step_calls"]
        want = ROOF_WKV_PER_PREFILL if kind == "prefill" else 0
        if per_step != want or run["ops"].get("kernel.wkv_chunk", [0])[0] \
                != want or any(v for k, v in launches.items()
                               if k != "wkv_chunk"):
            raise AssertionError(f"phase 14 {name}: launches {launches} over "
                                 f"{run['step_calls']} steps; expected "
                                 f"{want} wkv_chunk a step")
        graph = {}
        if kind == "decode":
            graph_s = run["graph_step_ms"] / 1e3
            graph = dict(graph_step_ms=run["graph_step_ms"],
                         graph_share=run["bound_s"] / graph_s,
                         graph_captured_launches=run[
                             "graph_captured_launches"])
            if not graph["graph_share"] <= ROOF_SHARE_MAX or \
                    graph["graph_captured_launches"]:
                raise AssertionError(
                    f"phase 14 {name}: the graph replay: {graph}")
        tokens = batch * (seq if kind == "prefill" else 1)
        cells[name] = dict(
            shape=[batch, seq], kind=kind, flops=run["flops_per_device"],
            f32_flops=run["f32_flops_per_device"],
            bytes=run["bytes_per_device"],
            terms={k: run[k] for k in ("compute_s", "memory_s",
                                       "collective_s", "dominant",
                                       "bound_s")},
            step_ms=run["step_ms"], share=share, time_ge_bound=step_s >=
            run["bound_s"], model_flop_share=2.0 * n_params * tokens
            / step_s / peak, temp_predicted_bytes=predicted,
            temp_measured_bytes=measured, temp_rel_err=mem_err,
            peak_predicted_bytes=meta["hbm_per_device"],
            peak_measured_bytes=run["measured_peak_bytes"],
            wkv_launches_per_step=per_step,
            lower_s_card=run["lower_s"], lower_s_meta=meta["lower_s"],
            **graph)
        _log(f"phase 14 {name}: " + json.dumps(cells[name]))
    del params
    _free()

    t = time.perf_counter()
    out_dir = ROOT / "artifacts" / "dryrun_torch"
    arch, shp, mesh = ROOF_PRODUCTION_CELL
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--one", arch,
         shp, mesh, "--dir", str(out_dir)], capture_output=True, text=True,
        timeout=300, env={**__import__("os").environ,
                          "PYTHONPATH": str(ROOT / "src")})
    rec_path = out_dir / (dryrun.cell_name(arch, shp, mesh) + ".json")
    rec = json.loads(rec_path.read_text()) if rec_path.exists() else {}
    if r.returncode or not rec.get("ok") or not rec["collectives"]["total"]:
        raise AssertionError(f"phase 14: the {arch} {shp} {mesh} cell: exit "
                             f"{r.returncode}, {rec.get('error')}; "
                             f"{r.stderr[-1500:]}")
    production = {k: rec[k] for k in (
        "arch", "shape", "mesh", "chips", "weight_policy",
        "flops_per_device", "bytes_per_device", "collectives", "memory",
        "hbm_per_device", "fits_hbm", "dominant", "bound_s", "lower_s")}
    production["subprocess_s"] = time.perf_counter() - t
    return dict(card=card, arch=ROOF_ARCH, cells=cells,
                production=production, phase_s=time.perf_counter() - t0)


# phase 15: the data mesh (level batches split over the visible cards);
# the circle's levels hold 961, 225, 49, 9 and 1 tiles: none splits evenly
MESH_SIZE = 7936


def _mesh_split() -> tuple:
    """The split mesh: every visible card where there are several, else
    the one card named twice (its two shards run one after the other)."""
    import torch
    n = torch.cuda.device_count()
    return tuple(f"cuda:{i}" for i in range(n)) if n > 1 \
        else ("cuda:0", "cuda:0")


def _mesh_launches(counts: list, shards: int) -> int:
    """Launches of one whole-level kernel over levels of ``counts`` tiles:
    one a non-empty shard (``ops.data_sharding``), ``min(n, shards)``."""
    return sum(min(n, shards) for n in counts)


def _under(mesh, fn, *args):
    from repro_torch.kernels import ops
    with ops.use_mesh(mesh):
        return fn(*args)


def _device_copies(fn) -> dict:
    """The device copies of one call of ``fn`` (after a warm call), read
    from a profiler trace: the memcpy events the cards ran (``n``) and the
    bytes they moved (``bytes``, from each event's metadata; None where an
    event carries none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    n, moved = 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or not e.name().startswith("Memcpy"):
            continue
        n += 1
        try:
            b = json.loads("{" + e.metadata_json() + "}").get("bytes")
        except ValueError:
            b = None
        moved = None if moved is None or b is None else moved + int(b)
    return dict(n=n, bytes=moved)


def _mesh_kernel(name: str, x, split: tuple, one: tuple) -> tuple:
    """One whole-level kernel on ``x`` under the split mesh and the
    one-entry mesh: equal element for element, one launch a shard counted,
    both timed (CUDA events, median of 10) and their device copies read
    from a trace (:func:`_device_copies`). Returns the split result and
    the record."""
    import torch
    from repro_torch.kernels import ops
    fn = getattr(ops, name)
    whole = _under(one, fn, x)
    torch.cuda.synchronize()
    _zero_launches()
    got = _under(split, fn, x)
    torch.cuda.synchronize()
    launches = _read_launches()
    shards = sum(rows.stop > rows.start
                 for _, rows in ops.data_sharding(x.shape[0], split))
    want = {k: 0 for k in KERNELS}
    want[name] = shards
    if launches != want:
        raise AssertionError(f"phase 15: {name} under {split} launched "
                             f"{launches}, expected {shards} of {name}")
    mism = int((got != whole).sum())
    if got.dtype != whole.dtype or mism:
        raise AssertionError(f"phase 15: {name} split over {split} differs "
                             f"from the whole call at {mism} elements")
    rec = dict(tiles=int(x.shape[0]), shards=shards,
               launches=launches[name], mismatches=mism,
               ms=_time_ms(lambda: _under(split, fn, x)),
               whole_ms=_time_ms(lambda: _under(one, fn, x)),
               copies=_device_copies(lambda: _under(split, fn, x)),
               whole_copies=_device_copies(lambda: _under(one, fn, x)))
    rec["split_over_whole"] = rec["ms"] / rec["whole_ms"]
    del whole
    return got, rec


def _mesh_circle(slide: bytes, mesh: tuple, uids: str) -> dict:
    """convert → DicomStoreService → ExportService of ``slide`` on the
    card under ``mesh``: the tar's and the TIFFs' SHA-256, the launch
    counts of the conversion and of the export, and their wall times."""
    import hashlib
    import torch
    from repro_torch.core import ObjectStore, SimScheduler
    from repro_torch.wsi import (ConvertOptions, DicomStoreService,
                                 ExportService, convert_wsi_to_dicom)
    _zero_launches()
    t0 = time.perf_counter()
    tar = convert_wsi_to_dicom(slide, {"slide_id": "mesh"}, ConvertOptions(
        manifest={"uids": uids}, device="cuda", mesh=mesh))
    convert_s = time.perf_counter() - t0
    conv = _read_launches()
    sched = SimScheduler()
    store = ObjectStore(sched)
    svc = DicomStoreService(store.bucket("dicom"), sched)
    svc.store_study_archive("studies/mesh.tar", tar)
    (study,) = svc.search_studies()
    exporter = ExportService(svc, store.bucket("derived"), device="cuda",
                             mesh=mesh)
    _zero_launches()
    t0 = time.perf_counter()
    keys = exporter.export_study(study)
    torch.cuda.synchronize()
    export_s = time.perf_counter() - t0
    exp = _read_launches()
    tifs = b"".join(exporter.derived.get(k).data for k in sorted(keys))
    return dict(mesh=list(mesh), tar_sha256=hashlib.sha256(tar).hexdigest(),
                tiff_sha256=hashlib.sha256(tifs).hexdigest(),
                levels=len(keys), convert_launches=conv,
                export_launches=exp, convert_s=convert_s, export_s=export_s)


def run_data_mesh(slide: bytes, seed: int, card: str) -> dict:
    """Phase 15: the data mesh on the card (module doc). (a) Phase 5's
    level-0 tile batch through ``jpeg_transform`` and its coefficients
    through ``jpeg_inverse`` under the split mesh, each equal to the
    one-entry mesh's call and launched once a non-empty shard, and the
    same for the batch less one tile (``uneven``); (b) a MESH_SIZE²
    slide's convert → store → export circle under the split mesh and the
    one-entry mesh: equal tar and TIFF digests, ``min(tiles, shards)``
    launches a level."""
    import torch
    from repro_torch.wsi import SyntheticScanner
    from repro_torch.wsi.convert import _pyramid_dims
    t0 = time.perf_counter()
    split, one = _mesh_split(), ("cuda:0",)
    tiles = _tile_tensor(slide, torch.device("cuda"))
    coef, transform = _mesh_kernel("jpeg_transform", tiles, split, one)
    # the batch less one tile: shards within one tile of each other
    _, transform["uneven"] = _mesh_kernel("jpeg_transform", tiles[:-1],
                                          split, one)
    del tiles
    _, inverse = _mesh_kernel("jpeg_inverse", coef, split, one)
    _, inverse["uneven"] = _mesh_kernel("jpeg_inverse", coef[:-1], split,
                                        one)
    del coef
    _free()
    kernels = {"jpeg_transform": transform, "jpeg_inverse": inverse}
    for name, rec in kernels.items():
        _log(f"phase 15 {name} ({card}): " + json.dumps(rec))

    small = SyntheticScanner(seed=seed + 20).scan(MESH_SIZE, MESH_SIZE, 256)
    uids = _uids(seed + 20)
    circles = {"split": _mesh_circle(small, split, uids),
               "one": _mesh_circle(small, one, uids)}
    counts = [(h // 256) * (w // 256)
              for h, w in _pyramid_dims(MESH_SIZE, MESH_SIZE, 256)]
    for name, c in circles.items():
        shards = len(split) if name == "split" else 1
        want_conv = {k: 0 for k in KERNELS}
        want_conv.update(jpeg_transform=_mesh_launches(counts, shards),
                         downsample2x2=len(counts) - 1)
        want_exp = {k: 0 for k in KERNELS}
        want_exp.update(jpeg_inverse=_mesh_launches(counts, shards),
                        entropy_decode=len(counts))
        if c["convert_launches"] != want_conv or \
                c["export_launches"] != want_exp or c["levels"] != len(counts):
            raise AssertionError(f"phase 15 circle {name}: {c}, expected "
                                 f"{want_conv} and {want_exp}")
        _log(f"phase 15 circle {name} ({card}): " + json.dumps(c))
    for key in ("tar_sha256", "tiff_sha256"):
        if circles["split"][key] != circles["one"][key]:
            raise AssertionError(f"phase 15: the circle's {key} differs "
                                 f"under {split}: {circles}")
    return dict(card=card, mesh=list(split), kernels=kernels,
                circle_size=MESH_SIZE, level_tiles=counts, circles=circles,
                phase_s=time.perf_counter() - t0)


# phase 16: the quickstart example on the card
QUICKSTART_LIMIT_S = 30.0
QUICKSTART_KERNELS = ("jpeg_transform", "downsample2x2", "jpeg_inverse",
                      "entropy_decode")


def run_quickstart(card: str) -> dict:
    """Phase 16: ``examples/torch_quickstart.py --device cuda`` at its
    defaults in a subprocess (it loads the kernels phase 2 built): exit 0,
    ``quickstart OK`` as its last line, its printed kernel launches
    nonzero for QUICKSTART_KERNELS, within QUICKSTART_LIMIT_S seconds."""
    import os
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "torch_quickstart.py"),
         "--device", "cuda"], capture_output=True, text=True,
        timeout=4 * QUICKSTART_LIMIT_S, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    seconds = time.perf_counter() - t0
    lines = r.stdout.splitlines()
    counts = [json.loads(ln.split(": ", 1)[1]) for ln in lines
              if ln.startswith("kernel launches: ")]
    psnr = [ln for ln in lines if "PSNR" in ln]
    rec = dict(card=card, seconds=seconds, returncode=r.returncode,
               launches=counts[0] if counts else None,
               psnr_line=psnr[0] if psnr else None)
    if r.returncode or not lines or lines[-1] != "quickstart OK":
        raise AssertionError(f"phase 16: the quickstart exited "
                             f"{r.returncode}: {r.stdout[-2000:]}"
                             f"{r.stderr[-3000:]}")
    if not counts or not all(counts[0][k] for k in QUICKSTART_KERNELS):
        raise AssertionError(f"phase 16: the quickstart's kernel launches "
                             f"{counts}: expected {QUICKSTART_KERNELS} "
                             "launched")
    if seconds > QUICKSTART_LIMIT_S:
        raise AssertionError(f"phase 16: the quickstart took {seconds:.1f}"
                             f" s, over {QUICKSTART_LIMIT_S} s")
    return rec


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

    # each phase's seconds, logged as it ends and listed before the results
    phase_s, lap = {}, [t_start]

    def done(n: str) -> None:
        phase_s[n] = time.perf_counter() - lap[0]
        lap[0] = time.perf_counter()
        _log(f"phase {n}: {phase_s[n]:.1f} s")

    done("1-2 + scan")

    # 3. kernels vs plain versions (phases 3, 5, 6 and 10 on the one card:
    # their gates count one block-kernel launch a level)
    from repro_torch.kernels import ops
    one_card = ("cuda",)
    with ops.use_mesh(one_card):
        kernels = check_kernels(args.size, slide, args.seed)
    for k in kernels.values():
        _log(f"kernel {k['name']}: {k['mismatches']} mismatches, "
             f"{k['ms']:.5f} ms (plain {k['plain_ms']:.3f}, bound "
             f"{k['bound_ms']:.5f} by {k['bound_by']})")
    for name in ("rgb2ycbcr", "dct8x8_quant"):
        _log(f"per-tile {name}: " + json.dumps(
            {k: v for k, v in kernels[name].items() if "ms" in k}))

    done("3")

    # 4. equivalence at 4096², the per-tile path with its launch counts
    per_tile = check_equivalence(args.seed)
    done("4")

    # 5. the main path
    tar, main_path = run_main_path(args.size, slide, args.seed)
    main_path["stage_s"] = {"scan": scan_s, **main_path["stage_s"]}
    _log("main path: " + json.dumps(main_path))
    done("5")

    # 6. the read side of the main path's study
    with ops.use_mesh(one_card):
        read_side = run_read_side(args.size, slide, tar)
    _log("read side: " + json.dumps(read_side))
    done("6")

    # 7. entropy_decode on level 0's frames
    kernels["entropy_decode"] = check_entropy_decode(tar)
    _log("kernel entropy_decode: " + json.dumps(kernels["entropy_decode"]))
    done("7")

    # 8. wkv_chunk at the serving path's prefill shapes
    kernels["wkv_chunk"] = check_wkv_chunk(args.seed)
    _log("kernel wkv_chunk: " + json.dumps(kernels["wkv_chunk"]))
    done("8")

    # 9. serving rwkv6-3b at full width
    serving = run_serving(args.seed)
    _log("serving: " + json.dumps(serving))
    done("9")

    # 10. the event-driven pipeline on the card
    spine = run_spine(args.seed, card)
    _log("spine: " + json.dumps(spine))
    done("10")

    # 11. the dense family served through the bus
    dense = run_dense_serving(args.seed, card)
    _log("dense serving: " + json.dumps(dense))
    _free()
    done("11")

    # 12. the moe, hybrid, vlm and audio families
    moe = run_moe_serving(args.seed, card)
    _log("moe serving: " + json.dumps(moe))
    for arch, depth in FAMILY_ARCHS.items():
        fam = run_family_serving(arch, depth, args.seed, card)
        _log(f"{fam['family']} serving: " + json.dumps(fam))
    _free()
    done("12")

    # 13. training rwkv6-3b on the card
    training = run_training(args.seed, card)
    _log("training: " + json.dumps(training))
    _free()
    done("13")

    # 14. the planning layer: counts and the roofline against the card
    roofline = run_roofline(args.seed, card)
    _log("roofline: " + json.dumps(roofline))
    done("14")

    # 15. the data mesh: level batches split over the cards
    data_mesh = run_data_mesh(slide, args.seed, card)
    _log("data mesh: " + json.dumps(data_mesh))
    done("15")

    # 16. the quickstart example, as a user runs it
    quickstart = run_quickstart(card)
    _log("quickstart: " + json.dumps(quickstart))
    done("16")

    # each kernel's launches in the run of the path that drives it
    path_of = {"downsample2x2": main_path, "jpeg_transform": main_path,
               "rgb2ycbcr": per_tile, "dct8x8_quant": per_tile,
               "jpeg_inverse": read_side, "entropy_decode": read_side,
               "wkv_chunk": serving}
    for name, k in kernels.items():
        k["launches"] = path_of[name]["launches"][name]
        if not k["launches"]:
            raise AssertionError(f"{name} was not launched on its path")
    # and on the training path (phase 13a): calls a step, and each training
    # shape's time beside its bound
    kernels["wkv_chunk"].update(
        train_launches=training["main"]["launches_per_step"],
        train_timed=training["wkv"]["timed"])
    # and under the data mesh (phase 15a): one launch a shard
    for name, rec in data_mesh["kernels"].items():
        kernels[name]["mesh"] = rec

    _log("phase_s: " + json.dumps(phase_s))
    _log(f"total: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(kernels.values())}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
