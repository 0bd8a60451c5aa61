"""Dry run: every (arch × shape × mesh) cell's step, counted on meta tensors.

For each cell this runs the real step function once (the microbatched
train step for train shapes, ``serve.steps``' prefill or decode step
otherwise) on meta tensors (shapes and dtypes, no memory), laid out as DTensors with the sharding policy's placements over
the production mesh (``launch.mesh``: 256 or 512 H100s on a fake process
group), under ``roofline.counters.Counter``, and records:

* per-device FLOPs and bytes (``flops_per_device``, ``bytes_per_device``;
  the counter's traffic model of eager PyTorch) and the FLOPs among them
  that run at the float32 rate (``f32_flops_per_device``),
* the collectives DTensor issues (``collectives``: ring accounting, by
  kind),
* ``memory``: ``argument_bytes`` (the local shards of the step's inputs)
  and ``temp_bytes`` (the peak of the storage the step allocates and
  holds), ``hbm_per_device`` and ``fits_hbm`` against the card's 80 GB,
* the three-term roofline on the H100 (``derive_terms``) beside the
  analytic model FLOPs (``_analytic_flops``) and ``lower_s``, the host
  seconds the counted run took.

Ops with no DTensor sharding rule whose math is local to a shard (the wkv
per batch row and head) run on the local shards
(``sharding.local_call``); plain tensors a step creates (positions,
masks, zero states) count as replicated (``implicit_replication``). A cell
that fails records ``ok: false`` and its error, never made-up numbers.

One JSON record per cell lands in ``artifacts/dryrun_torch``, with the
counter's op table gzipped beside it (``<cell>.ops.json.gz``, the input of
``launch.reanalyze``); ``--all`` runs every cell in its own subprocess
(one fake process group each), skipping cells whose record exists.

Usage:
    python -m repro_torch.launch.dryrun --one <arch> <shape> <single|multi>
    python -m repro_torch.launch.dryrun --all [--mesh single|multi|both] [--force]

``run_cell(cfg, shape, "local", device=...)`` counts a cell on this
process's own device with real tensors (``device="cuda"``; the CPU only
when asked for, ``device="cpu"``) or on meta tensors of the same program
(``device="meta"``): chip_smoke.py's phase 14 holds the card's counts to
the meta run's and the time to the bound. Under a real process group
(``gloo`` or ``nccl``), a local cell with ``mesh_shape`` runs on that
group's ranks laid out in that shape (``launch.mesh.make_local_mesh``),
its arguments drawn whole from the seed on every rank and laid out by the
policy's placements: the step issues real collectives, which
tests/test_torch_train_mesh.py counts against the fake group's run of
the same cell. Meta tensors, not
``FakeTensorMode``: a fake mode stays active through the step and turns
DTensor's own bookkeeping on the mesh's tensors fake too, where sharding
propagation then fails on data-dependent reads; a meta tensor carries its
device into every tensor the step creates from it.
"""
from __future__ import annotations

import argparse
import contextlib
import gzip
import json
import statistics
import subprocess
import sys
import traceback
from pathlib import Path

from repro_torch.core.clock import wall_time

ARTIFACTS = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# gradient-accumulation microbatches for the biggest trainers (activation fit)
TRAIN_MICROBATCHES = {
    "command-r-plus-104b": 8,
    "command-r-plus-104b+ac512": 4,  # smaller attn chunks free the HBM for mb=4
    "mixtral-8x22b": 4,
    "mixtral-8x7b": 2,
    "zamba2-1.2b": 2,
}

# weight-stationary serving replicates the TP shard of the bf16 weights over
# 'data' when it fits this budget: the reference's 4 GB of a 16 GB chip,
# the same quarter of the H100's 80 GB
WEIGHT_BUDGET = 20e9


def cell_name(arch: str, shape: str, mesh: str) -> str:
    return f"{arch}__{shape}__{mesh}"


def _analytic_flops(cfg, shape, n_params: int, n_active: int) -> dict:
    """Assignment MODEL_FLOPS (6·N·D train / 2·N·D inference) + attention extra."""
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tokens, mult = B * S, 6
    elif shape.kind == "prefill":
        tokens, mult = B * S, 2
    else:
        tokens, mult = B, 2
    model = float(mult) * n_active * tokens
    # analytic attention math (info only; 0 for attention-free paths)
    attn = 0.0
    H, hd, L = cfg.num_heads, cfg.head_dim, cfg.num_layers
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        W = min(S, cfg.sliding_window) if cfg.sliding_window else S
        if shape.kind == "decode":
            attn = 4.0 * B * L * H * hd * W * (mult / 2)
        else:
            eff = (W if cfg.sliding_window else S / 2)
            attn = 4.0 * B * S * L * H * hd * eff * (mult / 2)
    return {"model_flops": model, "attn_flops_analytic": attn}


def _step(cfg, shape, n_params: int, model_axis: int, microbatches: int):
    """The cell's step function and its argument groups: (ParamDef tree,
    policy) per argument, and the weight policy. A train step takes
    ``microbatches``."""
    from repro_torch.models import model as M
    from repro_torch.serve import steps as sv
    from repro_torch.train import (TrainConfig, batch_defs, make_train_step,
                                   train_state_defs)

    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tc = TrainConfig(microbatches=microbatches)
        return (make_train_step(cfg, tc),
                [(train_state_defs(cfg, tc), "train"),
                 (batch_defs(cfg, B, S), "train")], "train")
    if shape.kind == "prefill":
        inp = sv.prefill_input_defs(cfg, B, S)
        groups = [(M.model_defs(cfg), "train"), (inp["tokens"], "train")]
        if "cond" in inp:
            groups.append((inp["cond"], "train"))
        return sv.make_prefill_step(cfg, max_len=S), groups, "train"
    # decode: weight-stationary serving replicates the weights over 'data'
    # when the TP shard fits the budget (no per-token FSDP all-gather)
    policy = ("serve_replicated" if 2.0 * n_params / model_axis
              <= WEIGHT_BUDGET else "train")
    inp = sv.decode_input_defs(cfg, B)
    return (sv.make_decode_step(cfg),
            [(M.model_defs(cfg), policy), (M.cache_defs(cfg, B, S), "train"),
             (inp["token"], "train"), (inp["pos"], "train")], policy)


def _meta_leaf(d, mesh, policy):
    """A ParamDef as a meta tensor: a DTensor of its policy's placements
    over ``mesh`` (its local shard on meta) when the mesh has more than
    one device, else the whole meta tensor."""
    import torch

    if mesh.size() == 1:
        return torch.empty(d.shape, dtype=d.dtype, device="meta")
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch import sharding as shd
    pl = shd.named_sharding(d.shape, d.logical, mesh, policy)
    local, _ = compute_local_shape_and_global_offset(d.shape, mesh, pl)
    stride = torch.empty(d.shape, device="meta").stride()
    return DTensor.from_local(torch.empty(local, dtype=d.dtype,
                                          device="meta"),
                              mesh, pl, run_check=False, shape=d.shape,
                              stride=stride)


def _real_args(cfg, shape, groups, device, params, seed: int):
    """The step's arguments as real tensors on ``device``: ``params`` (or
    parameters drawn from ``seed``), zero states and caches, tokens drawn
    from ``seed``."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.models.params import materialize
    from repro_torch.train import init_opt

    gen = torch.Generator(device=device).manual_seed(seed)
    B, S = shape.global_batch, shape.seq_len
    if params is None:
        params = M.init_params(cfg, gen, device)

    def tokens(n):
        return torch.randint(0, cfg.vocab_size, (B, n), generator=gen,
                             device=device, dtype=torch.int32)

    if shape.kind == "train":
        state = {"params": params, "opt": init_opt(params)}
        batch = {"tokens": tokens(S), "labels": tokens(S)}
        if len(groups[1][0]) > 2:
            batch["cond"] = materialize({"c": groups[1][0]["cond"]}, gen,
                                        device)["c"]
        return [state, batch]
    if shape.kind == "prefill":
        args = [params, tokens(S)]
        if len(groups) > 2:
            args.append(materialize({"c": groups[2][0]}, gen, device)["c"])
        return args
    cache = M.init_cache(cfg, B, S, device)
    pos = torch.full((B,), S // 2, dtype=torch.int32, device=device)
    return [params, cache, tokens(1), pos]


def _tree_bytes(tree) -> int:
    from repro_torch.models.params import tree_defs

    total = 0
    for _, t in tree_defs(tree):
        local = t.to_local() if hasattr(t, "to_local") else t
        total += local.numel() * local.element_size()
    return total


def run_cell(arch, shape, mesh_kind: str, *, device: str = "meta",
             params=None, seed: int = 0, time_reps: int = 0,
             out_dir: Path | None = None, mesh_shape=None,
             microbatches: int | None = None) -> dict:
    """Count one cell (module doc). ``arch`` is an arch id or a
    ``ModelConfig``, ``shape`` a shape name or a ``ShapeConfig``;
    ``mesh_kind`` is ``single`` or ``multi`` (meta tensors only) or
    ``local`` (this process's device); ``mesh_shape`` (a shape and its axis
    names) puts another fake mesh in place of the production one, or, for
    ``local`` under a real process group, lays the group's ranks out so;
    ``microbatches`` sets a train cell's count (default: the arch's
    ``TRAIN_MICROBATCHES``, else 1). With
    ``out_dir`` the record and the op table are written there. For a local cell on the card,
    ``time_reps`` > 0 also times the step (CUDA events, median, after a
    warm-up call; ``step_calls`` counts every call), a decode step also as
    a CUDA graph replay (:func:`_graph_time`), and the record holds
    the step's measured peak memory: what the counted run allocated above
    its arguments (``measured_temp_bytes``, to hold against the meta
    run's ``temp_bytes``) and that plus the arguments
    (``measured_peak_bytes``). The returned record also holds the
    op table (``ops``), which the saved JSON leaves to its gzipped file."""
    import torch

    from repro_torch import sharding as shd
    from repro_torch.configs import ModelConfig, ShapeConfig, get_config, \
        get_shape
    from repro_torch.launch.mesh import (PRODUCTION_SHAPES, make_fake_mesh,
                                         make_local_mesh,
                                         make_production_mesh)
    from repro_torch.models import model as M
    from repro_torch.models.params import tree_map
    from repro_torch.roofline import HW, Counter, derive_terms

    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    shape = shape if isinstance(shape, ShapeConfig) else get_shape(shape)
    rec: dict = {"arch": cfg.name, "shape": shape.name, "mesh": mesh_kind,
                 "kind": shape.kind, "device": device, "ok": False}
    if not cfg.supports_shape(shape):
        rec.update(skipped=True, reason="full-attention arch at 500k decode "
                   "(sub-quadratic path required; see DESIGN.md)")
        _save(rec, None, out_dir)
        return rec
    meta = device == "meta"
    if mesh_kind in PRODUCTION_SHAPES:
        if not meta:
            raise ValueError(f"dryrun: a {mesh_kind!r} cell runs on meta "
                             f"tensors only, not on {device!r}")
        mesh = make_fake_mesh(*mesh_shape) if mesh_shape else \
            make_production_mesh(multi_pod=(mesh_kind == "multi"))
    elif mesh_kind == "local":
        mesh = make_local_mesh("cpu" if meta else device,
                               *(mesh_shape or ()))
    else:
        raise ValueError(f"dryrun: unknown mesh {mesh_kind!r}")
    chips = mesh.size()
    sizes = shd.axis_sizes(mesh)
    n_params = M.param_count(cfg)
    n_active = M.active_param_count(cfg)
    if shape.kind == "train":
        if microbatches is None:
            microbatches = TRAIN_MICROBATCHES.get(cfg.name, 1)
        rec["microbatches"] = microbatches
    fn, groups, policy = _step(cfg, shape, n_params, sizes.get("model", 1),
                               microbatches)
    rec["weight_policy"] = policy

    if meta:
        args = [tree_map(lambda d, p=p: _meta_leaf(d, mesh, p), defs)
                for defs, p in groups]
    else:
        args = _real_args(cfg, shape, groups, torch.device(device), params,
                          seed)
        if chips > 1:  # each rank keeps its shard of the whole draw
            args = [shd.lay_out_tree(a, tree_map(
                lambda d, p=p: shd.named_sharding(d.shape, d.logical, mesh,
                                                  p), defs), mesh)
                for a, (defs, p) in zip(args, groups)]
    arg_b = sum(_tree_bytes(a) if isinstance(a, dict) else _tree_bytes(
        {"x": a}) for a in args)
    cuda = not meta and torch.device(device).type == "cuda"

    counter = Counter()
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(shd.set_mesh(mesh))
            if chips > 1:
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                stack.enter_context(implicit_replication())
            if cuda:
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
            t0 = wall_time()
            with counter:
                out = fn(*args)
            if cuda:
                torch.cuda.synchronize()
            lower_s = wall_time() - t0
            if cuda:
                temp = torch.cuda.max_memory_allocated() - base
                rec.update(measured_temp_bytes=temp,
                           measured_peak_bytes=temp + arg_b)
            del out
    except Exception as exc:  # the cell fails: record the error, no numbers
        rec.update(error=f"{type(exc).__name__}: {exc}",
                   error_class=type(exc).__name__,
                   traceback=traceback.format_exc()[-4000:])
        _save(rec, None, out_dir)
        return rec
    rec["step_calls"] = 1
    if cuda and time_reps:
        rec["step_ms"] = _time_ms(lambda: fn(*args), time_reps)
        rec["step_calls"] += 1 + time_reps
        if shape.kind == "decode":
            rec.update(_graph_time(fn, args, shape.global_batch, time_reps))

    res = counter.result()
    analytic = _analytic_flops(cfg, shape, n_params, n_active)
    terms = derive_terms(
        flops_per_device=res["flops"], bytes_per_device=res["bytes"],
        collective_bytes_per_device=res["collective_bytes"], chips=chips,
        model_flops_total=analytic["model_flops"],
        f32_flops_per_device=res["flops_f32"])
    mem = {"argument_bytes": arg_b, "temp_bytes": res["temp_bytes"]}
    rec.update(
        ok=True, n_params=n_params, n_active=n_active,
        flops_per_device=res["flops"], bytes_per_device=res["bytes"],
        f32_flops_per_device=res["flops_f32"],
        collectives={"total": res["collective_bytes"],
                     "by_kind": res["by_kind"]},
        memory=mem, hbm_per_device=arg_b + res["temp_bytes"],
        fits_hbm=bool(arg_b + res["temp_bytes"] < HW().hbm_bytes),
        **analytic, **terms, lower_s=lower_s)
    _save(rec, res, out_dir)
    rec["ops"] = res["ops"]
    return rec


def _graph_time(fn, args, batch: int, reps: int) -> dict:
    """The decode step as the engine runs it on the card: captured once as
    a CUDA graph over the cell's (warm) cache (``serve.steps.DecodeGraph``)
    and replayed; ``graph_step_ms`` is one replay's time, as
    :func:`_time_ms` takes it, and ``graph_captured_launches`` the kernel
    launches counted inside the capture. The counter cannot see inside a
    replay: the eager run's counts stand for its work."""
    from repro_torch.serve.steps import DecodeGraph

    params, cache, token, pos = args
    graph = DecodeGraph(fn, params, cache, batch)
    graph(token.cpu().numpy(), pos.cpu().numpy())
    return dict(graph_step_ms=_time_ms(graph.graph.replay, reps),
                graph_captured_launches=graph.captured_launches)


def _time_ms(fn, reps: int) -> float:
    """Median device time of ``fn()`` over ``reps`` runs, by CUDA events,
    after one warm-up run."""
    import torch

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


def _save(rec: dict, res: dict | None, out_dir: Path | None) -> None:
    """The record as ``<cell>.json`` and the op table as
    ``<cell>.ops.json.gz`` under ``out_dir`` (nothing when None)."""
    if out_dir is None:
        return
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    name = cell_name(rec["arch"], rec["shape"], rec["mesh"])
    if res is not None:
        table = {k: res[k] for k in ("ops", "by_kind", "flops",
                                     "flops_f32", "bytes",
                                     "collective_bytes")}
        with gzip.open(out_dir / (name + ".ops.json.gz"), "wt") as f:
            json.dump(table, f)
    (out_dir / (name + ".json")).write_text(
        json.dumps(rec, indent=2, default=float))


def all_cells(mesh_filter: str) -> list[tuple[str, str, str]]:
    from repro_torch.configs import SHAPES, get_config, list_archs

    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[mesh_filter]
    cells = [(arch, shape, mesh) for mesh in meshes
             for arch in list_archs() for shape in SHAPES]

    # cheap cells first: decode < prefill < train, then by d_model·layers
    def key(c):
        arch, shape, mesh = c
        cfg = get_config(arch)
        kind_rank = {"decode": 0, "prefill": 1, "train": 2}[SHAPES[shape].kind]
        return (mesh == "multi", kind_rank,
                cfg.d_model * cfg.num_layers * (cfg.num_experts or 1))
    return sorted(cells, key=key)


def _status(rec: dict) -> str:
    return ("SKIP" if rec.get("skipped")
            else "OK" if rec.get("ok") else "FAIL")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.dryrun")
    ap.add_argument("--one", nargs=3, metavar=("ARCH", "SHAPE", "MESH"))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--dir", default=None, help="artifact directory "
                    "(default: artifacts/dryrun_torch)")
    args = ap.parse_args(argv)
    out_dir = Path(args.dir) if args.dir else ARTIFACTS

    if args.one:
        arch, shape, mesh = args.one
        rec = run_cell(arch, shape, mesh, out_dir=out_dir)
        status = _status(rec)
        print(f"[{status}] {arch} {shape} {mesh} "
              f"lower={rec.get('lower_s', '-')}s "
              f"dominant={rec.get('dominant', '-')}"
              + (f" error={rec['error'][:300]}" if "error" in rec else ""))
        return 0 if status != "FAIL" else 1

    if args.all:
        cells = all_cells(args.mesh)
        if args.arch:
            cells = [c for c in cells if c[0] == args.arch]
        if args.shape:
            cells = [c for c in cells if c[1] == args.shape]
        failures = []
        for arch, shape, mesh in cells:
            out = out_dir / (cell_name(arch, shape, mesh) + ".json")
            if out.exists() and not args.force:
                prev = json.loads(out.read_text())
                if prev.get("ok") or prev.get("skipped"):
                    continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--one", arch, shape, mesh, "--dir", str(out_dir)]
            t0 = wall_time()
            try:
                r = subprocess.run(cmd, timeout=args.timeout,
                                   capture_output=True, text=True)
                if r.returncode != 0 and not out.exists():
                    out_dir.mkdir(parents=True, exist_ok=True)
                    out.write_text(json.dumps({
                        "arch": arch, "shape": shape, "mesh": mesh,
                        "ok": False, "error": (r.stderr or "")[-4000:],
                        "error_class": "exit " + str(r.returncode),
                    }, indent=2))
                if r.returncode != 0:
                    failures.append((arch, shape, mesh))
                    print(f"[FAIL {wall_time() - t0:6.0f}s] {arch} {shape} "
                          f"{mesh}")
                    print((r.stdout or "")[-600:] + (r.stderr or "")[-900:])
                else:
                    print(r.stdout.strip())
            except subprocess.TimeoutExpired:
                failures.append((arch, shape, mesh))
                out_dir.mkdir(parents=True, exist_ok=True)
                out.write_text(json.dumps({
                    "arch": arch, "shape": shape, "mesh": mesh,
                    "ok": False, "error": f"timeout {args.timeout}s",
                    "error_class": "timeout",
                }, indent=2))
                print(f"[TIMEOUT] {arch} {shape} {mesh}")
            sys.stdout.flush()
        print(f"done; {len(failures)} failures: {failures}")
        return 1 if failures else 0

    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
