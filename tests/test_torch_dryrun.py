"""The port's dry run (``launch.dryrun``), its re-analysis and the serving
steps: a reduced rwkv6 and a reduced dense cell on a fake (2, 2) mesh, a
local cell's counts against ``analyze_step`` of the plain step, the
analytic FLOPs against ``repro``'s, ``reanalyze``'s round trip, and
``serve.steps`` against ``M.prefill`` / ``M.decode_step``."""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import SHAPES as R_SHAPES
from repro.configs import get_config as r_get_config
from repro.models import model as RM
from repro_torch.configs import SHAPES, ShapeConfig, get_config, list_archs
from repro_torch.launch import dryrun, reanalyze
from repro_torch.models import model as M
from repro_torch.roofline import HW, analyze_step
from repro_torch.serve import steps as sv

SRC = str(Path(__file__).resolve().parents[1] / "src")


def _reference_analytic():
    """``repro.launch.dryrun._analytic_flops`` (the module sets XLA_FLAGS
    when imported: restored at once, before any backend reads it)."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import _analytic_flops
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return _analytic_flops


def test_analytic_flops_equal_the_reference():
    ref_fn = _reference_analytic()
    for arch in list_archs():
        cfg, rcfg = get_config(arch), r_get_config(arch)
        for name in SHAPES:
            n, na = M.param_count(cfg), M.active_param_count(cfg)
            assert (n, na) == (RM.param_count(rcfg),
                               RM.active_param_count(rcfg))
            assert dryrun._analytic_flops(cfg, SHAPES[name], n, na) == \
                ref_fn(rcfg, R_SHAPES[name], n, na), (arch, name)


def test_cells_on_a_fake_mesh_in_subprocess(tmp_path):
    """A reduced rwkv6 prefill (the wkv on the local shards) and a reduced
    dense decode (the cache's indexed writes) as DTensors on a fake (2, 2)
    mesh: both ok, with collectives counted, and their records and op
    tables written."""
    prog = textwrap.dedent("""
        import json, sys
        sys.path.insert(0, %r)
        from repro_torch.configs import ShapeConfig, get_config
        from repro_torch.launch import dryrun
        mesh = ((2, 2), ("data", "model"))
        out = {}
        for arch, shape in (
                ("rwkv6-3b-smoke", ShapeConfig("p", 128, 4, "prefill")),
                ("phi4-mini-3.8b-smoke", ShapeConfig("d", 64, 4, "decode"))):
            rec = dryrun.run_cell(get_config(arch), shape, "single",
                                  mesh_shape=mesh, out_dir=%r)
            rec.pop("ops", None)
            out[arch] = rec
        print("CELLS" + json.dumps(out, default=float))
    """) % (SRC, str(tmp_path))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=600)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("CELLS")]
    assert line, r.stderr[-3000:]
    cells = json.loads(line[0][5:])
    for arch, rec in cells.items():
        assert rec["ok"], (arch, rec.get("error"), rec.get("traceback"))
        assert rec["chips"] == 4 and rec["collectives"]["total"] > 0, arch
        assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
        assert rec["memory"]["argument_bytes"] > 0
        name = dryrun.cell_name(rec["arch"], rec["shape"], "single")
        assert (tmp_path / (name + ".json")).exists()
        assert (tmp_path / (name + ".ops.json.gz")).exists()
    assert cells["rwkv6-3b-smoke"]["weight_policy"] == "train"


# the cells that raised AssertionError on DTensors (PERF.md §6): the
# MoE's capacity dispatch (an in-place scatter, now on the local shards)
# and the gradient accumulation of a microbatched train step (a gradient
# in other placements than its float32 buffer); the mixtral train cell
# also takes its experts' backward through ``sharding.dense``
MOE_CELLS = {
    "mixtral-decode": ("mixtral-8x7b-smoke", ("d", 64, 4, "decode"), None),
    "mixtral-prefill": ("mixtral-8x7b-smoke", ("p", 128, 4, "prefill"), None),
    "zamba2-train": ("zamba2-1.2b-smoke", ("t", 64, 4, "train"), 2),
    "mixtral-train": ("mixtral-8x7b-smoke", ("t", 64, 4, "train"), 2),
}


@pytest.fixture(scope="module")
def moe_cells(tmp_path_factory):
    """Every case of MOE_CELLS on a fake (2, 2) mesh, in one subprocess
    (the fake process group is per process): each record and its
    seconds."""
    out = tmp_path_factory.mktemp("moe_cells")
    prog = textwrap.dedent("""
        import json, sys, time
        sys.path.insert(0, %r)
        from repro_torch.configs import ShapeConfig, get_config
        from repro_torch.launch import dryrun
        out = {}
        for case, (arch, shape, mb) in json.loads(%r).items():
            t0 = time.perf_counter()
            rec = dryrun.run_cell(get_config(arch), ShapeConfig(*shape),
                                  "single", mesh_shape=((2, 2),
                                  ("data", "model")), out_dir=%r,
                                  microbatches=mb)
            rec.pop("ops", None)
            rec["seconds"] = time.perf_counter() - t0
            out[case] = rec
        print("CELLS" + json.dumps(out, default=float))
    """) % (SRC, json.dumps(MOE_CELLS), str(out))
    r = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                       text=True, timeout=900)
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("CELLS")]
    assert line, r.stderr[-3000:]
    return json.loads(line[0][5:])


@pytest.mark.parametrize("case", sorted(MOE_CELLS))
def test_moe_and_accumulation_cells_on_a_fake_mesh(moe_cells, case):
    """Each cell is ok on the fake (2, 2) mesh with its collectives
    counted (the train cells with 2 microbatches, so the accumulation's
    add runs)."""
    rec = moe_cells[case]
    assert rec["ok"], (case, rec.get("error"), rec.get("traceback"))
    assert rec["chips"] == 4 and rec["collectives"]["total"] > 0, case
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["kind"] == MOE_CELLS[case][1][3]
    assert rec.get("microbatches") == MOE_CELLS[case][2]


def test_train_cell_records_the_arch_microbatches():
    """A train cell takes the TRAIN_MICROBATCHES of its config's name
    (here a reduced rwkv6 under zamba2's name) unless ``microbatches`` is
    given."""
    shape = ShapeConfig("t", 64, 4, "train")
    cfg = dataclasses.replace(get_config("rwkv6-3b-smoke"),
                              name="zamba2-1.2b")
    rec = dryrun.run_cell(cfg, shape, "local", device="meta")
    assert rec["ok"] and rec["microbatches"] == \
        dryrun.TRAIN_MICROBATCHES["zamba2-1.2b"]
    rec = dryrun.run_cell(cfg, shape, "local", device="meta", microbatches=4)
    assert rec["ok"] and rec["microbatches"] == 4


def _tokens(cfg, B, S, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=g,
                         dtype=torch.int32)


@pytest.mark.parametrize("arch", ["rwkv6-3b-smoke", "phi4-mini-3.8b-smoke"])
def test_local_cell_counts_equal_analyze_step(arch):
    """The cell on a 1-device mesh counts what ``analyze_step`` counts for
    the plain step on the same inputs, and its meta run counts the same
    again."""
    cfg = get_config(arch)
    shape = ShapeConfig("p", 64, 2, "prefill")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    rec = dryrun.run_cell(cfg, shape, "local", device="cpu", params=params)
    meta = dryrun.run_cell(cfg, shape, "local", device="meta")
    step = sv.make_prefill_step(cfg, max_len=64)
    want = analyze_step(step, params, _tokens(cfg, 2, 64))
    assert rec["ok"] and meta["ok"]
    for key, got in (("flops", rec["flops_per_device"]),
                     ("bytes", rec["bytes_per_device"])):
        assert got == want[key], key
    assert rec["ops"] == want["ops"] == meta["ops"]
    assert rec["chips"] == 1 and rec["collectives"]["total"] == 0
    assert meta["hbm_per_device"] == rec["hbm_per_device"]


def test_production_cell_refuses_a_real_device():
    with pytest.raises(ValueError, match="meta"):
        dryrun.run_cell("rwkv6-3b", "decode_32k", "single", device="cpu")


def test_local_mesh_refuses_a_missing_card():
    from repro_torch.launch.mesh import make_local_mesh
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_local_mesh()
    assert make_local_mesh("cpu").size() == 1


def test_unsupported_cell_is_skipped():
    rec = dryrun.run_cell("phi4-mini-3.8b", "long_500k", "single")
    assert rec["skipped"] and not rec["ok"]


def test_reanalyze_round_trip_and_new_hw(tmp_path):
    cfg = get_config("rwkv6-3b-smoke")
    shape = ShapeConfig("d", 64, 4, "decode")
    rec = dryrun.run_cell(cfg, shape, "local", device="meta",
                          out_dir=tmp_path)
    path = tmp_path / (dryrun.cell_name(cfg.name, "d", "local") + ".json")
    saved = json.loads(path.read_text())
    keys = ("flops_per_device", "f32_flops_per_device", "bytes_per_device",
            "compute_s", "memory_s", "collective_s", "dominant", "bound_s",
            "mfu_bound")
    assert reanalyze.reanalyze(tmp_path) == {"updated": 1, "missing": []}
    again = json.loads(path.read_text())
    assert {k: again[k] for k in keys} == {k: saved[k] for k in keys} \
        == {k: rec[k] for k in keys}
    slow = dataclasses.replace(HW(), hbm_bw=HW().hbm_bw / 2)
    reanalyze.reanalyze(tmp_path, slow)
    moved = json.loads(path.read_text())
    assert moved["memory_s"] == 2 * saved["memory_s"]
    assert moved["hw"]["hbm_bw"] == slow.hbm_bw
    assert reanalyze.main(["--dir", str(tmp_path)]) == 0


def test_reanalyze_lists_cells_without_an_op_table(tmp_path):
    (tmp_path / "a__b__single.json").write_text(json.dumps({"ok": True}))
    assert reanalyze.reanalyze(tmp_path) == {"updated": 0,
                                             "missing": ["a__b__single"]}


@pytest.mark.parametrize("arch", ["rwkv6-3b-smoke", "phi4-mini-3.8b-smoke",
                                  "llama-3.2-vision-11b-smoke"])
def test_serve_steps_equal_the_model(arch):
    cfg = dataclasses.replace(get_config(arch), dtype=torch.float32)
    params = M.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    B, S = 2, 32
    inp = sv.prefill_input_defs(cfg, B, S)
    assert inp["tokens"].shape == (B, S)
    tokens = _tokens(cfg, B, S, seed=2)
    extra, kw = (), {}
    if "cond" in inp:
        g = torch.Generator().manual_seed(3)
        cond = torch.randn(inp["cond"].shape, generator=g)
        extra, kw = (cond,), {"cond": cond}
    logits, cache = sv.make_prefill_step(cfg, max_len=48)(params, tokens,
                                                          *extra)
    want, want_cache = M.prefill(params, cfg, tokens, max_len=48, **kw)
    assert torch.equal(logits, want)
    dec = sv.decode_input_defs(cfg, B)
    assert dec["token"].shape == (B, 1) and dec["pos"].shape == (B,)
    token = logits.argmax(-1, keepdim=True).to(torch.int32)
    pos = torch.full((B,), S, dtype=torch.int32)
    got, _ = sv.make_decode_step(cfg)(params, cache, token, pos)
    exp, _ = M.decode_step(params, cfg, want_cache, token, pos)
    assert torch.equal(got, exp)


def test_abstract_trees_allocate_nothing():
    from repro_torch.train import TrainConfig, abstract_train_state
    cfg = get_config("rwkv6-3b")
    params = M.abstract_params(cfg)
    cache = M.abstract_cache(cfg, 128, 32768)
    state = abstract_train_state(cfg, TrainConfig())
    for tree in (params, cache, state):
        leaves = [t for t in jax_free_leaves(tree)]
        assert leaves and all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in jax_free_leaves(params)) == \
        M.param_count(cfg)


def jax_free_leaves(tree):
    from repro_torch.models.params import tree_defs
    return [t for _, t in tree_defs(tree)]


def test_shardings_mirror_the_state():
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.train import (TrainConfig, batch_shardings,
                                   state_shardings, train_state_defs)

    class _Mesh:
        mesh_dim_names = ("data", "model")
        shape = (32, 8)

    cfg = get_config("rwkv6-3b")
    sh = state_shardings(cfg, TrainConfig(), _Mesh)
    assert set(sh) == set(train_state_defs(cfg, TrainConfig()))
    assert sh["params"]["layers"]["wr"] == (Shard(1), Shard(2))
    assert sh["opt"]["count"] == (Replicate(), Replicate())
    bs = batch_shardings(cfg, 256, 4096, _Mesh)
    assert bs["tokens"] == (Shard(0), Shard(1))


def test_multi_device_training_stays_refused(tmp_path):
    """Training on the production mesh needs a process group of its 512
    ranks, and the re-shard on restore a mesh to lay the leaves out on:
    without them both are refused (tests/test_torch_train_mesh.py trains
    and re-shards on real ranks)."""
    from repro_torch.launch import train as launch
    from repro_torch.launch.mesh import PRODUCTION_SHAPES, make_local_mesh
    from repro_torch.train.checkpoint import restore_checkpoint
    with pytest.raises(ValueError, match="needs a mesh"):
        restore_checkpoint(tmp_path, {}, shardings={})
    with pytest.raises(ValueError, match="needs a process group"):
        make_local_mesh("cpu", *PRODUCTION_SHAPES["multi"])
    with pytest.raises(SystemExit):
        launch.parse_args(["--arch", "rwkv6-3b", "--multi-pod"])
