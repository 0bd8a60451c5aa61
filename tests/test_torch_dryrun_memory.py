"""The dry run's per-device memory against ``repro``'s, and against the
mesh it is counted on.

- **Production cells** (full width, on meta tensors): ``musicgen-large``
  and ``phi4-mini-3.8b`` prefill_32k single, ``gemma-2b`` train_4k and
  decode_32k on both meshes, ``phi4-mini-3.8b`` decode_32k single, the
  ``zamba2-1.2b``, ``mixtral-8x22b``, ``mixtral-8x7b`` and ``rwkv6-3b``
  long_500k single, and the reduced ``gemma-2b-smoke`` train_4k
  and ``musicgen-large-smoke`` prefill_32k single, which ``repro`` lowers
  on the production meshes too. Each side runs its cells in one
  subprocess: ``repro.launch.dryrun.run_cell(arch, shape, mesh,
  save_hlo=False)`` (XLA's ``memory_analysis``; writes nothing) and the
  port's ``run_cell`` (the largest mesh first: a process's fake group is
  sized by its first mesh). The port's ``hbm_per_device`` is at most
  ``MEM_RATIO[case]`` times ``repro``'s ``argument_bytes + temp_bytes +
  output_bytes``; each multi cell holds no more than its single twin.
  Each bound is set from its cell's reading (dry run, CPU), the ratio
  beside it in ``MEM_RATIO``: 2 for the full-width prefills and trains
  (0.87–1.38), 1 for the gemma decodes (0.43 and 0.50; 0.61 and 0.62
  before the context-parallel decode attention), phi4's decode and the
  long-context cells (0.32–0.63) but 2 for rwkv6's (1.58) and 10 for
  mixtral-8x7b's (9.40: the port replicates its weights over 'data',
  ROADMAP's stated departures), 6 for the reduced
  train (4.86: its 32-key attention chunks hold 128 chunks' scores a
  layer for the backward, which XLA fuses) and 2 for the reduced prefill
  (1.24). Before the repair the full-width prefill and train cells read
  32–141× (a stride taken from a meta tensor of the whole cache; the
  loss head's logits whole over the vocab and, on the multi mesh, over
  'data') and the decodes 1.36× (single) and 1.80× (multi), each above
  its bound, and the two reduced cells did not lower.
- **Decode cost**: the same runs' collectives (link bytes), FLOPs and
  bytes per device. ``gemma-2b`` decode_32k on both meshes and
  ``phi4-mini-3.8b`` decode_32k single (a guard: its heads take
  'model', so its cache's sequence stays whole) each lie within
  ``COST_RATIO`` of ``repro``'s, and their roofline's dominant term is
  ``memory_s`` on both sides. Before the context-parallel decode
  attention (``layers.decode_self_attention``) every gemma rank gathered
  the whole float32 cache each layer and attended over all of it: 444x
  and 447x ``repro``'s collectives, dominant ``collective_s``. Four
  batch-1 ``long_500k`` cells hold their collectives within
  ``LONG_COLL_RATIO`` of ``repro``'s: before their repairs a rank
  gathered a zamba2 layer's Mamba2 state whole, mixtral-8x22b's vocab
  slice of the table whole, and the experts' and rwkv6's channel-mix
  activations through a gather and a reduce-scatter.
- **Fake meshes** at one global batch: a 2048-token ``musicgen-large``
  prefill (B = 32) and an S = 512 ``gemma-2b`` train (B = 256) on
  (16, 8) and (32, 8) ``("data", "model")`` meshes: ``temp_bytes``
  falls as the data axis doubles (before the repair the prefill read
  26.28 → 26.07 GB).
- **Real ranks**: a reduced prefill and train cell on 8 ``gloo`` ranks
  laid out (2, 2, 2) (``tests/_torch_train_mesh.py``'s ``dryrun`` job):
  every rank's counted peak, the least of ``REPS`` runs, equals the fake
  (2, 2, 2) mesh's ``temp_bytes``, so the count is what real ranks
  hold. The same two cells counted on the (2, 2, 2) sub-mesh of the
  production cells' 512-rank fake group, and in a process of their own
  on a fake group of 8, issue the same collectives by kind and count the
  same op table, FLOPs, bytes and ``temp_bytes``. (gloo's worker thread
  lets go of a collective's buffers a
  moment after the wait returns: a single run read a buffer or two
  (8192 or 24576 B) above the count in 5 of 112 rank-runs.) On the same
  ranks a reduced ``gemma-2b``'s gradients, through the vocab-parallel
  loss head and lookup, lie within ``GRAD_REL`` of one process's, leaf
  by leaf over the largest magnitude (measured 6.5e-3: bf16 rounding);
  with the loss's reductions over the vocab planted out (the
  ``vocab_unreduced`` fault) they lie 0.66 off.

All four started together: the file took 164 s alone on an 8-core CPU
and 386 s among the tier-1 run's six workers there (936 s in all); 202 s
alone with the decode-cost and long-context cells.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
# case -> the bound on the port's hbm_per_device over repro's memory
# (the reading it was set from, dry run, CPU)
MEM_RATIO = {
    "musicgen-prefill": 2.0,  # 1.38
    "phi4-prefill": 2.0,  # 0.90
    "gemma-train": 2.0,  # 0.87
    "gemma-train-multi": 2.0,  # 0.92
    # 0.50 and 0.43; 0.62 and 0.61 before the context-parallel decode
    # attention, 1.80 and 1.36 before the memory repair
    "gemma-decode-multi": 1.0,
    "gemma-decode": 1.0,
    "gemma-smoke-train": 6.0,  # 4.86
    "musicgen-smoke-prefill": 2.0,  # 1.24
    "phi4-decode": 1.0,  # 0.32
    "zamba2-long": 1.0,  # 0.63
    "mixtral22-long": 1.0,  # 0.34
    "mixtral7-long": 10.0,  # 9.40: weights replicated over 'data' (ROADMAP)
    "rwkv6-long": 2.0,  # 1.58
}
# metric -> the bound on the decode cells' per-device figure over repro's
# (the readings it was set from, dry run, CPU: gemma-2b single and multi,
# phi4-mini-3.8b); the gemma decodes read 444x and 447x (collectives),
# 4.46x (FLOPs) and 3.85x and 3.13x (bytes) before the context-parallel
# decode attention
COST_RATIO = {
    "collectives": 2.0,  # 0.28, 0.28, 0.22
    "flops": 1.25,  # 1.00, 1.00, 1.00
    "bytes": 1.5,  # 0.55, 0.53, 0.56
}
# the decode cells held to COST_RATIO and to repro's dominant term: gemma's
# cache is context-parallel (one KV head: 'kvseq' takes 'model'); phi4's
# heads take 'model', a guard that the repair leaves as it was
COST_CASES = ("gemma-decode", "gemma-decode-multi", "phi4-decode")
# the batch-1 long_500k cells: the bound on their collectives over repro's
# (the reading; the reading before the repair, and what was gathered)
LONG_COLL_RATIO = {
    "zamba2-long": 2.5,  # 2.04; 21.7 (the Mamba2 state, whole, twice a layer)
    "mixtral22-long": 1.0,  # 0.74; 8.6 (the table's vocab slice, whole)
    "mixtral7-long": 1.0,  # 0.77; 4.3 (the experts' activations)
    "rwkv6-long": 4.0,  # 3.00; 5.7 (the channel mix's activations)
}
# case -> (arch, shape, mesh); the port runs the multi cells first
CELLS = {
    "musicgen-prefill": ("musicgen-large", "prefill_32k", "single"),
    "phi4-prefill": ("phi4-mini-3.8b", "prefill_32k", "single"),
    "gemma-train": ("gemma-2b", "train_4k", "single"),
    "gemma-train-multi": ("gemma-2b", "train_4k", "multi"),
    "gemma-decode-multi": ("gemma-2b", "decode_32k", "multi"),
    "gemma-decode": ("gemma-2b", "decode_32k", "single"),
    "gemma-smoke-train": ("gemma-2b-smoke", "train_4k", "single"),
    "musicgen-smoke-prefill": ("musicgen-large-smoke", "prefill_32k",
                               "single"),
    "phi4-decode": ("phi4-mini-3.8b", "decode_32k", "single"),
    "zamba2-long": ("zamba2-1.2b", "long_500k", "single"),
    "mixtral22-long": ("mixtral-8x22b", "long_500k", "single"),
    "mixtral7-long": ("mixtral-8x7b", "long_500k", "single"),
    "rwkv6-long": ("rwkv6-3b", "long_500k", "single"),
}
TWINS = (("gemma-train", "gemma-train-multi"),
         ("gemma-decode", "gemma-decode-multi"))
# case -> (arch, ShapeConfig args); each on both fake meshes
FAKE = {
    "musicgen-prefill-2048": ("musicgen-large", ("p", 2048, 32, "prefill")),
    "gemma-train-512": ("gemma-2b", ("t", 512, 256, "train")),
}
FAKE_MESHES = {16: ((16, 8), ("data", "model")),
               32: ((32, 8), ("data", "model"))}
MESH = ((2, 2, 2), ("pod", "data", "model"))
REAL = {
    "dense-prefill": ("gemma-2b-smoke", ("p", 64, 8, "prefill")),
    "dense-train": ("phi4-mini-3.8b-smoke", ("t", 64, 8, "train")),
}
# runs of each real-rank cell; a rank's least counted peak is compared
REPS = 4
# the gradients of the vocab-parallel loss head and lookup on the ranks
GRAD_ARCH = "gemma-2b-smoke"
GRAD_REL = 0.05

_REPRO = """
    import json, sys
    sys.path.insert(0, %r)
    from repro.launch import dryrun
    out = {}
    for case, cell in json.loads(%r).items():
        rec = dryrun.run_cell(*cell, save_hlo=False)
        out[case] = dict(
            memory={k: rec["memory"][k] for k in (
                "argument_bytes", "temp_bytes", "output_bytes")},
            collectives=rec["collectives"]["total"],
            flops=rec["flops_per_device"], bytes=rec["bytes_per_device"],
            dominant=rec["dominant"])
    print("CELLS" + json.dumps(out))
"""

_PORT = """
    import json, sys
    sys.path.insert(0, %r)
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import dryrun
    cells, fake, fake_meshes, real, mesh = json.loads(%r)

    def mem(rec):
        if not rec["ok"]:
            return dict(ok=False, error=rec.get("traceback"))
        return dict(ok=True, hbm=rec["hbm_per_device"],
                    strided=rec["strided_ops"], chips=rec["chips"],
                    temp=rec["memory"]["temp_bytes"],
                    by_kind=rec["collectives"]["by_kind"],
                    flops=rec["flops_per_device"],
                    bytes=rec["bytes_per_device"], ops=rec["ops"],
                    collectives=rec["collectives"]["total"],
                    dominant=rec["dominant"])

    out = {"cells": {}, "fake": {}, "real": {}}
    for case, cell in sorted(cells.items(), key=lambda c: c[1][2] != "multi"):
        out["cells"][case] = mem(dryrun.run_cell(*cell))
    for case, (arch, shape) in real.items():
        out["real"][case] = mem(dryrun.run_cell(
            get_config(arch), ShapeConfig(*shape), "single", mesh_shape=mesh))
    for case, (arch, shape) in fake.items():
        out["fake"][case] = {n: mem(dryrun.run_cell(
            get_config(arch), ShapeConfig(*shape), "single", mesh_shape=m))
            for n, m in fake_meshes.items()}
    print("CELLS" + json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _result(proc, timeout: int) -> dict:
    out, err = proc.communicate(timeout=timeout)
    line = [ln for ln in out.splitlines() if ln.startswith("CELLS")]
    assert line, err[-3000:]
    return json.loads(line[0][5:])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``repro``'s cells, the port's cells and the 8 ranks' jobs, started
    together."""
    tmp = tmp_path_factory.mktemp("dryrun_memory")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    repro = subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_REPRO) % (
            str(SRC), json.dumps(CELLS))],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    port, own = (subprocess.Popen(
        [sys.executable, "-c", textwrap.dedent(_PORT) % (
            str(SRC), json.dumps(cells))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for cells in ([CELLS, FAKE, FAKE_MESHES, REAL, MESH],
                      [{}, {}, {}, REAL, MESH]))
    jobs = tmp / "jobs.json"
    jobs.write_text(json.dumps([
        {"kind": "dryrun", "arch": arch, "shape": shape, "mesh_shape": MESH,
         "reps": REPS} for arch, shape in REAL.values()] + [
        {"kind": "grads", "arch": GRAD_ARCH, "batch": [8, 32],
         "mesh_shape": MESH, "fault": fault}
        for fault in (None, "vocab_unreduced")]))
    ranks = subprocess.Popen(
        [sys.executable, str(TESTS / "_torch_train_mesh.py"), "8",
         str(_free_port()), str(jobs), str(tmp / "out.json")],
        env={**os.environ, "PYTHONPATH": str(SRC)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        want = _result(repro, 300)
        got = _result(port, 400)
        alone = _result(own, 100)["real"]
        _, rank_err = ranks.communicate(timeout=300)
    finally:
        for proc in (repro, port, own, ranks):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    assert ranks.returncode == 0, rank_err[-3000:]
    real = json.loads((tmp / "out.json").read_text())
    return {"repro": want, **got, "alone": alone,
            "ranks": dict(zip(REAL, real)), "grads": real[len(REAL):]}


@pytest.mark.parametrize("case", list(CELLS))
def test_cell_within_mem_ratio_of_repro(runs, case):
    got, want = runs["cells"][case], runs["repro"][case]
    assert got["ok"], got["error"]
    assert got["chips"] == (512 if CELLS[case][2] == "multi" else 256)
    assert got["strided"] == 0, case
    mem = sum(want["memory"].values())
    assert got["hbm"] <= MEM_RATIO[case] * mem, (case, got["hbm"] / mem)


@pytest.mark.parametrize("metric", list(COST_RATIO))
@pytest.mark.parametrize("case", COST_CASES)
def test_decode_cost_within_ratio_of_repro(runs, case, metric):
    """Per device: the collectives' link bytes, the FLOPs and the bytes
    of the decode step, each within ``COST_RATIO`` of repro's."""
    got, want = runs["cells"][case], runs["repro"][case]
    assert got["ok"], got["error"]
    assert got[metric] <= COST_RATIO[metric] * want[metric], (
        case, metric, got[metric] / want[metric])


@pytest.mark.parametrize("case", list(LONG_COLL_RATIO))
def test_long_context_collectives_within_ratio_of_repro(runs, case):
    got, want = runs["cells"][case], runs["repro"][case]
    assert got["ok"], got["error"]
    ratio = got["collectives"] / want["collectives"]
    assert ratio <= LONG_COLL_RATIO[case], (case, ratio)


@pytest.mark.parametrize("case", COST_CASES + tuple(LONG_COLL_RATIO))
def test_decode_bound_by_memory_as_in_repro(runs, case):
    got, want = runs["cells"][case], runs["repro"][case]
    assert got["ok"], got["error"]
    assert got["dominant"] == want["dominant"] == "memory_s", (
        got["dominant"], want["dominant"])


@pytest.mark.parametrize("single,multi", TWINS)
def test_multi_cell_holds_no_more_than_its_single_twin(runs, single, multi):
    cells = runs["cells"]
    assert cells[multi]["hbm"] <= cells[single]["hbm"], (
        cells[multi], cells[single])


@pytest.mark.parametrize("case", list(FAKE))
def test_temp_bytes_fall_as_the_data_axis_doubles(runs, case):
    fake = runs["fake"][case]
    assert fake["32"]["ok"] and fake["16"]["ok"], fake
    assert fake["32"]["chips"] == 256 and fake["16"]["chips"] == 128
    assert fake["32"]["temp"] < fake["16"]["temp"], fake


@pytest.mark.parametrize("case", list(REAL))
def test_a_sub_mesh_counts_what_a_group_of_its_own_counts(runs, case):
    sub, own = runs["real"][case], runs["alone"][case]
    assert sub["ok"] and own["ok"], (sub.get("error"), own.get("error"))
    assert sub["by_kind"] and sub["by_kind"] == own["by_kind"]
    for key in ("chips", "flops", "bytes", "temp", "ops"):
        assert sub[key] == own[key], (key, sub[key], own[key])


@pytest.mark.parametrize("case", list(REAL))
def test_every_rank_holds_the_fake_mesh_count(runs, case):
    real, meta = runs["ranks"][case], runs["real"][case]
    assert real["ok"] and meta["ok"], (real["error"], meta.get("error"))
    assert meta["chips"] == 8
    assert real["temp_bytes_by_rank"] == [meta["temp"]] * 8, (
        real["temp_bytes_by_rank"], meta["temp"])


def test_eight_rank_gradients_of_the_vocab_parallel_head(runs):
    """A reduced gemma-2b (tied, scaled embeddings; one KV head, whose
    projections run on the local shards) on the 8 ranks against one
    process, leaf by leaf over the largest magnitude; with the loss's
    reductions over the vocab left out, the bound breaks."""
    sound, fault = runs["grads"]
    assert "embed/table" in sound and len(sound) > 10, sorted(sound)
    assert max(sound.values()) <= GRAD_REL, sorted(
        sound.items(), key=lambda kv: -kv[1])[:4]
    assert max(fault.values()) > GRAD_REL, fault
