"""The dry run on the three-axis ``("pod", "data", "model")`` mesh of the
multi-pod cells, cut to a fake (2, 2, 2) mesh and reduced configs, and
held to a real 8-rank ``gloo`` group laid out the same way.

- Every kind of cell that timed out on the production (2, 32, 8) mesh
  (PERF.md §6): a dense prefill (``gemma-2b``'s, which ran past 600 s
  while its projections and attention made ``_StridedShard`` layouts), a
  dense train step of 2 microbatches, the audio and vlm decodes and the
  rwkv6 prefill. Each reads ok with 8 chips, collectives counted, its
  record and op table written, and no op that took a ``_StridedShard``
  (``strided_ops``: the mechanism that kept the mesh from lowering,
  ``sharding``'s module doc).
  All in one subprocess of at most 240 s (the fake process group is per
  process); in one run on a CPU the cells took 12.6, 18.5, 6.2, 0.6
  and 3.5 s, in this order (DTensor caches the propagation of an op it
  has seen), the whole file 62 s alone and 136 s among the other tests'
  workers (74 s alone once the MQA decodes below were added).
- The context-parallel decode (``layers.decode_self_attention``): a
  reduced ``gemma-2b`` has one KV head, so its cache's sequence takes
  'model' and each rank attends over its own shard, the softmax combined
  over the ranks. Its decode, with ``+kv8`` and with a 16-slot sliding
  window too, gathers less in all than one layer's K cache shard of one
  rank (768 B against 1024–4096; the whole float32 cache gathered over
  'model', 25216 and 12832 B, before the repair).
- The reduced prefill and the audio and MQA decodes run for real on 8
  ``gloo`` ranks laid out (2, 2, 2) (``tests/_torch_train_mesh.py``'s
  ``dryrun`` job): they issue exactly the collectives, by kind and count
  (``CommDebugMode``), and the per-device FLOPs and bytes that the fake
  mesh counts.
- The same 8 ranks' prefill logits (the last position's, (8, 256)) lie
  within ``LOGIT_BOUND`` of the one process's run on the same draw
  (measured 3.1e-7, the largest logit 0.64): the mesh moves only
  reduction orders. A planted fault, every ``local_call`` output declared
  with its 'data' and 'model' placements swapped
  (``_torch_train_mesh.misplaced``), moves them by 0.63, beyond the
  bound. The three MQA decodes, each a step against a cache with a
  history (``_torch_train_mesh._history``: random K/V, some slots free or
  past the window, one row whose every shard but the first is free), lie
  within the same bound (measured 5.4e-7, 3.0e-7 with ``+kv8`` and 3.1e-7
  with the window; the largest logits 0.66, 0.50, 0.56); with each
  rank's softmax left uncombined over the sequence
  (``_torch_train_mesh.decode_uncombined``) the decode reads 0.57 off.
- A reduced rwkv6's gradients on the same 8 ranks lie within ``GRAD_REL``
  of the one process's, leaf by leaf over its largest magnitude
  (measured 7.8e-3 at most: the bf16 parameters' rounding). The wkv's
  ``u``, replicated over the batch axes that shard the wkv's other
  inputs, needs ``local_call``'s partial-sum gradient there: left
  replicated it was never summed over the ranks, 0.33 off on 2 ranks.
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
MESH = ((2, 2, 2), ("pod", "data", "model"))
# case -> (arch, ShapeConfig args, microbatches)
CELLS = {
    "dense-prefill": ("gemma-2b-smoke", ("p", 64, 8, "prefill"), None),
    "dense-train": ("phi4-mini-3.8b-smoke", ("t", 64, 8, "train"), 2),
    "audio-decode": ("musicgen-large-smoke", ("d", 64, 8, "decode"), None),
    "vlm-decode": ("llama-3.2-vision-11b-smoke", ("d", 64, 8, "decode"),
                   None),
    "rwkv6-prefill": ("rwkv6-3b-smoke", ("p", 64, 8, "prefill"), None),
    "mqa-decode": ("gemma-2b-smoke", ("d", 64, 8, "decode"), None),
    "mqa-decode-kv8": ("gemma-2b-smoke+kv8", ("d", 64, 8, "decode"), None),
    "mqa-decode-window": ("gemma-2b-smoke", ("d", 64, 8, "decode"), None),
}
# case -> the sliding window its config is given
WINDOW = {"mqa-decode-window": 16}
# the context-parallel decodes: one KV head, so the cache's sequence
# ('kvseq') takes 'model'
MQA = ("mqa-decode", "mqa-decode-kv8", "mqa-decode-window")
REAL = ("dense-prefill", "audio-decode", "mqa-decode")
# logits jobs: (case, planted fault)
LOGITS = (("dense-prefill", None), ("dense-prefill", "misplaced"),
          ("mqa-decode", None), ("mqa-decode-kv8", None),
          ("mqa-decode-window", None), ("mqa-decode", "decode_uncombined"))
LOGIT_BOUND = 1e-5
GRAD_REL = 0.05
# the functional collectives' op-table rows by the names CommDebugMode
# gives them (tests/test_torch_train_mesh.py's)
COLLECTIVES = ("all_gather_into_tensor", "all_reduce",
               "reduce_scatter_tensor", "all_to_all_single")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The fake-mesh cells (one subprocess) and the 8-rank jobs (one
    ``gloo`` group), started together."""
    tmp = tmp_path_factory.mktemp("dryrun_multi")
    fake = subprocess.Popen([sys.executable, "-c", textwrap.dedent("""
        import dataclasses, json, sys, time
        sys.path.insert(0, %r)
        from repro_torch.configs import ShapeConfig, get_config
        from repro_torch.launch import dryrun
        out, window = {}, json.loads(%r)
        for case, (arch, shape, mb) in json.loads(%r).items():
            cfg = get_config(arch)
            if case in window:
                cfg = dataclasses.replace(
                    cfg, sliding_window=window[case],
                    name=f"{cfg.name}-w{window[case]}")
            t0 = time.perf_counter()
            rec = dryrun.run_cell(cfg, ShapeConfig(*shape),
                                  "single", mesh_shape=%r, out_dir=%r,
                                  microbatches=mb)
            rec["seconds"] = time.perf_counter() - t0
            out[case] = rec
        print("CELLS" + json.dumps(out, default=float))
    """) % (str(SRC), json.dumps(WINDOW), json.dumps(CELLS), MESH,
            str(tmp))],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    jobs = [{"kind": "dryrun", "arch": CELLS[c][0], "shape": CELLS[c][1],
             "mesh_shape": MESH} for c in REAL]
    jobs += [{"kind": "logits", "arch": CELLS[c][0], "shape": CELLS[c][1],
              "window": WINDOW.get(c), "mesh_shape": MESH, "fault": f}
             for c, f in LOGITS]
    jobs += [{"kind": "grads", "arch": "rwkv6-3b-smoke", "batch": [8, 32],
              "mesh_shape": MESH}]
    path = tmp / "jobs.json"
    path.write_text(json.dumps(jobs))
    ranks = subprocess.Popen(
        [sys.executable, str(TESTS / "_torch_train_mesh.py"), "8",
         str(_free_port()), str(path), str(tmp / "out.json")],
        env={**os.environ, "PYTHONPATH": str(SRC)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        stdout, err = fake.communicate(timeout=240)
        _, rank_err = ranks.communicate(timeout=300)
    finally:
        for proc in (fake, ranks):
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    line = [ln for ln in stdout.splitlines() if ln.startswith("CELLS")]
    assert line, err[-3000:]
    assert ranks.returncode == 0, rank_err[-3000:]
    real = json.loads((tmp / "out.json").read_text())
    return {"fake": json.loads(line[0][5:]), "dir": tmp,
            "real": dict(zip(REAL, real)),
            "logits": dict(zip(LOGITS, real[len(REAL):-1])),
            "grads": real[-1]}


@pytest.mark.parametrize("case", sorted(CELLS))
def test_reduced_cell_lowers_on_the_three_axis_mesh(runs, case):
    rec = runs["fake"][case]
    assert rec["ok"], (case, rec.get("error"), rec.get("traceback"))
    assert rec["chips"] == 8 and rec["collectives"]["total"] > 0, case
    assert rec["flops_per_device"] > 0 and rec["bytes_per_device"] > 0
    assert rec["strided_ops"] == 0, case
    assert rec["kind"] == CELLS[case][1][3]
    assert rec.get("microbatches") == CELLS[case][2]
    name = rec["arch"] + "__" + rec["shape"] + "__single"
    assert (runs["dir"] / (name + ".json")).exists()
    assert (runs["dir"] / (name + ".ops.json.gz")).exists()


@pytest.mark.parametrize("case", REAL)
def test_eight_ranks_issue_what_the_fake_mesh_counts(runs, case):
    real, meta = runs["real"][case], runs["fake"][case]
    assert real["ok"] and meta["ok"], (real["error"], meta.get("error"))
    assert real["chips"] == meta["chips"] == 8
    counted = {k.split(".")[-1]: v[0] for k, v in meta["ops"].items()
               if k.split(".")[-1] in COLLECTIVES}
    assert counted and real["comm_counts"] == counted, (real, counted)
    assert real["collectives"] == meta["collectives"]
    assert real["flops_per_device"] == meta["flops_per_device"]
    assert real["bytes_per_device"] == meta["bytes_per_device"]


def test_eight_rank_logits_within_the_bound(runs):
    sound = runs["logits"][("dense-prefill", None)]
    assert sound["shape"] == [8, 256]  # the last position's
    assert sound["max_abs"] <= LOGIT_BOUND, sound


def test_a_misplaced_local_call_output_breaks_the_bound(runs):
    fault = runs["logits"][("dense-prefill", "misplaced")]
    assert fault["max_abs"] > LOGIT_BOUND, fault


@pytest.mark.parametrize("case", MQA)
def test_eight_rank_context_parallel_decode_logits_within_the_bound(
        runs, case):
    """A decode step against a cache with a history, its sequence split
    over 'model', on the 8 ranks against one process (module doc)."""
    sound = runs["logits"][(case, None)]
    assert sound["shape"] == [8, 256]
    assert sound["max_abs"] <= LOGIT_BOUND, sound


def test_an_uncombined_decode_softmax_breaks_the_bound(runs):
    fault = runs["logits"][("mqa-decode", "decode_uncombined")]
    assert fault["max_abs"] > LOGIT_BOUND, fault


@pytest.mark.parametrize("case", MQA)
def test_context_parallel_decode_gathers_no_cache(runs, case):
    """Each rank attends over its own sequence shard of the cache: the
    step's gathers, all layers together, move less than one layer's K
    cache shard on one rank."""
    rec, (arch, (_, S, B, _), _) = runs["fake"][case], CELLS[case]
    assert rec["ok"], rec.get("error")
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    (pod, data, model), _ = MESH
    shard = (B // (pod * data)) * (min(S, WINDOW.get(case, S)) // model) \
        * cfg.num_kv_heads * cfg.head_dim * (
            1 if cfg.kv_cache_dtype == "int8" else cfg.dtype.itemsize)
    gathered = rec["collectives"]["by_kind"].get("all-gather", 0.0)
    assert gathered < shard, (gathered, shard)


def test_eight_rank_gradients_within_the_bound(runs):
    """Every leaf's gradient of a reduced rwkv6 on the 8 ranks against the
    one process's, the wkv's ``u`` among them (module doc)."""
    rel = runs["grads"]
    assert "layers/u" in rel and len(rel) > 10, sorted(rel)
    assert max(rel.values()) <= GRAD_REL, sorted(rel.items(),
                                                 key=lambda kv: -kv[1])[:4]

