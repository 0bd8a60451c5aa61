"""Training on a real multi-rank mesh, on the CPU: ``gloo`` process groups
of 1, 2 and 4 ranks (``tests/_torch_train_mesh.py``, in the pattern of
``tests/_torch_gloo_psum.py``) on the reduced ``rwkv6-3b`` and
``mixtral-8x7b``.

- The launcher trains on the ranks' ``("data",)`` mesh: resumed on 2 ranks
  from the checkpoint that the one-process run saved at step 2, its losses
  against the one-process run's. The first step runs on the same
  parameters, so its loss is within ``LOSS_REL`` (1e-6, relative; measured
  8.6e-8 at 2 ranks, 0 at 4), the reduction orders alone apart. The next
  runs on parameters updated once: the ranks sum the gradient in another
  order, and a last-bit difference can round a bf16 parameter one step
  apart (tests/_torch_train.py's rule), which moves the loss: within
  ``STEP_LOSS_REL`` (5e-4; measured 2.4e-6 for rwkv6 at 2 ranks, 2.6e-7
  for mixtral). Until the wkv's ``u`` took a partial-sum gradient over
  the batch axes (``sharding.local_call``) its gradient was never summed
  over the ranks, and rwkv6 read 6.9e-5–9.8e-5 at 2 ranks, 1.2e-5 at 4,
  its gap growing with every update (1.7e-3 and 3.0e-3 three updates
  on): the test holds two steps.
- The bound's power: a planted fault, each rank stepping on its own half
  batch with its gradient never reduced (only the reported loss averaged
  over the ranks), moves the second loss by 3.6e-3 (rwkv6) and 5.3e-3
  (mixtral), beyond ``STEP_LOSS_REL``: it sits between the sound and the
  faulty readings. rwkv6's first loss under the fault is exact (the mean
  of the halves' means); mixtral's parts by 9.2e-4 already, since the
  experts' capacity depends on the rows a rank routes.
- The re-shard: the 2-rank run's checkpoint restores with ``shardings=``
  onto 1 and 4 ranks, the one-process checkpoint onto 2 and a checkpoint
  saved from 4 ranks onto 2, every leaf in ``state_shardings``' placements
  and, gathered, equal to the saved arrays bit for bit.
- The draw does not depend on the mesh: a state drawn on 2 ranks,
  gathered, equals the one-device draw bit for bit.
- The port's lockdep and racedep are armed in every rank and around the
  one-process runs (``_torch_train_mesh.armed``): the checkpoint's rank-0
  writer and its barrier raise no violation.
- The dry run's collectives: the reduced ``phi4-mini-3.8b`` decode cell of
  tests/test_torch_dryrun.py on a (2, 2) ``("data", "model")`` mesh, run
  for real on 4 ranks, issues exactly the collectives (by kind and count,
  ``CommDebugMode``) and bytes that the fake group's meta run counts.
"""
import json
import os
import shutil
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401
from _torch_train import one_torch_thread  # noqa: F401
from _torch_train_mesh import armed, saved_arrays
from repro_torch import sharding as shd
from repro_torch.configs import get_config
from repro_torch.launch import train as launch
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.params import tree_defs
from repro_torch.train import TrainConfig, state_shardings, train_state_defs
from repro_torch.train.checkpoint import restore_checkpoint

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
ARCHS = ("rwkv6-3b", "mixtral-8x7b")
LOSS_REL = 1e-6
STEP_LOSS_REL = 5e-4
RESUME_AT, STEPS = 2, 4
DRY_CELL = ("phi4-mini-3.8b-smoke", ("d", 64, 4, "decode"),
            ((2, 2), ("data", "model")))
# the functional collectives' op-table rows (roofline.counters) by the
# names CommDebugMode gives them
COLLECTIVES = ("all_gather_into_tensor", "all_reduce",
               "reduce_scatter_tensor", "all_to_all_single")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _ranks(n: int, jobs: list, tmp: Path, tag: str) -> subprocess.Popen:
    """Start ``jobs`` on a group of ``n`` ranks; :func:`_results` waits."""
    path = tmp / f"{tag}.jobs.json"
    path.write_text(json.dumps(jobs))
    return subprocess.Popen(
        [sys.executable, str(TESTS / "_torch_train_mesh.py"), str(n),
         str(_free_port()), str(path), str(tmp / f"{tag}.out.json")],
        env={**os.environ, "PYTHONPATH": str(SRC)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _results(proc: subprocess.Popen, tmp: Path, tag: str) -> list:
    _, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err[-3000:]
    return json.loads((tmp / f"{tag}.out.json").read_text())


def _argv(arch: str, ckpt: Path, *extra: str) -> list:
    return ["--arch", arch, "--smoke", "--steps", str(STEPS), "--batch",
            "4", "--seq", "32", "--device", "cpu", "--ckpt", str(ckpt),
            *extra]


def _one_step(src: Path, dst: Path, step: int) -> Path:
    """A checkpoint directory holding ``src``'s ``step`` alone."""
    name = f"step_{step:08d}"
    shutil.copytree(src / name, dst / name)
    (dst / "LATEST").write_text(name)
    return dst


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every run the tests read: the one-process runs, the meta dry-run
    cell (in a process of its own: the fake group), then three rank
    groups one after another (2; 4; 2)."""
    tmp = tmp_path_factory.mktemp("train_mesh")
    arch, shape, mesh = DRY_CELL
    meta = subprocess.Popen([sys.executable, "-c", textwrap.dedent("""
        import json, sys
        sys.path.insert(0, %r)
        from repro_torch.configs import ShapeConfig, get_config
        from repro_torch.launch import dryrun
        rec = dryrun.run_cell(get_config(%r), ShapeConfig(*%r), "single",
                              mesh_shape=%r)
        print("CELL" + json.dumps({k: rec.get(k) for k in (
            "ok", "error", "chips", "collectives", "ops")}, default=float))
    """) % (str(SRC), arch, shape, mesh)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)

    out = {"one": {}, "ckpt": {}, "fault": {}}
    for a in ARCHS:  # the one-process runs, a checkpoint at step 2
        ck = tmp / f"one_{a}"
        with armed():
            out["one"][a] = launch.run(launch.parse_args(_argv(
                a, ck, "--ckpt-every", str(RESUME_AT))))["losses"]
        out["ckpt"][a] = {
            "one": ck, "two": _one_step(ck, tmp / f"two_{a}", RESUME_AT),
            "four": tmp / f"four_{a}",
            "fault": _one_step(ck, tmp / f"fault_{a}", RESUME_AT)}
    two = _ranks(2, [{"kind": "draw", "arch": a} for a in ARCHS]
                 + [{"kind": "restore", "arch": a,
                     "ckpt": str(out["ckpt"][a]["one"]), "step": RESUME_AT}
                    for a in ARCHS]
                 + [{"kind": "train", "argv": _argv(
                     a, out["ckpt"][a]["two"], "--resume")} for a in ARCHS]
                 + [{"kind": "train", "fault": "unreduced", "argv": _argv(
                     a, out["ckpt"][a]["fault"], "--resume")}
                    for a in ARCHS], tmp, "two")
    out["two"] = _results(two, tmp, "two")
    four = _ranks(4, [{"kind": "restore", "arch": a,
                       "ckpt": str(out["ckpt"][a]["two"]), "step": STEPS,
                       "save_to": str(out["ckpt"][a]["four"])}
                      for a in ARCHS]
                  + [{"kind": "dryrun", "arch": arch, "shape": shape,
                      "mesh_shape": mesh}], tmp, "four")
    out["four"] = _results(four, tmp, "four")
    back = _ranks(2, [{"kind": "restore", "arch": a,
                       "ckpt": str(out["ckpt"][a]["four"]), "step": STEPS}
                      for a in ARCHS], tmp, "back")
    out["back"] = _results(back, tmp, "back")
    stdout, err = meta.communicate(timeout=300)
    line = [ln for ln in stdout.splitlines() if ln.startswith("CELL")]
    assert line, err[-3000:]
    out["meta"] = json.loads(line[0][4:])
    return out


def _check_restore(r: dict, step: int) -> None:
    assert r["step"] == step
    assert r["wrong_placements"] == [] and r["differ"] == [], r
    assert 0 < r["sharded"] <= r["leaves"]


@pytest.mark.parametrize("i,arch", enumerate(ARCHS))
def test_draw_does_not_depend_on_the_mesh(runs, i, arch):
    r = runs["two"][i]
    assert r["wrong_placements"] == [] and r["differ"] == [], r
    assert r["sharded"] > 0, r  # the embed axis sharded over data


def _rel(runs: dict, r: dict, arch: str) -> list:
    """A run resumed at RESUME_AT: its losses against the one-process
    run's, relative."""
    assert r["start"] == RESUME_AT
    one = runs["one"][arch][RESUME_AT:]
    assert len(r["losses"]) == len(one) == STEPS - RESUME_AT
    return [abs(a - b) / abs(b) for a, b in zip(r["losses"], one)]


@pytest.mark.parametrize("i,arch", enumerate(ARCHS))
def test_launcher_trains_on_two_ranks_within_the_bound(runs, i, arch):
    r = runs["two"][2 * len(ARCHS) + i]
    assert r["mesh"] == [2]
    rel = _rel(runs, r, arch)
    assert rel[0] <= LOSS_REL, (arch, rel)
    assert max(rel[1:]) <= STEP_LOSS_REL, (arch, rel)


@pytest.mark.parametrize("i,arch", enumerate(ARCHS))
def test_an_unreduced_gradient_breaks_the_bound(runs, i, arch):
    """The planted fault (``_torch_train_mesh.unreduced``): each of 2
    ranks steps on its own half batch, its gradient unreduced. Its second
    loss lies beyond ``STEP_LOSS_REL`` (module doc)."""
    r = runs["two"][3 * len(ARCHS) + i]
    assert r["mesh"] is None
    rel = _rel(runs, r, arch)
    assert max(rel[1:]) > STEP_LOSS_REL, (arch, rel)


@pytest.mark.parametrize("i,arch", enumerate(ARCHS))
def test_one_rank_checkpoint_restores_onto_two(runs, i, arch):
    _check_restore(runs["two"][len(ARCHS) + i], RESUME_AT)


@pytest.mark.parametrize("i,arch", enumerate(ARCHS))
def test_two_rank_checkpoint_restores_onto_four(runs, i, arch):
    _check_restore(runs["four"][i], STEPS)


@pytest.mark.parametrize("i,arch", enumerate(ARCHS))
def test_four_rank_checkpoint_restores_onto_two(runs, i, arch):
    _check_restore(runs["back"][i], STEPS)
    # the 4 ranks saved what they restored: the 2-rank run's state
    four = saved_arrays(runs["ckpt"][arch]["four"], STEPS)
    two = saved_arrays(runs["ckpt"][arch]["two"], STEPS)
    assert four.keys() == two.keys()
    assert all(torch.equal(four[k], two[k]) for k in two)


@pytest.mark.parametrize("arch", ARCHS)
def test_two_rank_checkpoint_restores_onto_one_device(runs, arch):
    """Onto a one-device mesh (no group): whole tensors, bit for bit."""
    cfg, tc = get_config(arch + "-smoke"), TrainConfig()
    mesh = make_local_mesh("cpu")
    ck = runs["ckpt"][arch]["two"]
    with shd.set_mesh(mesh):
        state, step = restore_checkpoint(
            ck, train_state_defs(cfg, tc), device="cpu",
            shardings=state_shardings(cfg, tc, mesh))
    assert step == STEPS
    saved = saved_arrays(ck, STEPS)
    for path, t in tree_defs(state):
        assert type(t) is torch.Tensor, path
        assert torch.equal(t, saved["/".join(path)]), path


def test_dry_run_collectives_equal_a_real_four_rank_step(runs):
    real, meta = runs["four"][-1], runs["meta"]
    assert real["ok"] and meta["ok"], (real["error"], meta["error"])
    assert real["chips"] == meta["chips"] == 4
    counted = {k.split(".")[-1]: v[0] for k, v in meta["ops"].items()
               if k.split(".")[-1] in COLLECTIVES}
    assert counted and real["comm_counts"] == counted, (real, counted)
    assert real["collectives"] == meta["collectives"]
