"""Training on 2 ranks against ``repro``'s own 2-device step, on the CPU.

One checkpoint in the shared format (``train/checkpoint.py``: a
checkpoint written by either package restores in the other), saved by
the port's one-process launcher at step 2 of 4 on the reduced
``rwkv6-3b``, is resumed by:

- the port's launcher on 2 ``gloo`` ranks (``tests/_torch_train_mesh.py``:
  the ranks' ``("data",)`` mesh);
- ``python -m repro.launch.train --smoke --resume`` in a process of its
  own on a 2-device CPU mesh
  (``XLA_FLAGS=--xla_force_host_platform_device_count=2``), its step
  losses recorded by wrapping the jitted step it builds (the launcher
  prints only every tenth step; ``repro`` is not edited).

Both draw the same batches (checked first), so the losses of the two
resumed steps are compared, relative to ``repro``'s:

- the first runs on the checkpoint's parameters: within ``LOSS_REL``
  (1e-6; measured 8.8e-8);
- the second on parameters updated once, each package summing the 2
  devices' gradients in its own order (a last-bit difference can round a
  bf16 parameter one step apart): within ``STEP_LOSS_REL`` (5e-4, the
  bound of tests/test_torch_train_mesh.py; measured 9.8e-5);
- the bound's power: the planted fault (``_torch_train_mesh.unreduced``:
  each rank steps on its own half batch, its gradient never reduced)
  moves the second loss by 3.6e-3 from ``repro``'s, beyond
  ``STEP_LOSS_REL``: the bound sits between the sound and the faulty
  readings.

``repro``'s 2-device run also holds to the port's one-process run
(8.8e-8 and 2.7e-7): the 2 ranks' reduction order, not the package,
makes the second step's gap.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401
from _torch_train import one_torch_thread  # noqa: F401
from _torch_train_mesh import armed
from repro.data import TokenDataset as JTokenDataset
from repro_torch.configs import get_config
from repro_torch.data import TokenDataset
from repro_torch.launch import train as launch
from test_torch_train_mesh import (LOSS_REL, RESUME_AT, STEP_LOSS_REL, STEPS,
                                   _one_step, _ranks, _results)

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
ARCH = "rwkv6-3b"
BATCH, SEQ = 4, 32

# repro's launcher, its jitted train step wrapped to record each loss
REPRO_RUN = textwrap.dedent("""
    import json, sys
    import jax
    import repro.launch.train as launch
    import repro.train  # noqa: F401 (imported before jax.jit is wrapped)
    losses, real_jit = [], jax.jit

    def jit(fn, **kw):
        f = real_jit(fn, **kw)
        if getattr(fn, "__name__", "") != "step":  # train.make_train_step's
            return f

        def run(state, batch):
            state, m = f(state, batch)
            losses.append(float(m["loss"]))
            return state, m
        return run

    jax.jit = jit
    assert len(jax.devices()) == 2, jax.devices()
    rc = launch.main(sys.argv[1:])
    print("LOSSES" + json.dumps(losses))
    sys.exit(rc)
""")


def _argv(ckpt: Path, *extra: str) -> list:
    return ["--arch", ARCH, "--smoke", "--steps", str(STEPS), "--batch",
            str(BATCH), "--seq", str(SEQ), "--ckpt", str(ckpt), *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's one-process run (its step-2 checkpoint), then the 2-rank
    runs (sound and faulty) and ``repro``'s 2-device run at once, each
    resumed from a copy of that checkpoint."""
    tmp = tmp_path_factory.mktemp("train_mesh_repro")
    one_ck = tmp / "one"
    with armed():
        one = launch.run(launch.parse_args(_argv(
            one_ck, "--device", "cpu", "--ckpt-every", str(RESUME_AT))))
    cks = {k: _one_step(one_ck, tmp / k, RESUME_AT)
           for k in ("two", "fault", "repro")}
    two = _ranks(2, [
        {"kind": "train", "argv": _argv(cks["two"], "--device", "cpu",
                                        "--resume")},
        {"kind": "train", "fault": "unreduced",
         "argv": _argv(cks["fault"], "--device", "cpu", "--resume")}],
        tmp, "two")
    env = {**os.environ, "PYTHONPATH": str(SRC), "JAX_PLATFORMS": "cpu",
           "XLA_FLAGS": "--xla_force_host_platform_device_count=2"}
    ref = subprocess.run(
        [sys.executable, "-c", REPRO_RUN, *_argv(cks["repro"], "--resume")],
        env=env, capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr[-3000:]
    line = [ln for ln in ref.stdout.splitlines() if ln.startswith("LOSSES")]
    assert "resumed from step 2" in ref.stdout and line, ref.stdout
    sound, fault = _results(two, tmp, "two")
    return dict(one=one["losses"], repro=json.loads(line[0][6:]),
                sound=sound, fault=fault)


def test_both_packages_draw_the_same_batches():
    cfg = get_config(ARCH + "-smoke")
    ours = TokenDataset(cfg.vocab_size, SEQ, seed=0)
    theirs = JTokenDataset(cfg.vocab_size, SEQ, seed=0)
    for step in range(STEPS):
        a, b = ours.shard_batch(step, BATCH), theirs.shard_batch(step, BATCH)
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


def _rel(got: list, want: list) -> list:
    assert len(got) == len(want) == STEPS - RESUME_AT, (got, want)
    return [abs(a - b) / abs(b) for a, b in zip(got, want)]


def test_two_ranks_hold_to_repros_two_device_step(runs):
    r = runs["sound"]
    assert r["mesh"] == [2] and r["start"] == RESUME_AT
    rel = _rel(r["losses"], runs["repro"])
    assert rel[0] <= LOSS_REL, rel
    assert rel[1] <= STEP_LOSS_REL, rel


def test_repro_resumes_the_ports_checkpoint(runs):
    """``repro`` on 2 devices against the port's one process: the first
    resumed loss within ``LOSS_REL``, the run within ``STEP_LOSS_REL``."""
    rel = _rel(runs["repro"], runs["one"][RESUME_AT:])
    assert rel[0] <= LOSS_REL and rel[1] <= STEP_LOSS_REL, rel


def test_an_unreduced_gradient_breaks_the_bound_against_repro(runs):
    r = runs["fault"]
    assert r["mesh"] is None and r["start"] == RESUME_AT
    assert _rel(r["losses"], runs["repro"])[1] > STEP_LOSS_REL
