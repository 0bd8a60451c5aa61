"""``python -m repro_torch.launch.train`` on the CPU: ``main`` trains the
reduced gemma-2b and rwkv6-3b, checkpoints, and ``--resume`` restores the
saved state leaf for leaf; ``run`` hands losses, step times and the state
to a caller; ``--multi-pod`` is refused without a group of 512 ranks."""
import math

import pytest
import torch

from _torch_spine import port_lockdep_armed, port_racedep_armed  # noqa: F401
from _torch_train import one_torch_thread  # noqa: F401
from repro_torch.launch import train as launch
from repro_torch.models.params import tree_defs
from repro_torch.train.checkpoint import latest_step


@pytest.mark.parametrize("arch,extra", [
    ("gemma-2b", []),
    ("rwkv6-3b", ["--microbatches", "2", "--compress"])])
def test_main_trains_checkpoints_and_resumes(arch, extra, tmp_path, capsys):
    argv = ["--arch", arch, "--smoke", "--steps", "4", "--device", "cpu",
            "--batch", "4", "--seq", "32", "--ckpt", str(tmp_path),
            "--ckpt-every", "2", *extra]
    assert launch.main(argv) == 0
    assert "finished at loss" in capsys.readouterr().out
    assert latest_step(tmp_path) == 4
    first = launch.run(launch.parse_args(argv))  # the same run, anew
    assert first["start"] == 0 and len(first["losses"]) == 4
    assert all(math.isfinite(x) for x in first["losses"])
    assert len(first["step_s"]) == 4
    again = launch.run(launch.parse_args(argv + ["--resume"]))
    assert again["start"] == 4 and again["losses"] == []
    got = dict(tree_defs(again["state"]))
    for path, want in tree_defs(first["state"]):
        assert got[path].dtype == want.dtype, path
        assert torch.equal(got[path], want), path
    assert ("ef" in first["state"]) == ("--compress" in extra)


def test_run_calls_on_step_after_each_step():
    seen = []
    launch.run(launch.parse_args(
        ["--arch", "musicgen-large", "--smoke", "--steps", "2", "--batch",
         "2", "--seq", "16", "--device", "cpu"]),
        on_step=lambda i, state, m: seen.append((i, float(m["loss"]))))
    assert [i for i, _ in seen] == [1, 2]


def test_multi_pod_is_refused(capsys, monkeypatch):
    """Without a group of 512 ranks ``--multi-pod`` is refused, naming the
    world size: this process alone, and a ``torchrun`` of 8."""
    for world, env in (("1", None), ("8", "8")):
        if env is None:
            monkeypatch.delenv("WORLD_SIZE", raising=False)
        else:
            monkeypatch.setenv("WORLD_SIZE", env)
        with pytest.raises(SystemExit) as e:
            launch.parse_args(["--arch", "gemma-2b", "--multi-pod"])
        assert e.value.code == 2
        err = capsys.readouterr().err
        assert f"world size {world}" in err and "512 ranks" in err, err
