"""The port's four examples (``examples/torch_*.py``) run as a user runs
them, each in a subprocess on the CPU (``--device cpu``) at a small size:
each exits 0 and prints its OK line. Without ``--device`` on a machine
with no card an example fails, naming the missing card, instead of
running on the CPU. The examples' imports are checked in
``tests/test_torch_isolation.py``."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

CASES = {
    "quickstart": ["--size", "128", "--tile", "64"],
    # 32-px tiles: the auto-export and inference hops decode every level in
    # up to 8 threads at once, and the CPU's plain entropy decode slows
    # several-fold so (64-px tiles: ~67 s a run here, 32-px: ~33 s)
    "institutional_batch": ["--real-slides", "2", "--real-size", "64",
                            "--tile", "32", "--images", "10",
                            "--concurrency", "2"],
    "serve_llm": ["--requests", "3", "--max-new", "4"],
    "train_lm": ["--steps", "4", "--batch", "2", "--seq", "16"],
}


def _run(name: str, args: list, tmp_path, timeout: float, **env):
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / f"torch_{name}.py"), *args],
        cwd=tmp_path, capture_output=True, text=True, timeout=timeout,
        env={**os.environ, "TMPDIR": str(tmp_path), **env})


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_runs_on_the_cpu(name, tmp_path):
    out = _run(name, ["--device", "cpu", *CASES[name]], tmp_path,
               timeout=240)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    assert out.stdout.splitlines()[-1] == f"{name} OK"


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_without_a_card_fails_instead_of_using_the_cpu(name,
                                                               tmp_path):
    out = _run(name, CASES[name], tmp_path, timeout=120,
               CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert "no CUDA device is available" in out.stderr, out.stderr[-2000:]
    assert f"{name} OK" not in out.stdout
