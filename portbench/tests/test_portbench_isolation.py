"""No run loads JAX or the JAX package; the references import nothing of
the program."""
import json
import os
import subprocess
import sys

import pytest

from portbench.harness.isolation import FORBIDDEN, imports, loaded_jax
from portbench.tests.portbench_tiny import ROOT

PB = ROOT / "portbench"


@pytest.mark.parametrize("path", sorted(PB.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PB)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PB / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert not imports(path) & (FORBIDDEN | {"repro_torch"})


def test_names_are_compared_whole():
    assert loaded_jax({"repro_torch": 0, "repro_torch.serve": 0,
                       "jaxtyping": 0, "flaxen": 0}) == set()
    assert loaded_jax({"repro.models": 0, "jax._src": 0, "jaxlib": 0,
                       "flax": 0}) == {"repro", "jax", "jaxlib", "flax"}


def _python(code: str):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = _python(
        "import json\n"
        "from portbench.tests.portbench_tiny import tiny_run\n"
        "from portbench.harness.isolation import loaded_jax\n"
        "res, _, _ = tiny_run('rwkv6', seconds=0.3)\n"
        "print(json.dumps(sorted(loaded_jax())))\n")
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1]) == []


def test_run_refuses_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "phi4-mini-3.8b.longprompt",
         "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
        env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
