"""On the card, at each cell's own size and against its own limit: the
program passes, the float8 control fails (the limits' readings, PERF.md),
and a run with each planted fault (``portbench_faults``) comes out not
correct.

    python -m pytest -q portbench/tests/test_portbench_card.py

Skips where there is no CUDA device."""
import gc
import json

import pytest
import torch

from portbench.harness.registry import load_bench
from portbench.tests.portbench_faults import FAULTS
from portbench.tests.portbench_tiny import ROOT

CELLS = [w["name"] for w in load_bench(ROOT)["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.cuda.get_device_name(0)


def _run(*args, **kw):
    """``run_cell`` on the card; a run that raises fails its case with the
    message alone, so that no traceback keeps its tensors on the card for
    the cases after it."""
    from portbench.harness.main import run_cell

    try:
        return run_cell(*args, root=ROOT, **kw)
    except Exception as e:  # noqa: BLE001
        msg = f"{type(e).__name__}: {e}"
    gc.collect()
    torch.cuda.empty_cache()
    pytest.fail(msg)


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    result, checks, notes = _run(cell, 2**31 + 101, 15.0, False,
                                 control=True)
    got = notes[-1]
    limit = checks["max_logit_gap"][1]
    assert result["correct"], json.dumps(result)
    assert got["program_gap"] <= limit < got["control_gap"], got


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_fails_the_cells_limit(card, cell, fault):
    result, checks, _ = _run(cell, 2**31 + 211, 10.0, False,
                             inject=FAULTS[fault])
    print(json.dumps({"cell": cell, "fault": fault,
                      "checks": result["checks"]}))
    assert not result["correct"], json.dumps(result["checks"])
    assert checks["max_logit_gap"][0] > checks["max_logit_gap"][1]


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_run_reads_every_per_layer_metric(card, cell):
    """The traced slice (the wkv kernels found in each prefill, the
    attention ranges, the graph replays) gives every per-layer metric the
    cell names, and the run stays correct."""
    from portbench.harness.registry import resolve

    result, _, _ = _run(cell, 2**31 + 307, 8.0, True)
    want = {m["name"] for m in resolve(cell, ROOT).per_layer}
    print(json.dumps({"cell": cell, "metrics": result["metrics"]}))
    assert result["correct"], json.dumps(result["checks"])
    assert set(result["metrics"]) == want
    assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
