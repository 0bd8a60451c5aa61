"""Small sizes at which a whole run of a cell fits a CPU test: cells of
their own, in a checkout of their own (a copy of ``portbench/`` with the
small configurations, mix and limits added as files and entries). That
checkout also holds the cells measured and left out of ``BENCHMARK.json``
(``shelved.json``), so that their configuration, reference and readers
stay under test."""
import atexit
import contextlib
import json
import shutil
import tempfile
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[2]

#: the families' widths cut to CPU size (layers, width, heads, vocab)
TINY = {
    "rwkv6": dict(num_layers=2, d_model=128, num_heads=2, head_dim=64,
                  d_ff=256, vocab_size=512, rwkv_lora_dim=8,
                  rwkv_decay_lora_dim=8),
    "dense": dict(num_layers=2, d_model=128, num_heads=4, num_kv_heads=2,
                  head_dim=32, d_ff=256, vocab_size=512),
}

#: a closed loop of 4 clients with short prompts and answers
MIX = dict(clients=4, slots=4, max_len=96,
           prompt_tokens=[[0.0, 8], [0.5, 20], [1.0, 48]],
           output_tokens=[[0.0, 4], [0.5, 8], [1.0, 16]], block=8,
           check_min_served_tokens=96, check_max_requests=8)

#: the output check's limit at these sizes: the cells' limits are set for
#: logits of std ~1 at full width, these have std ~0.23; sound bf16 runs
#: read at most 0.013 here, each planted fault 0.4 or more
TINY_LIMIT = 0.05

#: one cell of each family, by name in BENCHMARK.json or shelved.json
CELLS = {"rwkv6": "rwkv6-3b.chat", "dense": "phi4-mini-3.8b.longprompt"}

#: cells measured and left out of BENCHMARK.json, with their entries
SHELVED = Path(__file__).with_name("shelved.json")

_checkout = []


def tiny_checkout() -> Path:
    """A checkout (made once a process, removed at its exit) whose
    ``BENCHMARK.json`` adds a cell ``<family>-tiny.tiny`` of each family:
    the family's configuration at ``TINY`` sizes, the ``MIX`` traffic and
    the limit ``TINY_LIMIT``."""
    if _checkout:
        return _checkout[0]
    root = Path(tempfile.mkdtemp(prefix="portbench-tiny-"))
    atexit.register(shutil.rmtree, root, True)
    pb = root / "portbench"
    shutil.copytree(ROOT / "portbench", pb, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    shelved = json.loads(SHELVED.read_text())
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        bench[key] += shelved[key]
    for cell, limits in shelved["limits"].items():
        (pb / "cells" / f"{cell}.json").write_text(json.dumps(limits))
    configs = {c["name"]: c for c in bench["configs"]}
    cells = {w["name"]: w for w in bench["workloads"]}
    (pb / "traffic" / "tiny.json").write_text(json.dumps(
        {**MIX, "name": "tiny", "loop": "closed"}))
    for family, cell in CELLS.items():
        entry = configs[cells[cell]["config"]]
        name = f"{family}-tiny"
        model = json.loads((ROOT / entry["file"]).read_text())
        (pb / "configs" / f"{name}.json").write_text(json.dumps(
            {**model, **TINY[family], "name": name}))
        (pb / "cells" / f"{name}.tiny.json").write_text(json.dumps(
            {"max_logit_gap": {"limit": TINY_LIMIT}}))
        bench["configs"].append({**entry, "name": name,
                                 "file": f"portbench/configs/{name}.json"})
        bench["workloads"].append({**cells[cell], "name": f"{name}.tiny",
                                   "config": name, "traffic": "tiny"})
        for m in bench["end_to_end"] + bench["per_layer"]:
            if cell in m.get("workloads", [cell]) and "workloads" in m:
                m["workloads"].append(f"{name}.tiny")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    _checkout.append(root)
    return root


def tiny_cell(name: str):
    """Cell ``name`` (of BENCHMARK.json, shelved.json or the small ones)
    resolved in the small checkout."""
    from portbench.harness.registry import resolve

    root = tiny_checkout()
    return resolve(name, root, root / "portbench")


@contextlib.contextmanager
def one_thread():
    """Torch on one intra-op thread (the suite runs several workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def tiny_run(family: str, seed: int = 5, seconds: float = 0.6, **kw):
    """A whole run of the family's small cell on the CPU."""
    from portbench.harness.main import run_cell

    root = tiny_checkout()
    with one_thread():
        return run_cell(f"{family}-tiny.tiny", seed, seconds, False,
                        root=root, device="cpu", pb=root / "portbench", **kw)
