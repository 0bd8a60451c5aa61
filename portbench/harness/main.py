"""One run of one cell: set-up, the measured window, the traced slice, the
output check, the metrics.

:func:`run_cell` does the work and returns the result and the compared
numbers; ``portbench/run.py`` is the command that calls it on the card
and prints them. Tests call it on the CPU, on cells of small sizes in a
checkout of their own (``root``, ``pb``), and with planted faults
(``inject``).
"""
from __future__ import annotations

import dataclasses
import gc
import subprocess
from pathlib import Path

import torch

from portbench.harness import check, traffic
from portbench.harness.registry import PORTBENCH, resolve
from portbench.harness.serve import System, clock
from portbench.harness.trace import traced_slice
from portbench.harness.weights import make_params

__all__ = ["Run", "run_cell", "port_config", "PRE_S", "SLICE_S"]

#: seconds of the traced loop that are not read, then the slice that is
PRE_S = 1.0
SLICE_S = 4.0


@dataclasses.dataclass
class Run:
    """What a metric reader (``metrics/<name>.py``'s ``read``) is given."""

    model: dict  # the configuration file
    reference: object  # reference/<family>.py: its token_flops
    mix: traffic.Mix
    timing: object  # serve.Timing: the window's prefills and ticks
    requests: list  # serve.Req of every request sent
    setup_s: float
    on_card: bool = False
    slice: object = None  # trace.Slice of a --trace 1 run, else None

    @property
    def window_s(self) -> float:
        return self.timing.window_s

    def in_window(self, t) -> bool:
        return t is not None and self.timing.t0 <= t <= self.timing.t1


def port_config(model: dict):
    """The program's config of ``model['arch']`` with every field the
    configuration file gives."""
    from repro_torch.configs import get_config

    base = get_config(model["arch"])
    names = {f.name for f in dataclasses.fields(base)} - {"name", "source"}
    kw = {k: v for k, v in model.items() if k in names}
    kw["dtype"] = getattr(torch, model["dtype"])
    return dataclasses.replace(base, **kw)


def _power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        and out.stdout.strip() else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             root: Path, device="cuda", t_start: float | None = None,
             pb: Path = PORTBENCH, inject=None,
             pre_s: float = PRE_S, slice_s: float = SLICE_S,
             control: bool = False):
    """Run cell ``name`` once. Returns ``(result, checks, notes)``: the
    result line's dict, the compared numbers ``{name: (value, limit)}``
    and a few lines about the check. ``control`` adds the float8
    control's widest gap over the same sample to ``notes`` (the limits'
    calibration, ``tools/calibrate.py``; a run of the benchmark never
    computes it)."""
    t_start = clock() if t_start is None else t_start
    cell = resolve(name, root, pb)
    model = cell.model
    mix = traffic.Mix.from_dict(cell.mix)
    device = torch.device(device)
    on_card = device.type == "cuda"
    cfg = port_config(model)
    params = make_params(cell.reference.layout(model), seed, device,
                         cfg.dtype)
    system = System(cfg, params, mix,
                    traffic.requests(mix, model["vocab_size"], seed),
                    traffic.primers(mix, model["vocab_size"], seed))
    if inject is not None:
        inject(system)
    system.warm_up()
    setup_s = clock() - t_start
    system.run(seconds, record=True)
    peak_bytes = torch.cuda.max_memory_allocated(device) if on_card else 0
    sl = traced_slice(system, pre_s, slice_s) if trace else None
    run = Run(model=model, reference=cell.reference, mix=mix, timing=system.timing,
              requests=list(system.requests.values()), setup_s=setup_s,
              on_card=on_card, slice=sl)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    finished = [r for r in run.requests if run.in_window(r.t_done)]
    failed = sum(len(r.tokens) != r.max_new for r in finished)
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    picked = check.sample(finished, seed, mix.check_min_served_tokens,
                          mix.check_max_requests)
    gaps = [check.served_gaps(cell.reference, params, model, r, device)
            for r in picked]
    max_gap = float(max(g.max() for g in gaps)) if gaps else float("inf")
    limit = float(cell.limits["max_logit_gap"]["limit"])
    checks = {"max_logit_gap": (max_gap, limit),
              "failed_responses": (failed, 0)}
    correct = bool(finished) and failed == 0 and max_gap <= limit
    notes = [f"checked {len(picked)} requests, "
             f"{sum(len(r.tokens) for r in picked)} served tokens, "
             f"prompts {[len(r.prompt) for r in picked]}"]
    if control:
        ctl = [check.control_gaps(cell.reference, params, model, r, device)
               for r in picked]
        notes.append({"program_gap": max_gap,
                      "control_gap": float(max(g.max() for g in ctl)),
                      "served_tokens": sum(len(r.tokens) for r in picked)})

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak_bytes)}
    if on_card:
        dev["power_limit"] = _power_limit()
    result = {"correct": correct, "attempted": len(finished),
              "failed": failed, "metrics": metrics, "device": dev}
    if sl is not None:
        dev["busy_s"] = sl.busy_s
        dev["window_s"] = sl.window_s
        result["breakdown"] = {
            "device_ops": [[n, s] for n, s in sl.device_ops],
            "idle_gaps": [[n, s] for n, s in sl.idle_gaps]}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result, checks, notes
