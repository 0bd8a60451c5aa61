"""Systematic schedule exploration for the event-driven spine.

``SimScheduler`` is deterministic, which makes tests reproducible — and
blind: one seed exercises exactly one of the many legal orders of
equal-timestamp events (pub/sub deliveries, ack timers, autoscaler ticks
all landing on the same virtual instant). The bugs PRs 2/4/7 fixed lived
precisely in those orderings. This module turns the scheduler's
determinism into a *search*:

* ``SimScheduler(seed=N)`` draws a per-event tie-break key, so each seed
  runs a different legal permutation of equal-timestamp events — same
  program, different schedule, still fully reproducible from the seed.
* :func:`explore` re-runs a scenario under many seeds with racedep armed,
  asserting the scenario's own invariants (every slide settles exactly
  once — the scenarios assert it), cross-seed result identity (study tars
  byte-identical regardless of schedule), and zero data-race reports.
* On failure it writes ``artifacts/schedule-<scenario>-seed<N>.json`` —
  seed, schedule trace, exception — and prints the one-line replay
  command; :func:`replay` re-runs exactly that schedule under a debugger.

Run the exploration tier from the CLI (this is what ``make race`` does)::

    python -m repro_torch.analysis.schedules --explore realbytes --seeds 20
        [--device cuda]
    python -m repro_torch.analysis.schedules --replay artifacts/schedule-....json
"""
from __future__ import annotations

import hashlib
import importlib
import json
import os
from typing import Callable

from repro_torch.analysis import racedep
from repro_torch.core import tracing

__all__ = ["explore", "replay", "ExplorationFailure", "ExplorationReport",
           "sim_fleet_scenario", "realbytes_fleet_scenario", "SCENARIOS"]


class ExplorationFailure(AssertionError):
    """A scenario broke an invariant under some seeded schedule. Carries
    the seed and the artifact path so harnesses can point straight at the
    reproduction."""

    def __init__(self, message: str, *, seed, artifact: str | None):
        super().__init__(message)
        self.seed = seed
        self.artifact = artifact


class ExplorationReport:
    """Outcome of a clean :func:`explore` run."""

    def __init__(self, scenario: str, seeds: list, accesses: int):
        self.scenario = scenario
        self.seeds = seeds
        self.accesses = accesses

    def __repr__(self):
        return (f"<ExplorationReport {self.scenario}: {len(self.seeds)} "
                f"schedules clean, {self.accesses} tracked accesses>")


def _scenario_path(fn: Callable) -> str:
    mod = fn.__module__
    if mod == "__main__" and fn.__name__ in globals():
        # `python -m repro_torch.analysis.schedules` defines this module as
        # __main__; record the importable name so --replay resolves it
        # from any process
        mod = "repro_torch.analysis.schedules"
    return f"{mod}:{fn.__qualname__}"


def _resolve(path: str) -> Callable:
    mod, _, name = path.partition(":")
    fn = importlib.import_module(mod)
    for part in name.split("."):
        fn = getattr(fn, part)
    return fn


def _digest(result) -> str:
    """Stable fingerprint of a scenario result for cross-seed comparison
    (dict of bytes → per-key sha256; anything else → repr hash)."""
    h = hashlib.sha256()
    if isinstance(result, dict):
        for k in sorted(result):
            v = result[k]
            h.update(str(k).encode())
            h.update(v if isinstance(v, (bytes, bytearray))
                     else repr(v).encode())
    else:
        h.update(repr(result).encode())
    return h.hexdigest()


def _dump_artifact(artifacts_dir: str, scenario: Callable, seed, sched,
                   error: str, tracer=None,
                   scenario_kw: dict | None = None) -> str:
    os.makedirs(artifacts_dir, exist_ok=True)
    name = scenario.__name__.replace("_", "-")
    path = os.path.join(artifacts_dir,
                        f"schedule-{name}-seed{seed}.json")
    trace = list(getattr(sched, "trace", None) or [])
    spath = _scenario_path(scenario)
    replay_cmd = (f"python -m repro_torch.analysis.schedules --replay {path}")
    with open(path, "w") as f:
        json.dump({
            "scenario": spath,
            "scenario_kw": scenario_kw or {},
            "seed": seed,
            "error": error,
            "events_fired": len(trace),
            "replay": replay_cmd,
            "trace": [[seq, t, fn] for seq, t, fn in trace],
            # the failing run's full span trees: which slide's journey
            # wedged, and at which hop, without re-running anything
            "spans": tracer.export() if tracer is not None else [],
        }, f, indent=1)
    print(f"schedule exploration FAILED (seed={seed}): {error}")
    print(f"artifact: {path}")
    print(f"replay:   {replay_cmd}")
    return path


def _run_one(scenario: Callable, seed, scenario_kw: dict | None = None):
    """One scenario run under one seed with racedep scoped around it.
    Returns (result, scheduler, violations)."""
    from repro_torch.core.clock import SimScheduler

    sched = SimScheduler(seed=seed, record_trace=True)
    with racedep.capture() as det, tracing.capture(now=sched.now):
        result = scenario(sched, **(scenario_kw or {}))
    return result, sched, det


def explore(scenario: Callable, seeds: int = 20, *,
            artifacts_dir: str = "artifacts",
            base_seed: int = 1,
            scenario_kw: dict | None = None) -> ExplorationReport:
    """Run ``scenario(sched, **scenario_kw)`` under the legacy FIFO
    schedule plus ``seeds`` seeded permutations, asserting on every run:

    * the scenario's internal invariants hold (scenarios ``assert`` that
      every slide settles exactly once, nothing dead-letters, …),
    * racedep records **zero** data races,
    * the result is byte-identical across all schedules.

    On the first violated invariant, dumps seed + schedule trace under
    ``artifacts_dir`` and raises :class:`ExplorationFailure` naming the
    one-line replay command. ``scenario_kw`` (for example the device of
    the real-bytes scenario) is recorded in the artifact for the replay.
    """
    from repro_torch.core.clock import SimScheduler

    scenario_kw = dict(scenario_kw or {})
    seed_list = [None] + [base_seed + i for i in range(seeds)]
    reference = None
    accesses = 0
    for seed in seed_list:
        sched = SimScheduler(seed=seed, record_trace=True)
        tracer = None
        try:
            # traced on the sim clock: a failure artifact carries the span
            # trees alongside the schedule trace
            with racedep.capture() as det, \
                    tracing.capture(now=sched.now) as tracer:
                result = scenario(sched, **scenario_kw)
            accesses += det.accesses
            if det.violations:
                raise AssertionError(
                    f"{len(det.violations)} data race(s): "
                    + "; ".join(str(v) for v in det.violations))
            digest = _digest(result)
            if reference is None:
                reference = digest
            elif digest != reference:
                raise AssertionError(
                    f"result diverged across schedules: digest {digest} "
                    f"!= reference {reference} (schedule-dependent bytes)")
        except Exception as e:  # noqa: BLE001 — every failure becomes a repro
            artifact = _dump_artifact(artifacts_dir, scenario, seed, sched,
                                      f"{type(e).__name__}: {e}", tracer,
                                      scenario_kw)
            raise ExplorationFailure(
                f"scenario {scenario.__name__!r} failed under seed {seed}: "
                f"{e}", seed=seed, artifact=artifact) from e
    return ExplorationReport(_scenario_path(scenario), seed_list, accesses)


def replay(artifact_path: str):
    """Re-run the exact schedule recorded in a failure artifact (same
    scenario, same seed — the seed fully determines the schedule) and
    return the scenario result. Raises whatever the original run raised."""
    with open(artifact_path) as f:
        art = json.load(f)
    scenario = _resolve(art["scenario"])
    result, sched, det = _run_one(scenario, art["seed"],
                                  art.get("scenario_kw", {}))
    if det.violations:
        raise AssertionError(
            f"{len(det.violations)} data race(s): "
            + "; ".join(str(v) for v in det.violations))
    return result


# --------------------------------------------------------------------------
# scenarios (module-level so artifacts can name them importably)
# --------------------------------------------------------------------------
def _pinned_convert(device: str = "cuda"):
    """Real WSI→DICOM conversion on ``device`` with UIDs pinned per slide
    id, so every schedule (and the serial baseline) mints byte-identical
    studies."""
    from repro_torch.wsi.convert import ConvertOptions, convert_wsi_to_dicom

    def uids(slide_id: str) -> list[str]:
        h = hashlib.sha256(slide_id.encode()).hexdigest()
        return ["2.25." + str(int(h[:24], 16)),
                "2.25." + str(int(h[24:48], 16))]

    def convert(data: bytes, meta: dict) -> bytes:
        opt = ConvertOptions(
            manifest={"uids": json.dumps(uids(meta["slide_id"]))},
            device=device)
        return convert_wsi_to_dicom(data, meta, options=opt)

    return convert


def _fleet_run(sched, slides: dict, meta: dict, convert,
               check_writes: bool = True, device: str = "cuda") -> dict:
    """Drive a faulted two-tenant fleet over ``slides`` on ``sched`` and
    assert the exactly-once invariants; returns {landing key: tar bytes}.
    The store's inference subscriber and export hop decode on ``device``."""
    from repro_torch.core import ConversionPipeline, DeliveryFaults
    from repro_torch.core.pipeline import derive_out_key

    # "s1." not "s1": the substring match must not alias s10/s11
    names = [k.rsplit("/", 1)[-1].split(".")[0] + "." for k in slides]
    faults = DeliveryFaults()
    if len(names) >= 3:
        faults = (DeliveryFaults()
                  .drop(names[0], attempts=(1,))
                  .duplicate(names[1], lag=1.0)
                  .delay(names[2], by=200.0))
    pipe = ConversionPipeline(
        sched, convert=convert, cold_start=10.0, max_instances=4,
        ack_deadline=120.0, min_backoff=5.0,
        fleet=dict(instance_queue_depth=2), ordered_ingest=True,
        store_shards=2, delivery_faults=faults, device=device)
    for k, d in slides.items():
        pipe.ingest(k, d, meta[k])
    sched.schedule(5.0, pipe.service.kill_instance)
    sched.run()

    # every slide settles exactly once: nothing dead-letters, one study
    # per slide, one store write per slide (a double conversion would
    # show up as an extra write even though re-STOW is idempotent)
    assert pipe.dead_lettered == [], \
        f"dead-lettered under exploration: {pipe.dead_lettered}"
    out_keys = pipe.dicom.list()
    assert len(out_keys) == len(slides), \
        f"{len(out_keys)} studies for {len(slides)} slides"
    if check_writes:
        writes = int(pipe.metrics.get("bucket.dicom-store.writes"))
        assert writes == len(slides), \
            f"{writes} writes for {len(slides)} slides (double convert?)"
    return {k: pipe.dicom.get(derive_out_key(k)).data for k in slides}


def sim_fleet_scenario(sched, device: str = "cuda") -> dict:
    """Fast exploration scenario: the full faulted fleet spine over tiny
    real slides with a stand-in converter — exercises every pub/sub,
    fleet, autoscaler, and store interleaving without real pixel work."""
    from repro_torch.wsi import SyntheticScanner

    def convert(data: bytes, meta: dict) -> bytes:
        return b"study:" + meta["slide_id"].encode() + b":" + \
            hashlib.sha256(data).digest()

    scanner = SyntheticScanner(seed=23)
    slides = {f"scans/s{i}.psv": scanner.scan(64, 64, 32)
              for i in range(12)}
    tenants = ("lab-a", "lab-b")
    meta = {k: {"slide_id": k, "tenant": tenants[i % 2]}
            for i, k in enumerate(slides)}
    return _fleet_run(sched, slides, meta, convert, device=device)


def realbytes_fleet_scenario(sched, device: str = "cuda",
                             tile: int = 256) -> dict:
    """The acceptance scenario: real synthetic slides (four 512² scans in
    ``tile``-px tiles) through the real converter on ``device`` under a
    faulted fleet. Checks byte-identity against a serial no-infrastructure
    baseline *within* the run; :func:`explore` additionally checks
    identity across schedules."""
    from repro_torch.wsi import SyntheticScanner
    from repro_torch.wsi.formats import sniff

    scanner = SyntheticScanner(seed=11)
    slides = {f"scans/s{i}.psv": scanner.scan(512, 512, tile)
              for i in range(4)}
    tenants = ("lab-a", "lab-b")
    meta = {k: {"slide_id": k, "tenant": tenants[i % 2]}
            for i, k in enumerate(slides)}
    convert = _pinned_convert(device)

    baseline = {}
    for k, d in slides.items():
        m = dict(meta[k])
        m.setdefault("format", sniff(d))
        baseline[k] = convert(d, m)

    tars = _fleet_run(sched, slides, meta, convert, device=device)
    for k in slides:
        assert tars[k] == baseline[k], \
            f"fleet study tar differs from serial baseline for {k}"
    return tars


SCENARIOS = {
    "sim": sim_fleet_scenario,
    "realbytes": realbytes_fleet_scenario,
}


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="seeded schedule exploration / replay")
    ap.add_argument("--explore", choices=sorted(SCENARIOS),
                    help="scenario to explore")
    ap.add_argument("--seeds", type=int, default=20)
    ap.add_argument("--artifacts", default="artifacts")
    ap.add_argument("--device", default="cuda",
                    help="where the real-bytes scenario converts and "
                         "decodes")
    ap.add_argument("--replay", metavar="ARTIFACT.json",
                    help="re-run the schedule recorded in a failure artifact")
    args = ap.parse_args(argv)
    if args.replay:
        replay(args.replay)
        print(f"replay of {args.replay}: scenario completed cleanly")
        return 0
    if not args.explore:
        ap.error("one of --explore/--replay is required")
    report = explore(SCENARIOS[args.explore], seeds=args.seeds,
                     artifacts_dir=args.artifacts,
                     scenario_kw={"device": args.device})
    print(f"{report!r}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
