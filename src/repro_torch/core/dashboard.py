"""The paper's "single dashboard": one report for a run's metrics + traces.

``build_report`` turns a :class:`~repro_torch.core.metrics.Metrics` bag and an
optional :class:`~repro_torch.core.tracing.Tracer` into one JSON-serializable
dict — counters, latency-histogram percentiles, fault/chaos tallies, and a
per-slide trace summary with **critical-path attribution**: how much of
each slide's end-to-end time was queue/transit, compute, or store I/O.
``render_text`` prints it for terminals; ``python -m repro_torch.core.dashboard
--smoke [--device cuda]`` runs a small instrumented real-conversion batch
on the card (faults + an instance kill included) and writes ``dashboard.json`` plus a sample trace
under ``--out`` — the CI artifact.

Attribution model
-----------------
Spans are categorized by name (``convert.*``/``*.handle`` → compute,
``stow.*``/``export.*``/``pipeline.store``/``pipeline.fetch`` → store,
``*.deliver``/``*.hedge``/``*.request`` → queue). The trace window [first
span start, last span end] is swept over the elementary intervals induced
by categorized span boundaries; each interval is attributed to the
*deepest* covering categorized span (a STOW span inside a service handler
counts as store, not compute), and intervals covered by nothing — retry
backoffs, requeue waits, broker scheduling — fall to queue. The three
buckets therefore sum to the trace duration *exactly*; the benchmark gate
only allows 5% slack for float accumulation.
"""
from __future__ import annotations

import argparse
import json
import os

__all__ = ["build_report", "render_text", "critical_path",
           "trace_summary", "trace_problems"]

_QUEUE_SUFFIXES = (".deliver", ".hedge", ".request")
_STORE_NAMES = ("pipeline.store", "pipeline.fetch")


def _category(name: str) -> str | None:
    if name.startswith("convert.") or name.endswith(".handle") \
            or name == "pipeline.convert":
        return "compute"
    if name.startswith(("stow.", "export.")) or name in _STORE_NAMES:
        return "store"
    if name.endswith(_QUEUE_SUFFIXES):
        return "queue"
    return None  # publish markers and other envelopes: no attribution


def _as_dicts(spans) -> list[dict]:
    return [s if isinstance(s, dict) else s.to_dict() for s in spans]


def _window(spans: list[dict]) -> tuple[float, float]:
    t0 = min(s["start"] for s in spans)
    t1 = max(s["end"] if s["end"] is not None else s["start"] for s in spans)
    return t0, t1


def _depths(spans: list[dict]) -> dict[str, int]:
    by_id = {s["span_id"]: s for s in spans}
    depth: dict[str, int] = {}

    def walk(sid: str) -> int:
        if sid in depth:
            return depth[sid]
        parent = by_id[sid]["parent_id"]
        d = 0 if parent is None or parent not in by_id else walk(parent) + 1
        depth[sid] = d
        return d

    for s in spans:
        walk(s["span_id"])
    return depth


def critical_path(spans) -> dict[str, float]:
    """Queue/compute/store attribution for ONE trace's spans; the buckets
    sum to the trace window exactly (uncovered time → queue)."""
    spans = _as_dicts(spans)
    if not spans:
        return {"queue": 0.0, "compute": 0.0, "store": 0.0}
    t0, t1 = _window(spans)
    depth = _depths(spans)
    cat: list[tuple[float, float, int, str]] = []
    for s in spans:
        c = _category(s["name"])
        if c is None:
            continue
        end = s["end"] if s["end"] is not None else t1
        lo, hi = max(s["start"], t0), min(end, t1)
        if hi > lo:
            cat.append((lo, hi, depth[s["span_id"]], c))
    out = {"queue": 0.0, "compute": 0.0, "store": 0.0}
    bounds = sorted({t0, t1, *(b for lo, hi, _, _ in cat for b in (lo, hi))})
    for lo, hi in zip(bounds, bounds[1:]):
        covering = [(d, c) for slo, shi, d, c in cat
                    if slo <= lo and shi >= hi]
        # deepest categorized span wins; gaps (backoffs, broker
        # scheduling) are wait time
        out[max(covering)[1] if covering else "queue"] += hi - lo
    return out


def trace_problems(spans) -> list[str]:
    """Span-tree integrity check for one trace: exactly one root, every
    parent resolves inside the trace. Empty list == healthy."""
    spans = _as_dicts(spans)
    problems = []
    roots = [s for s in spans if s["parent_id"] is None]
    if len(roots) != 1:
        problems.append(f"{len(roots)} roots (want exactly 1): "
                        f"{[s['name'] for s in roots]}")
    ids = {s["span_id"] for s in spans}
    for s in spans:
        if s["parent_id"] is not None and s["parent_id"] not in ids:
            problems.append(
                f"orphan span {s['name']} ({s['span_id']}): parent "
                f"{s['parent_id']} not in trace")
    return problems


def trace_summary(trace_id: str, spans) -> dict:
    spans = _as_dicts(spans)
    t0, t1 = _window(spans)
    roots = [s for s in spans if s["parent_id"] is None]
    slide = roots[0]["attrs"].get("object") if roots else None
    return {
        "trace_id": trace_id,
        "slide": slide,
        "duration": t1 - t0,
        "n_spans": len(spans),
        "n_events": sum(len(s["events"]) for s in spans),
        "attribution": critical_path(spans),
        "problems": trace_problems(spans),
    }


def _fault_counters(counters: dict) -> dict:
    keep = ("fault_", ".killed", ".requeued", ".requeues", ".shed",
            ".dead_lettered", ".deadline_expired", ".hedged",
            ".duplicates")
    return {k: v for k, v in sorted(counters.items())
            if any(t in k for t in keep) and v}


def build_report(metrics, tracer=None, *, title: str = "run") -> dict:
    summary = metrics.summary()
    report = {
        "title": title,
        "counters": dict(sorted(summary["counters"].items())),
        "histograms": dict(sorted(summary["histograms"].items())),
        "faults": _fault_counters(summary["counters"]),
    }
    if tracer is not None:
        report["traces"] = [trace_summary(tid, spans)
                            for tid, spans in sorted(tracer.traces().items())]
    return report


def _fmt_s(v: float) -> str:
    return f"{v:.3f}s" if v < 100 else f"{v:.1f}s"


def render_text(report: dict) -> str:
    lines = [f"== dashboard: {report['title']} =="]
    hists = report.get("histograms") or {}
    if hists:
        lines.append("-- latency histograms --")
        w = max(len(k) for k in hists)
        for k, h in hists.items():
            lines.append(
                f"  {k:<{w}}  n={h['count']:<6d} p50={_fmt_s(h['p50'])} "
                f"p95={_fmt_s(h['p95'])} p99={_fmt_s(h['p99'])} "
                f"max={_fmt_s(h['max'])}")
    traces = report.get("traces")
    if traces:
        lines.append("-- per-slide critical path (queue / compute / store) --")
        for t in traces:
            a, dur = t["attribution"], t["duration"]
            def pct(x):
                return f"{100.0 * x / dur:.0f}%" if dur else "-"
            lines.append(
                f"  {t['slide'] or t['trace_id']:<24} "
                f"total={_fmt_s(dur)}  "
                f"queue={_fmt_s(a['queue'])} ({pct(a['queue'])})  "
                f"compute={_fmt_s(a['compute'])} ({pct(a['compute'])})  "
                f"store={_fmt_s(a['store'])} ({pct(a['store'])})  "
                f"spans={t['n_spans']}")
            for p in t["problems"]:
                lines.append(f"    !! {p}")
    faults = report.get("faults") or {}
    if faults:
        lines.append("-- injected chaos / failure handling --")
        w = max(len(k) for k in faults)
        for k, v in faults.items():
            lines.append(f"  {k:<{w}}  {v:g}")
    counters = report.get("counters") or {}
    lines.append(f"-- counters ({len(counters)}) --")
    w = max((len(k) for k in counters), default=0)
    for k, v in counters.items():
        lines.append(f"  {k:<{w}}  {v:g}")
    return "\n".join(lines)


# ---- the instrumented smoke batch (CI artifact) ---------------------------
def _smoke(out_dir: str, n_slides: int, side: int, device: str) -> dict:
    # lazy imports: simulation-only users of repro_torch.core never pay for torch
    import hashlib

    from repro_torch.core import tracing
    from repro_torch.core.clock import RealScheduler
    from repro_torch.core.pipeline import ConversionPipeline
    from repro_torch.core.pubsub import DeliveryFaults
    from repro_torch.wsi import SyntheticScanner
    from repro_torch.wsi.convert import ConvertOptions, convert_wsi_to_dicom

    def convert(data, meta):
        h = hashlib.sha256(meta["slide_id"].encode()).hexdigest()
        uids = ["2.25." + str(int(h[:24], 16)),
                "2.25." + str(int(h[24:48], 16))]
        opt = ConvertOptions(manifest={"uids": json.dumps(uids)},
                             device=device)
        return convert_wsi_to_dicom(data, meta, options=opt)

    scanner = SyntheticScanner(seed=7)
    slides = {f"scans/s{i}.psv": scanner.scan(side, side, 256)
              for i in range(n_slides)}
    meta = {k: {"slide_id": k} for k in slides}
    # real-execution chaos: a dropped first delivery (redelivers on ack
    # deadline) plus a duplicated one (dedupes at fleet admission)
    faults = (DeliveryFaults()
              .drop("s0", attempts=(1,))
              .duplicate("s1", lag=0.1))
    sched = RealScheduler()
    try:
        with tracing.capture(now=sched.now) as tracer:
            pipe = ConversionPipeline(
                sched, convert=convert, cold_start=0.05, max_instances=4,
                ack_deadline=3.0, min_backoff=0.2, fleet={},
                ordered_ingest=True, store_shards=2, auto_export=True,
                delivery_faults=faults, device=device)
            sched.schedule(0.2, pipe.service.kill_instance)
            pipe.run_batch(slides, meta, timeout=180.0)
            sched.run(until=60.0)  # drain the store/validate/export fan-out
    finally:
        sched.shutdown()

    report = build_report(pipe.metrics, tracer, title="smoke batch")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "dashboard.json"), "w") as f:
        json.dump(report, f, indent=2, sort_keys=True)
    # sample trace: the full span tree of the first slide's journey
    first = sorted(tracer.traces().items())[0]
    with open(os.path.join(out_dir, "trace-sample.json"), "w") as f:
        json.dump({"trace_id": first[0],
                   "spans": [s.to_dict() for s in first[1]]},
                  f, indent=2, sort_keys=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="run the instrumented smoke batch")
    ap.add_argument("--out", default="artifacts",
                    help="artifact directory (dashboard.json, "
                         "trace-sample.json)")
    ap.add_argument("--slides", type=int, default=2)
    ap.add_argument("--side", type=int, default=256)
    ap.add_argument("--device", default="cuda",
                    help="where the converter and the read side run")
    args = ap.parse_args(argv)
    if not args.smoke:
        ap.error("nothing to do (pass --smoke)")
    report = _smoke(args.out, args.slides, args.side, args.device)
    print(render_text(report))
    problems = [p for t in report["traces"] for p in t["problems"]]
    if problems:
        print(f"TRACE INTEGRITY FAILED: {problems}")
        return 1
    print(f"\nwrote {args.out}/dashboard.json and "
          f"{args.out}/trace-sample.json")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
