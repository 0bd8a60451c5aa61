"""Institutional-scale batch conversion on the PyTorch/CUDA port — the
paper's Figure 2/3 experiment, with a real event-driven multi-slide batch
up front.

    PYTHONPATH=src python examples/torch_institutional_batch.py
        [--images 50] [--real-slides 4] [--real-size 1024] [--tile 256]
        [--concurrency N] [--device cuda]

The port's ``examples/institutional_batch.py``. What it demonstrates, and
what to expect:

1. **Real mode** — ``--real-slides`` synthetic PSV slides are dropped into
   the landing bucket of a ``RealScheduler``-backed ``ConversionPipeline``;
   the event chain (object notification → pub/sub push → autoscaled
   wsi2dcm service) converts them with the pipelined engine on
   ``--device``, up to ``--concurrency`` in parallel per instance
   (default: cores // 2). Prints the batch wall time vs the serial-sync
   equivalent and verifies every study landed in the DICOM store.
   ``auto_export=True`` closes the retrieval loop: every stored instance
   triggers the dicom2tiff export hop, and the final printout reports the
   ``pipeline.export.*`` counters plus the derived-bucket tiled TIFFs.
2. **Paper scale** — the three workflows (serial, 16-way parallel VM pool,
   event-driven autoscaling) simulated at the paper's scale in the
   discrete-event simulator (``repro_torch.core.workflows``), beside a
   measured real conversion of a 256² slide on ``--device``, and the
   Figure-3 instance timeline for a 50-slide burst. Expect autoscaling to
   lose at n=1 (cold start) and win clearly by n≥10.

Everything runs on the card unless ``--device cpu`` is passed; without a
card the default fails rather than running on the CPU. On the CPU keep
tiles small (``--real-size 128 --tile 64``): the export hop's plain
entropy decode steps once per symbol of the longest tile.
"""
import argparse
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import ConversionPipeline, RealScheduler, tracing
from repro_torch.core.clock import monotonic
from repro_torch.core.dashboard import build_report
from repro_torch.core.workflows import (autoscaling_time, fig3_run,
                                        measure_service_time, parallel_time,
                                        serial_time)
from repro_torch.wsi import (ConvertOptions, SyntheticScanner,
                             convert_wsi_to_dicom, study_levels)
from repro_torch.wsi.jpeg import resolve_device


def run_real_batch(n: int, size: int, tile: int, concurrency: int,
                   device: str) -> None:
    """Push a real multi-slide batch through the event-driven wiring."""
    scanner = SyntheticScanner(seed=42)
    slides = {f"slides/batch{i:03d}.psv": scanner.scan(size, size, tile)
              for i in range(n)}

    def options(pipelined: bool) -> ConvertOptions:
        return ConvertOptions(pipelined=pipelined, device=device,
                              min_level_size=tile)

    def convert(data: bytes, meta: dict) -> bytes:
        return convert_wsi_to_dicom(data, meta, options=options(True))

    # warm the kernel builds so neither variant pays them
    first = next(iter(slides.values()))
    convert_wsi_to_dicom(first, options=options(False))
    convert_wsi_to_dicom(first, options=options(True))

    # serial-sync reference: the same slides, one at a time, no pipelining
    t0 = monotonic()
    for key, psv in slides.items():
        convert_wsi_to_dicom(psv, {"slide_id": key}, options=options(False))
    t_serial = monotonic() - t0

    # one instance, `concurrency` parallel conversions (instance scale-out
    # is what the paper-scale simulation below demonstrates)
    sched = RealScheduler(workers=max(8, 4 * concurrency))
    with tracing.capture(now=sched.now) as tracer:
        pipe = ConversionPipeline(
            sched, convert=convert, max_instances=1,
            concurrency=concurrency, cold_start=0.0, scale_down_delay=5.0,
            auto_export=True, device=device,
        )
        t0 = monotonic()
        pipe.run_batch(slides)
        t_batch = monotonic() - t0
        sched.run(until=30.0)  # store ingest + subscribers + export drain

    print(f"real event-driven batch on {device}: {n} × {size}² slides, "
          f"{tile}² tiles, concurrency={concurrency}")
    print(f"  serial sync loop : {t_serial:6.2f}s")
    print(f"  event-driven     : {t_batch:6.2f}s "
          f"({t_serial / t_batch:.2f}× vs serial sync)")
    for key in pipe.dicom.list():
        study = study_levels(pipe.dicom.get(key).data)
        n_dcm = sum(1 for k in study if k.endswith(".dcm"))
        print(f"  gs://dicom-store/{key}: {n_dcm} levels, "
              f"{len(pipe.dicom.get(key).data):,} bytes")
    studies = pipe.store_service.search_studies()
    if len(pipe.dicom.list()) != n or len(studies) != n:
        raise RuntimeError(f"{len(pipe.dicom.list())} study tars and "
                           f"{len(studies)} stored studies for {n} slides")
    print(f"  enterprise store: {len(studies)} studies, "
          f"{sum(pipe.store_service.study_summary(s)['n_instances'] for s in studies)} instances | "
          f"validated: {len(pipe.validator.checked)}, "
          f"ml-scored: {len(pipe.ml_subscriber.predictions)}")
    g = pipe.metrics.get
    print(f"  dicom2tiff export (auto, event-driven): "
          f"requests={g('pipeline.export.requests'):g}, "
          f"frames decoded={g('pipeline.export.frames_decoded'):g}, "
          f"bytes written={g('pipeline.export.bytes_written'):,.0f}, "
          f"dead-lettered={g('pipeline.export.dead_lettered'):g}")
    print(f"  gs://wsi-derived: {len(pipe.derived.list())} level TIFFs "
          f"across {len(studies)} studies")
    print(f"  cold starts: {pipe.service.cold_starts}, "
          f"acks: {g('sub.wsi2dcm-push.acks'):g}")
    # the dashboard's per-slide critical path: where each slide's
    # end-to-end time went (broker/queue vs conversion vs store I/O)
    report = build_report(pipe.metrics, tracer, title="real batch")
    lat = report["histograms"].get("sub.wsi2dcm-push.latency", {})
    if lat:
        print(f"  delivery latency: p50={lat['p50']:.2f}s "
              f"p95={lat['p95']:.2f}s p99={lat['p99']:.2f}s")
    for t in report["traces"]:
        a, dur = t["attribution"], max(t["duration"], 1e-9)
        print(f"  trace {t['slide']}: {t['duration']:.2f}s = "
              f"queue {100 * a['queue'] / dur:.0f}% + "
              f"compute {100 * a['compute'] / dur:.0f}% + "
              f"store {100 * a['store'] / dur:.0f}% "
              f"({t['n_spans']} spans, "
              f"{'OK' if not t['problems'] else t['problems']})")
    print()
    sched.shutdown()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--images", type=int, default=50,
                    help="batch size for the paper-scale simulation")
    ap.add_argument("--tau", type=float, default=90.0,
                    help="per-slide conversion seconds at paper scale")
    ap.add_argument("--real-slides", type=int, default=4,
                    help="slides in the real event-driven batch (0 skips)")
    ap.add_argument("--real-size", type=int, default=1024,
                    help="real slide edge length (pixels, multiple of "
                         "--tile)")
    ap.add_argument("--tile", type=int, default=256,
                    help="real slides' tile edge (pixels, multiple of 8)")
    ap.add_argument("--concurrency", type=int,
                    default=max(1, (os.cpu_count() or 2) // 2),
                    help="parallel conversions per instance in real mode")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = str(resolve_device(args.device))  # no card: raise, never the CPU

    if args.real_slides > 0:
        run_real_batch(args.real_slides, args.real_size, args.tile,
                       args.concurrency, dev)

    tau_m = measure_service_time(device=dev)
    print(f"measured per-slide conversion (256² synthetic, {dev}): "
          f"{tau_m:.3f}s")
    print(f"simulating at paper scale with tau={args.tau}s\n")

    print(f"{'n':>4} {'serial':>10} {'parallel16':>11} {'autoscaling':>12}")
    for n in (1, 10, 25, args.images):
        s = serial_time(n, args.tau)
        p = parallel_time(n, args.tau)
        a = autoscaling_time(n, args.tau)
        print(f"{n:>4} {s:>9.0f}s {p:>10.0f}s {a:>11.0f}s")

    print(f"\nFigure 3 — avg instances per minute ({args.images}-slide "
          "burst):")
    minutes, pipe = fig3_run(n=args.images, tau=args.tau)
    for m, v in minutes:
        print(f"  {m:3d}m | {'#' * int(v)} {v:.0f}")
    print(f"\ncold starts: {pipe.service.cold_starts}, "
          f"conversions: {pipe.done_count()}")
    print("institutional_batch OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
