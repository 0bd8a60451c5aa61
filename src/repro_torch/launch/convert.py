"""Conversion-service launcher: the paper's pipeline as a long-running worker.

    python -m repro_torch.launch.convert [--slides N] [--size PIXELS]
        [--max-instances K] [--hedge SECONDS] [--device cuda]

Stands up the full event chain (landing bucket → topic → push subscription →
autoscaled converters → DICOM store → validation and ML-inference
subscribers) on the real-threaded scheduler and pushes N synthetic
proprietary-format slides through it. The converter, the inference decode
and the export decode run on ``--device`` (``cuda`` by default; a missing
card raises). Prints ``N/N converted`` and the metric counters; exits 0
when every slide was converted.
"""
import argparse
import sys

from repro_torch.core.clock import wall_time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slides", type=int, default=3)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--max-instances", type=int, default=2)
    ap.add_argument("--hedge", type=float, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from repro_torch.core import ConversionPipeline, RealScheduler
    from repro_torch.wsi import (ConvertOptions, SyntheticScanner,
                                 convert_wsi_to_dicom)
    from repro_torch.wsi.jpeg import resolve_device

    device = str(resolve_device(args.device))  # a missing card raises here
    sched = RealScheduler(workers=max(args.max_instances * 2, 4))
    pipe = ConversionPipeline(
        sched,
        convert=lambda data, meta: convert_wsi_to_dicom(
            data, meta, ConvertOptions(device=device)),
        max_instances=args.max_instances, cold_start=0.0,
        hedge_after=args.hedge, scale_down_delay=2.0, device=device,
    )
    scanner = SyntheticScanner(seed=1)
    t0 = wall_time()
    for i in range(args.slides):
        pipe.ingest(f"slides/s{i:03d}.psv",
                    scanner.scan(args.size, args.size, 256),
                    {"slide_id": f"S{i:03d}"})
    sched.run(until=600.0)
    dt = wall_time() - t0
    ok = pipe.done_count() == args.slides
    print(f"{pipe.done_count()}/{args.slides} converted in {dt:.1f}s on "
          f"{device}; DICOM store: {pipe.dicom.list()}")
    for k, v in sorted(pipe.metrics.summary()["counters"].items()):
        print(f"  {k} = {v:g}")
    sched.shutdown()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
