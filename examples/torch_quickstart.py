"""Quickstart on the PyTorch/CUDA port: a mixed-format batch through the
event-driven pipeline.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda]
        [--size 512] [--tile 256]

The port's ``examples/quickstart.py``. Scans one synthetic slide and
drops it in the landing bucket **twice** — as the scanner's proprietary
PSV container and as an SVS-shaped tiled TIFF — then lets the event chain
do the rest: object-creation notification → pub/sub topic → push
subscription → autoscaled converter (which sniffs each container by magic
bytes and runs the pipelined transform on ``--device`` + host Huffman
engine) → DICOM-store bucket → store ingest → enterprise DICOM store →
validation + ML-inference subscribers. Then reads the DICOM studies back,
verifies them, and drives the export hop: one study is re-materialized as
a tiled-TIFF pyramid in the derived bucket (batched inverse JPEG path)
and reopened through the sniffer.

Everything runs on the card unless ``--device cpu`` is passed; without a
card the default fails rather than running on the CPU. On the CPU the
plain entropy decode steps once per symbol of the longest tile, so keep
tiles small there (``--size 128 --tile 64``).

Expected output: both container byte counts, two converted studies in the
DICOM store (one .dcm per pyramid level — a 512² slide of 256² tiles
yields 2 levels), each level's dimensions/frame count/transfer syntax, a
level-0 PSNR in the 30–40 dB range against the scanner's pixels, the
enterprise store's QIDO view of the studies with the validation verdicts
and the mock ML model's decoded per-frame pixel stats (fetched via indexed
frame-level WADO), the exported level TIFFs, the single dashboard
(latency-histogram percentiles, each slide's end-to-end trace with its
queue/compute/store critical-path split, the metric counters), the
kernel launches this process made — then a final "quickstart OK".
"""
import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core import ConversionPipeline, RealScheduler, tracing
from repro_torch.core.dashboard import build_report, render_text
from repro_torch.kernels import ops
from repro_torch.wsi import (ConvertOptions, PSVReader, SyntheticScanner,
                             convert_wsi_to_dicom, decode_tile, open_slide,
                             psnr, read_part10, study_levels)
from repro_torch.wsi.jpeg import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--size", type=int, default=512,
                    help="slide edge in pixels (a multiple of --tile)")
    ap.add_argument("--tile", type=int, default=256,
                    help="tile edge in pixels (a multiple of 8)")
    args = ap.parse_args(argv)
    dev = str(resolve_device(args.device))  # no card: raise, never the CPU
    size, tile = args.size, args.tile

    n_tiles = (size // tile) ** 2
    print(f"== scanner: one {size}x{size} slide ({n_tiles} tiles), "
          "two containers ==")
    scanner = SyntheticScanner(seed=7)
    psv = scanner.scan(size, size, tile)
    tif = scanner.scan_tiff(size, size, tile)
    print(f"   PSV container:        {len(psv):,} bytes")
    print(f"   tiled-TIFF container: {len(tif):,} bytes")

    print(f"== pipeline on {dev}: mixed landing bucket → pub/sub → "
          "sniffing converter ==")
    sched = RealScheduler(workers=2)
    # arm the distributed tracer: every hop below lands in one span tree
    # per slide, rendered by the dashboard at the end
    tracer = tracing.arm(now=sched.now)
    pipe = ConversionPipeline(
        sched, convert=lambda data, meta: convert_wsi_to_dicom(
            data, meta, options=ConvertOptions(device=dev,
                                               min_level_size=tile)),
        max_instances=2, cold_start=0.0, scale_down_delay=2.0, device=dev,
    )
    pipe.ingest("slides/quickstart.psv", psv, {"slide_id": "QS-1"})
    pipe.ingest("slides/quickstart-tiff.svs", tif, {"slide_id": "QS-2"})
    sched.run(until=300.0)
    if pipe.done_count() != 2:
        raise RuntimeError("conversions did not finish")

    print("== DICOM store contents ==")
    for key in pipe.dicom.list():
        obj = pipe.dicom.get(key)
        print(f"   gs://dicom-store/{key}  {len(obj.data):,} bytes")

    study = study_levels(pipe.dicom.get("slides/quickstart.dcm").data)
    for name in sorted(study):
        if not name.endswith(".dcm"):
            continue
        ds, frames = read_part10(study[name])
        print(f"   {name}: {ds.get_int(0x0048, 0x0007)}x"
              f"{ds.get_int(0x0048, 0x0006)} total, "
              f"{ds.get_int(0x0028, 0x0008)} frames, "
              f"ts={ds.get_str(0x0002, 0x0010)}")

    ds, frames = read_part10(study["level_0.dcm"])
    tile0 = PSVReader(psv).read_tile(0, 0)
    rec = decode_tile(bytes(frames[0]).rstrip(b"\x00") or frames[0],
                      device=dev)
    print(f"== fidelity: level-0 frame-0 PSNR vs scanner output: "
          f"{psnr(tile0, rec):.1f} dB ==")

    print("== enterprise DICOM store (QIDO) + subscribers ==")
    svc = pipe.store_service
    for study_uid in svc.search_studies(modality="SM"):
        s = svc.study_summary(study_uid)
        print(f"   study {study_uid[:24]}…: {s['n_series']} series, "
              f"{s['n_instances']} instances, {s['total_frames']} frames")
    print(f"   validation: {len(pipe.validator.checked)} passed, "
          f"{len(pipe.validator.quarantined)} quarantined")
    for sop, pred in sorted(pipe.ml_subscriber.predictions.items()):
        feats = ", ".join(f"{st['mean']:.1f}±{st['std']:.0f}"
                          for st in pred["pixel_stats"])
        print(f"   ml-inference {sop[-12:]}: {pred['frames_scored']} "
              f"frames decoded via WADO, pixel mean±std [{feats}]")

    print("== export hop: study → derived tiled-TIFF pyramid ==")
    export_study = svc.search_studies()[0]
    pipe.request_export(export_study)
    sched.run(until=60.0)
    for key in pipe.derived.list():
        rd = open_slide(pipe.derived.get(key).data)
        print(f"   gs://wsi-derived/{key[-18:]}: {rd.H}x{rd.W} "
              f"{type(rd).__name__} (level {rd.metadata['level']}) — "
              "reopens via the sniffer")

    print("== the single dashboard: histograms, traces, counters ==")
    tracing.disarm()
    print(render_text(build_report(pipe.metrics, tracer,
                                   title="quickstart")))
    sched.shutdown()
    # a kernel launch is counted only on the card: zeros on the CPU
    print("kernel launches: " + json.dumps(ops.launch_counts()))
    print("quickstart OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
