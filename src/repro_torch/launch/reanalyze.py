"""Re-derive the roofline terms of saved dry-run cells from their op tables
(no new run) after a change to the card's figures or the traffic model.

    python -m repro_torch.launch.reanalyze [--dir artifacts/dryrun_torch]

Each ``ok`` cell's ``<cell>.ops.json.gz`` (``launch.dryrun``) gives its
FLOPs, those at the float32 rate and bytes (the op table's sums) and its collective bytes (by kind);
``derive_terms`` runs again on the H100's ``HW`` (to change a figure,
edit ``roofline.terms.HW`` and run this again). Cells without a saved op
table are listed for a new dry run.
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import sys
from pathlib import Path

__all__ = ["reanalyze", "main"]


def reanalyze(base: Path, hw=None) -> dict:
    """Update every ``ok`` cell record under ``base`` in place; returns
    ``{"updated": n, "missing": [cell, ...]}``."""
    from repro_torch.roofline import HW, derive_terms

    hw = hw or HW()
    missing, updated = [], 0
    for jf in sorted(Path(base).glob("*.json")):
        d = json.loads(jf.read_text())
        if not d.get("ok"):
            continue
        of = jf.with_name(jf.stem + ".ops.json.gz")
        if not of.exists():
            missing.append(jf.stem)
            continue
        with gzip.open(of, "rt") as f:
            table = json.load(f)
        flops = float(sum(row[1] for row in table["ops"].values()))
        nbytes = float(sum(row[2] for row in table["ops"].values()))
        f32 = float(sum(row[3] for row in table["ops"].values()))
        coll = float(sum(table["by_kind"].values()))
        terms = derive_terms(
            flops_per_device=flops, bytes_per_device=nbytes,
            collective_bytes_per_device=coll, chips=d["chips"],
            model_flops_total=d["model_flops"], f32_flops_per_device=f32,
            hw=hw)
        d.update(flops_per_device=flops, bytes_per_device=nbytes,
                 f32_flops_per_device=f32,
                 collectives={"total": coll, "by_kind": table["by_kind"]},
                 hw=dataclasses.asdict(hw),
                 **{k: v for k, v in terms.items() if k != "chips"})
        jf.write_text(json.dumps(d, indent=2, default=float))
        updated += 1
    return {"updated": updated, "missing": missing}


def main(argv: list[str] | None = None) -> int:
    from repro_torch.launch.dryrun import ARTIFACTS

    ap = argparse.ArgumentParser(prog="repro_torch.launch.reanalyze")
    ap.add_argument("--dir", default=None)
    args = ap.parse_args(argv)
    res = reanalyze(Path(args.dir) if args.dir else ARTIFACTS)
    print(f"updated {res['updated']} cells from saved op tables")
    if res["missing"]:
        print(f"{len(res['missing'])} cells lack a saved op table "
              "(run these again):")
        for m in res["missing"]:
            print("  ", m)
    return 0


if __name__ == "__main__":
    sys.exit(main())
