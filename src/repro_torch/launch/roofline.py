"""Roofline report of the port's dry-run: reads
``results/dryrun_torch/<mesh>/*.json`` (:mod:`repro_torch.launch.dryrun`)
and prints, a cell a row, the three terms, the bottleneck, the model's
share of the cluster's flops and the roofline fraction, each against the
peak stored in the record (the card it names), with the line of what
would move it.

Usage: PYTHONPATH=src python -m repro_torch.launch.roofline [--mesh 16x16] [--md] [--dir DIR]
"""

from __future__ import annotations

import argparse
import glob
import json
import os

RESULTS_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                           "results", "dryrun_torch")

MOVE_HINTS = {
    "compute": "more useful-FLOP fraction: tensor-parallel compute over 'model' "
               "(replicated in the port), cut remat recompute / capacity padding",
    "memory": "fuse the eager elementwise passes; larger microbatch per device; "
              "bf16 master",
    "collective": "shard the compute instead of gathering the weights each step; "
                  "overlap the gathers; int8-compress cross-pod grads",
}


def load_records(mesh: str, root: str = RESULTS_DIR) -> list[dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(root, mesh, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if "error" not in rec:
            rec["_file"] = os.path.basename(path)
            out.append(rec)
    return out


def roofline_fraction(rec: dict) -> float:
    """Useful-compute fraction of the bound step time: how close the cell is
    to its compute roofline = model_flops / (chips * peak * bound_time),
    with the record's own peak."""
    bound = max(rec["t_compute_s"], rec["t_memory_s"], rec["t_collective_s"])
    if bound <= 0:
        return 0.0
    ideal = rec["model_flops"] / rec["chips"] / rec["peak_flops"]
    return ideal / bound


def fmt_row(rec: dict) -> dict:
    return {
        "arch": rec["arch"], "shape": rec["shape"], "tag": rec.get("tag", ""),
        "t_compute_s": round(rec["t_compute_s"], 5),
        "t_memory_s": round(rec["t_memory_s"], 5),
        "t_collective_s": round(rec["t_collective_s"], 5),
        "bottleneck": rec["bottleneck"],
        "useful_ratio": round(rec.get("useful_ratio", 0), 4),
        "roofline_frac": round(roofline_fraction(rec), 5),
        "device": rec["device"],
        "move": MOVE_HINTS[rec["bottleneck"]],
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--md", action="store_true")
    ap.add_argument("--dir", default=RESULTS_DIR,
                    help="directory of the dry-run's records")
    args = ap.parse_args(argv)
    rows = [fmt_row(r) for r in load_records(args.mesh, args.dir)
            if not r.get("tag")]
    rows.sort(key=lambda r: (r["arch"], r["shape"]))
    if args.md:
        devices = sorted({r["device"] for r in rows})
        print(f"Roofline terms against {', '.join(devices) or 'no records'}")
        print()
        print("| arch | shape | compute (s) | memory (s) | collective (s) | "
              "bottleneck | MODEL/HLO | roofline frac |")
        print("|---|---|---|---|---|---|---|---|")
        for r in rows:
            print(f"| {r['arch']} | {r['shape']} | {r['t_compute_s']} | "
                  f"{r['t_memory_s']} | {r['t_collective_s']} | "
                  f"{r['bottleneck']} | {r['useful_ratio']} | "
                  f"{r['roofline_frac']} |")
    else:
        for r in rows:
            print(",".join(str(r[k]) for k in
                           ("arch", "shape", "t_compute_s", "t_memory_s",
                            "t_collective_s", "bottleneck", "useful_ratio",
                            "roofline_frac")))


if __name__ == "__main__":
    main()
