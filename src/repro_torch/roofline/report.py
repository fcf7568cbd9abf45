"""The dry run's tables from its records, ``experiments/dryrun_torch/*.json``
(the port of ``repro.roofline.report``; the same tables, byte for byte, for
the same records).

    PYTHONPATH=src python -m repro_torch.roofline.report [--dir experiments/dryrun_torch]
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def fmt_s(x):
    return f"{x:.3g}s" if x is not None else "—"


def fmt_b(x):
    if x is None:
        return "—"
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(x) < 1024:
            return f"{x:.3g}{unit}"
        x /= 1024
    return f"{x:.3g}EB"


def load(directory):
    recs = []
    for p in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


SHAPE_ORDER = {"train_4k": 0, "prefill_32k": 1, "decode_32k": 2, "long_500k": 3}


def dryrun_table(recs) -> str:
    rows = [
        "| arch | shape | mesh | status | compile | HBM/chip (args+temps) "
        "| HLO collectives (full module) |",
        "|---|---|---|---|---|---|---|",
    ]
    for r in sorted(
        recs, key=lambda r: (r["arch"], SHAPE_ORDER.get(r["shape"], 9), r["mesh"])
    ):
        if r["status"] == "skip":
            rows.append(
                f"| {r['arch']} | {r['shape']} | {r['mesh']} "
                f"| SKIP ({r['reason'].split(':')[0]}) | — | — | — |"
            )
            continue
        if r["status"] != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | **FAIL** | — | — | — |")
            continue
        mem = r.get("memory_analysis", {})
        arg = mem.get("argument_size_in_bytes") or 0
        tmp = mem.get("temp_size_in_bytes") or 0
        coll = r.get("collectives", {}).get("count_by_kind", {})
        coll_s = " ".join(f"{k}×{v}" for k, v in sorted(coll.items()))
        rows.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | {r['compile_s']}s "
            f"| {fmt_b(arg + tmp)} | {coll_s} |"
        )
    return "\n".join(rows)


def roofline_table(recs) -> str:
    rows = [
        "| arch | shape | t_compute | t_memory | t_collective | bottleneck "
        "| MODEL/HLO flops | peak frac |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(
        recs, key=lambda r: (r["arch"], SHAPE_ORDER.get(r["shape"], 9))
    ):
        if r["status"] != "ok" or not r.get("roofline"):
            continue
        if r["mesh"] != "16x16":
            continue
        x = r["roofline"]
        rows.append(
            f"| {x['arch']} | {x['shape']} | {x['t_compute']:.4g} | {x['t_memory']:.4g} "
            f"| {x['t_collective']:.4g} | **{x['bottleneck']}** | {x['useful_ratio']:.2f} "
            f"| {x['peak_fraction']:.3f} |"
        )
    return "\n".join(rows)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default=os.path.join("experiments", "dryrun_torch"))
    ap.add_argument("--which", choices=["dryrun", "roofline", "both"], default="both")
    args = ap.parse_args()
    recs = load(args.dir)
    if args.which in ("dryrun", "both"):
        print("### Dry-run matrix\n")
        print(dryrun_table(recs))
        print()
    if args.which in ("roofline", "both"):
        print("### Roofline (single-pod 16x16, H100 constants, counted at full depth)\n")
        print(roofline_table(recs))


if __name__ == "__main__":
    main()
