#!/usr/bin/env python3
"""The fused epoch's ordered scatter, parent against change, on one NVIDIA GPU.

    python3 tools/scatter_ab.py --parent DIR [--epochs 6]

DIR is an unpacked tree of an earlier commit (``git archive``), under a
directory that ``.gitignore`` lists.  In one process each, in the order
parent, change, change, parent, the script runs the 100k-agent fused fleet
economy (``fleet_economy(100_000, 8, seed=0, warm_start=True,
fused=True)``) for ``--epochs`` epochs with each epoch's stages timed
between device synchronisations (that tree's ``chip_smoke.epoch_breakdown``:
prepare, pack, clock, settle, adopt, finalize), then times
``ordered_scatter_add`` at the pack's supply call with the index as that
tree's ``core/fused.py`` passes it (int64 before the on-card partition,
int32 since) through that tree's ``chip_smoke.graph_ms``.  Epoch 0 (842
rounds, the graphs' capture) is reported apart from the warm epochs.
Prints the card's ``name, power.limit`` and one JSON line of every run.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def child(tree: Path, epochs: int) -> dict:
    sys.path.insert(0, str(tree))
    sys.path.insert(0, str(tree / "src"))
    import torch

    import chip_smoke
    from repro_torch import core as pt
    from repro_torch.kernels import build, ops

    build.build_all()
    eco = pt.fleet_economy(100_000, 8, seed=0, warm_start=True, fused=True)
    parts = chip_smoke.epoch_breakdown(torch, eco)
    rounds = [int(eco.run_epoch().rounds) for _ in range(epochs)]
    b = eco._fused_fn._book
    flat_val = b["val"].reshape(-1)
    idx = b["idx"].reshape(-1)
    index = torch.where(flat_val != 0, idx if hasattr(ops, "scatter_plan") else idx.long(), -1)
    source = flat_val.abs()
    zeros = torch.zeros(eco._fused_fn.R, dtype=torch.float32, device=flat_val.device)
    supply_ms = chip_smoke.graph_ms(torch, lambda: ops.ordered_scatter_add(zeros, index, source))
    stages = {k.lstrip("_"): [t for t, _ in v] for k, v in parts.items() if k != "clock0"}
    return {"rounds": rounds, "stages_ms": stages, "supply_ms": supply_ms,
            "index_dtype": str(index.dtype).removeprefix("torch.")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="an unpacked tree of the parent commit")
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps(child(args.child.resolve(), args.epochs)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("scatter_ab: no CUDA device is visible", file=sys.stderr)
        return 2
    if args.parent is None:
        ap.error("--parent DIR is required")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    runs = []
    for label, tree in (("parent", args.parent), ("change", ROOT), ("change", ROOT),
                        ("parent", args.parent)):
        out = subprocess.run([sys.executable, __file__, "--child", str(tree), "--epochs",
                              str(args.epochs)], capture_output=True, text=True, check=True)
        run = json.loads(out.stdout.strip().splitlines()[-1])
        run["tree"] = label
        warm = {k: statistics.median(v[1:]) for k, v in run["stages_ms"].items() if len(v) > 1}
        print(f"{label}: rounds {run['rounds']}; warm epochs' median stage ms "
              + ", ".join(f"{k} {v:.3f}" for k, v in warm.items())
              + f"; supply call {run['supply_ms']:.4f} ms ({run['index_dtype']} index)",
              flush=True)
        runs.append(run)
    print(smi)
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
