#!/usr/bin/env python3
"""Where ``ordered_scatter_add`` spends its time, on one NVIDIA GPU.

    python3 tools/scatter_split.py

Builds two cut copies of ``csrc/ordered_scatter.cu`` with ``nvcc`` (the
port's flags, in parallel), whose partition stops after one of its passes:

    count       the count pass only (per-warp counts and compaction)
    count_scan  the count pass and the scan

and times, with ``chip_smoke.graph_ms``, the partition of each copy, the
partition and the fold of the kernel as built (``ordered_scatter_partition``
and ``ordered_scatter_fold``) and the whole call, at the fused economy's
supply call (``fleet_economy(100_000, 8, seed=0, warm_start=False,
fused=True)``: 4,800,576 rows into 24, float32, its int32 index) with the
book of epoch 0 and of epoch 2 (the book ``chip_smoke.py`` times), the
100,000 placed rows into 8 after epoch 2 (float64 rows of 3) and
``chip_smoke.scatter_edges``.  Successive differences are the passes'
shares (launch included).  Each call is held bit for bit against the plain
version first.  Prints the card's ``name, power.limit`` and one JSON line
of all times (ms), with each call's kept rows and longest chain.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

SCAN = "  scan_kernel<<<1, kScanThreads, 0, c.stream>>>("
PLACE = "  if (c.source64)\n"


def cut_sources() -> dict[str, str]:
    src = (ROOT / "src/repro_torch/kernels/csrc/ordered_scatter.cu").read_text()
    for marker in (SCAN, PLACE):
        if src.count(marker) != 1:
            raise RuntimeError(f"ordered_scatter.cu: {marker!r} found {src.count(marker)} times")
    return {"count": src.replace(SCAN, "  return 0;\n" + SCAN),
            "count_scan": src.replace(PLACE, "  return 0;\n" + PLACE)}


def build_cuts(out_dir: Path, sig) -> dict:
    from repro_torch.kernels import build

    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, src in cut_sources().items():
        (out_dir / f"{name}.cu").write_text(src)
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(out_dir / f"lib{name}.so"),
             str(out_dir / f"{name}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
    fns = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the {name} cut:\n{out}")
        f = ctypes.CDLL(str(out_dir / f"lib{name}.so")).ordered_scatter_partition
        f.restype, f.argtypes = ctypes.c_int, sig
        fns[name] = f
    return fns


def split(torch, ops, halves, cuts, out, index, source) -> dict:
    want = ops.ordered_scatter_add(out.clone(), index, source, plain=True)
    got = ops.ordered_scatter_add(out.clone(), index, source)
    chip_smoke.check(chip_smoke.same_bits(torch, got, want), "differs from the plain version")
    n = out.shape[0]
    keep = (index >= 0) & (index < n)
    times = {"kept": int(keep.sum()),
             "longest_chain": int(torch.bincount(index[keep].long(), minlength=n).max())}
    buf = out.clone()
    args, held = ops.scatter_args(buf, index, source)

    def call(f):
        err = f(*args[:-1], torch.cuda.current_stream().cuda_stream)
        chip_smoke.check(err == 0, f"cudaError {err}")

    times.update({name: chip_smoke.graph_ms(torch, lambda f=f: call(f))
                  for name, f in cuts.items()})
    times["partition"] = chip_smoke.graph_ms(torch, lambda: call(halves["partition"]))
    call(halves["partition"])
    times["fold"] = chip_smoke.graph_ms(torch, lambda: call(halves["fold"]))
    times["whole"] = chip_smoke.graph_ms(torch, lambda: ops.ordered_scatter_add(buf, index, source))
    return times


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("scatter_split: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch import core as pt
    from repro_torch.kernels import build, ops

    build.build_all()
    sig = ops._SIGNATURES[("ordered_scatter", "ordered_scatter_add")]
    cuts = build_cuts(ROOT / "build" / "scatter_split", sig)
    halves = chip_smoke.scatter_halves(ops)
    dev = torch.device("cuda")
    eco = pt.fleet_economy(100_000, 8, seed=0, warm_start=False, fused=True)
    streams = {}
    for epoch in range(3):
        eco.run_epoch()
        if epoch in (0, 2):
            b = eco._fused_fn._book
            flat_val = b["val"].reshape(-1)
            streams[f"supply, epoch {epoch}'s book"] = (
                torch.zeros(eco._fused_fn.R, device=dev),
                torch.where(flat_val != 0, b["idx"].reshape(-1), -1), flat_val.abs())
    streams["usage, 100,000 placed rows"] = (
        torch.from_numpy(eco.usage).to(dev),
        torch.from_numpy(np.where(eco.pop.placed >= 0, eco.pop.placed, eco.C)).to(dev),
        -torch.from_numpy(eco.pop.req).to(dev))
    for label, *stream in chip_smoke.scatter_edges(torch, dev):
        streams[f"edge: {label}"] = tuple(stream)
    result = {}
    for label, stream in streams.items():
        result[label] = split(torch, ops, halves, cuts, *stream)
        print(f"{label}: " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                                       for k, v in result[label].items()), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
