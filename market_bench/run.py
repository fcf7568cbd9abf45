"""Run one cell of the market benchmark and print its result line.

    python market_bench/run.py --workload fleet-8c-100k.steady --seed 7 \
        --seconds 30 --trace 0

Runs from the root of a checkout on a machine with the cell's cards; the
program is the ``repro_torch`` package under ``src/``.  The last line of
standard output is the result as one JSON object; the numbers the output
check compared, each beside its limit, are the last lines of standard
error.  Exits non-zero, printing no result, without enough CUDA devices,
without the program, or if JAX or the JAX package got loaded.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        print("market_bench: the program (src/repro_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    # one process with few threads: the program's host work is numpy and
    # Python, and idle pool threads only take cores from it
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    # kernel caches at fixed places inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(ROOT / "build" / "cache" / sub))

    import torch

    from market_bench import harness

    bench, cell, _, _ = harness.cell_spec(args.workload, ROOT)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"market_bench: {args.workload} needs {cell['chips']} CUDA device(s)",
              file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), device, T0, ROOT)
    bad = harness.forbidden_modules()
    if bad:
        print(f"market_bench: loaded {', '.join(bad)}", file=sys.stderr)
        return 4
    sys.stdout.write(json.dumps(out) + "\n")
    sys.stdout.flush()
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
