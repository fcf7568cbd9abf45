"""Readings of the output check on the program and on its control.

    python market_bench/control.py --workload fleet-8c-100k.steady \
        --seeds 11,12,13 --seconds 5

For each seed: the cell's program at its own size through set-up and a
short window, then the check's numbers twice: the program against the
plain reference in float32 (the sound readings, which set each limit's
lower end), and the reference in bfloat16, the precision below the
deployment's, in the program's place (the control, which sets the upper
end).  One JSON line a seed.  Needs the cell's CUDA device, as ``run.py``.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch

    from market_bench import harness

    if not torch.cuda.is_available():
        print("market_bench.control: needs a CUDA device", file=sys.stderr)
        return 3
    device = torch.device("cuda", 0)
    _, cell, cfg, params = harness.cell_spec(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory() as tmp:
            sut = harness.driven(cfg, params, seed, device, tmp, args.seconds)[0]
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            sound = sut.check(device)
            t1 = time.perf_counter()
            control = sut.check(device, torch.bfloat16)
            t2 = time.perf_counter()
        print(json.dumps({"workload": args.workload, "seed": seed, "sound": sound,
                          "control": control, "check_s": t1 - t0, "control_s": t2 - t1}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
