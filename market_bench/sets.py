"""Sets of runs of one cell and the spreads its bounds are set from.

    python3 market_bench/sets.py --workload fleet-8c-100k.steady \
        --seeds 11,12,13,14,15,16 --sets 2 --traced 17,18,19 --seconds 45 \
        --out chiprun_out/sets/steady

Runs ``run.py`` once a seed, one process after another: ``--sets`` sets of
the same ``--seeds``, then ``--trace 1`` on each of ``--traced``.  Keeps
each run's standard output and error under ``--out`` and prints one JSON
line: the card's name and power limit, each run's result, and for each
end-to-end metric and set its values, median and spread (the distance
between the first and the third quartile of ``statistics.quantiles(n=4)``
over the median), the spread with the run farthest from the median left
out, and five times the widest spread, which is where a bound goes.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def spread(values: list[float]) -> float | None:
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def trimmed(values: list[float]) -> list[float]:
    """``values`` less the one farthest from their median."""
    if len(values) < 3:
        return values
    med = statistics.median(values)
    far = max(range(len(values)), key=lambda i: abs(values[i] - med))
    return values[:far] + values[far + 1:]


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def one(workload: str, seed: int, seconds: float, traced: bool, out: Path, tag: str) -> dict:
    cmd = [sys.executable, str(ROOT / "market_bench" / "run.py"), "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(int(traced))]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, timeout=1200)
    wall = time.perf_counter() - t0
    (out / f"{tag}.out").write_text(res.stdout)
    (out / f"{tag}.err").write_text(res.stderr)
    lines = res.stdout.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if res.returncode == 0 and lines else None
    except json.JSONDecodeError:
        result = None
    return {"tag": tag, "seed": seed, "traced": traced, "rc": res.returncode, "wall_s": wall,
            "result": result}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="", help="comma-separated, one run a seed a set")
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--traced", default="", help="comma-separated seeds run with --trace 1")
    ap.add_argument("--seconds", type=float, default=45)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    runs = []
    for k in range(args.sets if seeds else 0):
        for seed in seeds:
            runs.append(one(args.workload, seed, args.seconds, False, out, f"{'AB'[k % 2]}{k}_{seed}"))
    for seed in (int(s) for s in args.traced.split(",") if s):
        runs.append(one(args.workload, seed, args.seconds, True, out, f"T_{seed}"))

    summary: dict = {}
    for k in range(args.sets if seeds else 0):
        rows = [r["result"] for r in runs[k * len(seeds):(k + 1) * len(seeds)] if r["result"]]
        for name in (rows[0]["metrics"] if rows else {}):
            vals = [r["metrics"][name]["value"] for r in rows if name in r["metrics"]]
            summary.setdefault(name, []).append({
                "values": vals, "median": statistics.median(vals), "spread": spread(vals),
                "spread_trimmed": spread(trimmed(vals))})
    for name, sets in summary.items():
        widest = max((s["spread"] for s in sets if s["spread"] is not None), default=None)
        sets.append({"five_times_widest": None if widest is None else 5 * widest})
    print(json.dumps({
        "workload": args.workload, "card": card(),
        "runs": [{"tag": r["tag"], "seed": r["seed"], "rc": r["rc"], "wall_s": r["wall_s"],
                  "correct": r["result"] and r["result"]["correct"],
                  "metrics": r["result"] and {k: v["value"] for k, v in
                                              r["result"]["metrics"].items()},
                  "peak": r["result"] and r["result"]["device"]["memory_peak_bytes"],
                  "busy": r["result"] and [r["result"]["device"].get("busy_s"),
                                           r["result"]["device"].get("window_s")],
                  "window": r["result"] and r["result"]["readings"].get("window"),
                  "bytes_written": r["result"] and r["result"]["readings"].get("bytes_written")}
                 for r in runs],
        "spreads": summary}), flush=True)
    return 0 if all(r["result"] and r["result"]["correct"] for r in runs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
