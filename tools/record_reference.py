#!/usr/bin/env python3
"""Record the JAX reference's fleet economy, staged and fused, bit for bit.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/record_reference.py \
        [--agents 100000] [--clusters 8] [--seed 0] [--epochs 3] [--out PATH]

Runs ``repro.core.markets.fleet_economy(agents, clusters, seed=seed)`` for
``epochs`` binding epochs warm-started and as many with cold restarts, on
the staged path and with ``fused=True``, and writes what a run must repeat
bit for bit: each epoch's float32 prices and its reserve curve as hex bytes,
rounds, migrations, ``converged``, ``system_ok`` and the sha256 of the
population's ``placed`` after the epoch.  ``chip_smoke.py`` holds the
port's runs on the card against the file (``fleet_100k_reference.json``
here, for the defaults), and ``tests/test_torch_fused.py`` holds a small
recording against the port on the CPU.  About a minute for 100k agents.

This script imports JAX; the port never does.  JAX 0.9.0 removed
``jax.experimental.enable_x64``, which the reference's fused epoch calls,
and kept ``jax.enable_x64``: the script binds the one to the other before
it builds an economy.  Nothing under ``src/repro`` changes.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_OUT = ROOT / "tools" / "fleet_100k_reference.json"
RESTARTS = {"warm-started": True, "cold restarts": False}


def epoch_record(stats, eco) -> dict:
    """The bitwise fields of one epoch: EpochStats and the economy after it."""
    placed = np.ascontiguousarray(np.asarray(eco.pop.placed, np.int64))
    return {
        "prices": np.asarray(stats.prices).tobytes().hex(),
        "prices_dtype": str(np.asarray(stats.prices).dtype),
        "reserve": np.asarray(stats.reserve).tobytes().hex(),
        "reserve_dtype": str(np.asarray(stats.reserve).dtype),
        "rounds": int(stats.rounds),
        "migrations": int(stats.migrations),
        "converged": bool(stats.converged),
        "system_ok": bool(stats.system_ok),
        "placed_sha256": hashlib.sha256(placed.tobytes()).hexdigest(),
    }


def record(agents: int = 100_000, clusters: int = 8, seed: int = 0, epochs: int = 3) -> dict:
    """Run the reference and return the recording (see the module docstring)."""
    import jax
    import jax.experimental

    if not hasattr(jax.experimental, "enable_x64"):
        jax.experimental.enable_x64 = jax.enable_x64
    from repro.core.markets import fleet_economy

    runs = {}
    for path, fused in (("staged", False), ("fused", True)):
        for label, warm in RESTARTS.items():
            eco = fleet_economy(agents, clusters, seed=seed, warm_start=warm, fused=fused)
            runs[f"{path} {label}"] = [epoch_record(eco.run_epoch(), eco) for _ in range(epochs)]
    return {
        "source": "repro.core.markets.fleet_economy (JAX reference, XLA CPU backend)",
        "jax": jax.__version__,
        "config": {"agents": agents, "clusters": clusters, "seed": seed, "epochs": epochs},
        "runs": runs,
    }


def mismatches(want: list[dict], got: list[dict]) -> list[str]:
    """The fields where a run's epochs differ from a recorded run's."""
    bad = []
    for e, (w, g) in enumerate(zip(want, got)):
        bad += [f"epoch {e} {k}: {g.get(k)!r} != {v!r}" for k, v in w.items() if g.get(k) != v]
    if len(want) != len(got):
        bad.append(f"{len(got)} epochs, recorded {len(want)}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--agents", type=int, default=100_000)
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--epochs", type=int, default=3)
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    rec = record(args.agents, args.clusters, args.seed, args.epochs)
    args.out.write_text(json.dumps(rec, indent=1) + "\n")
    for name, eps in rec["runs"].items():
        print(name, [e["rounds"] for e in eps])
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
