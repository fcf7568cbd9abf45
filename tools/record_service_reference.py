#!/usr/bin/env python3
"""Record the JAX reference's always-on market service, tick by tick.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/record_service_reference.py \
        [--agents 100000] [--clusters 8] [--ticks 6] [--churn 0.01] \
        [--withdraw-frac 0.001] [--seed 0] [--out PATH]

Runs the reference's own CLI, ``repro.serve.market.main``, over
``fleet_economy(agents, clusters, seed=seed)`` bridged into a
``MarketService`` with a WAL and a checkpoint directory (a temporary one),
killed in process (``del svc``) and resumed from disk after ``ticks // 2``
ticks (``--kill-resume``).  Each binding tick's ``EpochStats`` and the book
after it are recorded: the float32 prices and float64 psi as hex bytes;
rounds, the flags, ``pct_settled``, ``clock_escalations``, the bid counters
and ``health`` exactly; ``gamma_*``, ``surplus`` and ``value_of_trade``
(derived from payments, so held to a tolerance); and the sha256 of every
array of ``book.export_state()`` and of its JSON metadata.  Each service
construction (the bridge, then the resume) records its restored step, WAL
records replayed and pending deltas.  ``chip_smoke.py`` phase [7] runs the
same stream through the port on the card and holds every tick against the
file (``service_100k_reference.json`` here, for the defaults).

This script imports JAX; the port never does.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_OUT = ROOT / "tools" / "service_100k_reference.json"
EXACT = ("epoch", "rounds", "converged", "system_ok", "pct_settled", "warm_started",
         "degraded", "clock_escalations", "dropped_bids", "bids_submitted", "bids_withdrawn",
         "bids_rejected", "bids_deferred", "deadline_missed", "tick_failures",
         "retry_backoff_s", "health")
PAYMENT = ("gamma_median", "gamma_mean", "surplus", "value_of_trade")


def tick_record(stats, book) -> dict:
    """One binding tick: its stats and the sha256 of the book after it."""
    arrays, meta = book.export_state()
    rec = {
        "prices": np.asarray(stats.prices).tobytes().hex(),
        "prices_dtype": str(np.asarray(stats.prices).dtype),
        "psi": np.asarray(stats.psi).tobytes().hex(),
        "psi_dtype": str(np.asarray(stats.psi).dtype),
    }
    rec.update({k: getattr(stats, k) for k in EXACT})
    rec.update({k: float(getattr(stats, k)) for k in PAYMENT})
    rec["book_sha256"] = {
        k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
        for k, v in sorted(arrays.items())
    }
    rec["book_meta_sha256"] = hashlib.sha256(
        json.dumps(meta, sort_keys=True).encode()).hexdigest()
    return rec


def cli_argv(agents, clusters, ticks, churn, withdraw_frac, seed, durable_dir) -> list[str]:
    """The service CLI's flags for this stream (both packages take them)."""
    return ["--agents", str(agents), "--clusters", str(clusters), "--ticks", str(ticks),
            "--churn", str(churn), "--withdraw-frac", str(withdraw_frac), "--seed", str(seed),
            "--durable-dir", str(durable_dir), "--kill-resume"]


def run_cli(market, argv: list[str], on_build=None, on_tick=None) -> tuple[list[dict], list[dict]]:
    """Run ``market.main(argv)`` (the reference's or the port's service CLI)
    → ``(builds, ticks)``: each service construction and each binding tick,
    recorded as this file records them.  ``on_build(svc)`` and
    ``on_tick(svc)``, when given, see each service just built and each
    service just after a binding tick."""
    ticks_out, builds = [], []
    tick, from_economy = market.MarketService.tick, market.MarketService.from_economy.__func__

    def recording_tick(self, dry_run=False, deadline_s=None):
        stats = tick(self, dry_run, deadline_s)
        if not dry_run:
            ticks_out.append(tick_record(stats, self.book))
            if on_tick is not None:
                on_tick(self)
        return stats

    def recording_from_economy(cls, *args, **kw):
        svc = from_economy(cls, *args, **kw)
        builds.append({"restored_step": svc.restored_step, "epoch": svc.epoch,
                       "replayed_records": svc.replayed_records, "pending": svc.pending,
                       "rows": svc.book.num_rows, "rows_cap": svc.book.rows_cap})
        if on_build is not None:
            on_build(svc)
        return svc

    market.MarketService.tick = recording_tick
    market.MarketService.from_economy = classmethod(recording_from_economy)
    try:
        market.main(argv)
    finally:
        market.MarketService.tick = tick
        market.MarketService.from_economy = classmethod(from_economy)
    return builds, ticks_out


def record(agents=100_000, clusters=8, ticks=6, churn=0.01, withdraw_frac=0.001, seed=0) -> dict:
    """Run the reference's CLI and return the recording (see the docstring)."""
    import jax

    from repro.serve import market

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as d:
        builds, ticks_out = run_cli(
            market, cli_argv(agents, clusters, ticks, churn, withdraw_frac, seed, d))
    return {
        "source": "repro.serve.market.main (JAX reference, XLA CPU backend)",
        "jax": jax.__version__,
        "config": {"agents": agents, "clusters": clusters, "ticks": ticks, "churn": churn,
                   "withdraw_frac": withdraw_frac, "seed": seed, "kill_resume": True},
        "record_seconds": time.perf_counter() - t0,
        "builds": builds,
        "ticks": ticks_out,
    }


def mismatches(want: dict, got: dict, rtol: float = 1e-5) -> list[str]:
    """Where a run differs from a recording: ``ticks`` and ``builds`` exactly,
    except the payment-derived fields, held to ``rtol``."""
    bad = []
    for t, (w, g) in enumerate(zip(want["ticks"], got["ticks"])):
        for k, v in w.items():
            if k in PAYMENT:
                if not np.allclose(g[k], v, rtol=rtol, atol=0.0, equal_nan=True):
                    bad.append(f"tick {t} {k}: {g[k]!r} vs {v!r} (rtol {rtol})")
            elif g.get(k) != v:
                bad.append(f"tick {t} {k}")
    if len(want["ticks"]) != len(got["ticks"]):
        bad.append(f"{len(got['ticks'])} ticks, recorded {len(want['ticks'])}")
    if want["builds"] != got["builds"]:
        bad.append(f"builds {got['builds']} vs {want['builds']}")
    return bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--agents", type=int, default=100_000)
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=6)
    ap.add_argument("--churn", type=float, default=0.01)
    ap.add_argument("--withdraw-frac", type=float, default=0.001)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    rec = record(args.agents, args.clusters, args.ticks, args.churn, args.withdraw_frac,
                 args.seed)
    args.out.write_text(json.dumps(rec, indent=1) + "\n")
    print("rounds", [t["rounds"] for t in rec["ticks"]], "builds", rec["builds"])
    print(f"wrote {args.out} in {rec['record_seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
