#!/usr/bin/env python3
"""Record the JAX reference's scenario runs, epoch by epoch.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/record_scenario_reference.py [--out PATH]

Runs each case of ``CASES`` through the reference's ``run_scenario``: the
nine library scenarios, ``SCENARIOS[name](seed=3)`` at their own epoch
counts, and two runs at the repo's benchmark scale,
``fleet_economy(100_000, 8, seed=0)`` for 6 epochs, once under
``flash_crowd``'s event stream (``flash_crowd@100k``) and once under
``region_loss``'s fault model with ``clock_retries=2`` and
``ration_fallback=True`` (``region_loss@100k``).  Every run is staged.

Each epoch records what a run must repeat bit for bit: the float32 prices,
the reserve curve and psi as hex bytes, the ``EXACT`` stats, the sha256 of
the chosen bundles of the epoch's last clock and of the population's
``placed`` after the epoch; and the payment-derived ``PAYMENT`` stats, held
to a tolerance.  Each run also records its utilization-spread series, its
event reports and the final pool reliability.  ``chip_smoke.py`` phase [8]
runs the same cases through the port on the card and holds them to the
file (``scenario_reference.json`` here); ``tests/test_torch_scenarios.py``
runs the library cases through both packages on the CPU with the same
comparison (:func:`run_case`, :func:`mismatches`).

This script imports JAX; the port never does.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
DEFAULT_OUT = ROOT / "tools" / "scenario_reference.json"
LIBRARY = ("congestion_relief", "cluster_drain", "price_shock", "flash_crowd",
           "sticky_relocation", "migration_relief", "region_loss", "region_recovery",
           "unreliable_supply")
AT_SCALE = ("flash_crowd@100k", "region_loss@100k")
CASES = LIBRARY + AT_SCALE
EXACT = ("epoch", "rounds", "migrations", "converged", "system_ok", "pct_settled",
         "warm_started", "degraded", "clock_escalations", "rationed_rows", "dropped_bids",
         "seller_failures", "failed_pools", "evictions", "clawback_units", "arrivals_rejected")
PAYMENT = ("gamma_median", "gamma_mean", "surplus", "value_of_trade", "compensation")


def _hex(a) -> str:
    return np.ascontiguousarray(a).tobytes().hex()


def _sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def build(core, name: str, **eco_kwargs):
    """``(economy, scenario)`` of case ``name`` from a package's core
    (``repro.core`` or ``repro_torch.core``); ``eco_kwargs`` go to the
    economy (the port's ``device``)."""
    if name == "flash_crowd@100k":
        eco = core.fleet_economy(100_000, 8, seed=0, **eco_kwargs)
        return eco, core.Scenario(name, epochs=6, events=(
            core.Arrivals(epoch=1, num_agents=16, seed=103, value_mult=2.0),
            core.FlashCrowd(epoch=2, value_scale=1.5, fraction=0.5, seed=203),
            core.Departures(epoch=4, fraction=0.25, seed=303),
        ))
    if name == "region_loss@100k":
        faults = core.faults.FaultModel(
            region_faults=(core.faults.RegionFault(cluster=0, start=1, scale=0.0),))
        eco = core.fleet_economy(100_000, 8, seed=0, faults=faults, clock_retries=2,
                                 ration_fallback=True, **eco_kwargs)
        return eco, core.Scenario(name, epochs=6)
    return core.SCENARIOS[name](seed=3, **eco_kwargs)


def epoch_record(stats, eco, chosen) -> dict:
    """The fields of one epoch (``chosen``: the last clock's chosen bundles;
    None where no staged clock ran, as in a fused epoch)."""
    rec = {k: _hex(np.asarray(getattr(stats, k))) for k in ("prices", "reserve", "psi")}
    rec["prices_dtype"] = str(np.asarray(stats.prices).dtype)
    rec.update({k: getattr(stats, k) for k in EXACT})
    rec.update({k: float(getattr(stats, k)) for k in PAYMENT})
    rec["chosen_sha256"] = None if chosen is None else _sha(np.asarray(chosen.tolist(), np.int32))
    rec["placed_sha256"] = _sha(np.asarray(eco.pop.placed, np.int64))
    return rec


def run_case(core, name: str, epochs: int | None = None, sync=lambda: None, on_epoch=None,
             **eco_kwargs) -> dict:
    """Run case ``name`` through ``core.run_scenario`` → its recording.

    The economy module's ``clock_auction`` is wrapped for the run, to keep
    each clock's chosen bundles and its time; ``sync()`` runs before and
    after each clock and epoch is timed (a device synchronise on the card).
    ``on_epoch(eco, stats, timing)``, when given, sees each epoch with its
    ``{"wall_ms", "clock_ms", "clocks"}``.
    """
    eco, sc = build(core, name, **eco_kwargs)
    if epochs is not None:
        sc = dataclasses.replace(sc, epochs=epochs)
    economy = core.economy
    clock_auction = economy.clock_auction
    clocks, records = [], []

    def tapped_clock(*args, **kw):
        sync()
        t0 = time.perf_counter()
        res = clock_auction(*args, **kw)
        sync()
        clocks.append(((time.perf_counter() - t0) * 1e3, res.chosen_bundle))
        return res

    run_epoch = eco.run_epoch

    def recorded_epoch(*args, **kw):
        clocks.clear()
        sync()
        t0 = time.perf_counter()
        stats = run_epoch(*args, **kw)
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
        records.append(epoch_record(stats, eco, clocks[-1][1] if clocks else None))
        if on_epoch is not None:
            on_epoch(eco, stats, {"wall_ms": wall_ms, "clock_ms": sum(c[0] for c in clocks),
                                  "clocks": len(clocks)})
        return stats

    eco.run_epoch = recorded_epoch
    economy.clock_auction = tapped_clock
    try:
        res = core.run_scenario(eco, sc)
    finally:
        economy.clock_auction = clock_auction
    return {
        "epochs": records,
        "util_spread": [float(x) for x in res.util_spread],
        "events": [dataclasses.asdict(r) for r in res.events],
        "pool_reliability": _hex(np.asarray(eco.pool_reliability)),
    }


def mismatches(want: dict, got: dict, rtol: float = 1e-5) -> list[str]:
    """Where a run differs from a recording: everything exactly, except the
    ``PAYMENT`` stats, held to ``rtol``."""
    bad = []
    for e, (w, g) in enumerate(zip(want["epochs"], got["epochs"])):
        for k, v in w.items():
            if k in PAYMENT:
                if not np.allclose(g[k], v, rtol=rtol, atol=0.0, equal_nan=True):
                    bad.append(f"epoch {e} {k}: {g[k]!r} vs {v!r} (rtol {rtol})")
            elif g.get(k) != v and not (v != v and g.get(k) != g.get(k)):  # NaN is NaN
                bad.append(f"epoch {e} {k}: {g.get(k)!r} vs {v!r}")
    if len(want["epochs"]) != len(got["epochs"]):
        bad.append(f"{len(got['epochs'])} epochs, recorded {len(want['epochs'])}")
    bad += [k for k in ("util_spread", "events", "pool_reliability") if got[k] != want[k]]
    return bad


def record() -> dict:
    """Run the reference on each case and return the recording."""
    import jax

    import repro.core as core

    runs, seconds = {}, {}
    for name in CASES:
        t0 = time.perf_counter()
        runs[name] = run_case(core, name)
        seconds[name] = time.perf_counter() - t0
    return {
        "source": "repro.core.scenarios.run_scenario (JAX reference, XLA CPU backend)",
        "jax": jax.__version__,
        "record_seconds": seconds,
        "runs": runs,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=DEFAULT_OUT)
    args = ap.parse_args(argv)
    rec = record()
    args.out.write_text(json.dumps(rec, indent=1) + "\n")
    for name, run in rec["runs"].items():
        print(f"{name}: rounds {[e['rounds'] for e in run['epochs']]}, "
              f"{rec['record_seconds'][name]:.1f} s")
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
