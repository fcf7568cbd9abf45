"""The paper's §V experimental economy on the PyTorch port (the twin of
``examples/market_sim.py``): six periodic auctions over a planet-wide fleet,
with adaptive bidders, arbitrageurs, and relocation costs, every epoch
settled through ``sparse_bid_eval_partials`` on the card.  Prints
Table-I-style premium statistics, Fig-6-style price ratios, and
Fig-7-style utilization percentiles of settled trades.

    PYTHONPATH=src python examples/market_sim_torch.py [--epochs 6] [--seed 3] [--device cpu]

Or run a library scenario (outages, flash crowds, price shocks, ...):

    PYTHONPATH=src python examples/market_sim_torch.py --scenario cluster_drain
    PYTHONPATH=src python examples/market_sim_torch.py --list-scenarios
"""
import argparse
import sys

import numpy as np

from repro_torch.core.economy import make_fleet_economy
from repro_torch.core.scenarios import SCENARIOS, run_scenario


def run_scenario_mode(args) -> None:
    eco, sc = SCENARIOS[args.scenario](seed=args.seed, epochs=args.epochs,
                                      device=args.device)
    print(f"scenario: {sc.name} — {sc.description}")
    print(f"fleet: {len(eco.clusters)} clusters × {eco.rtypes}, {len(eco.pop)} engineering teams")
    if eco.policies:
        counts = np.bincount(eco.pop.policy, minlength=len(eco.policies))
        mix = ", ".join(
            f"{type(p).__name__}×{int(c)}" for p, c in zip(eco.policies, counts)
        )
        print(f"policy mix: {mix}")
    res = run_scenario(eco, sc, verbose=True)
    print("\n== outcome ==")
    print(f"events applied: {len(res.events)}")
    util0 = [round(float(s.psi[:eco.T].mean()), 3) for s in res.stats]
    print(f"cluster-0 utilization per epoch: {util0}")
    print(f"utilization spread trajectory: {[round(s, 3) for s in res.util_spread]}")
    print(f"spread shrank: {res.spread_shrank}")
    print(f"total migrations: {res.total_migrations}")
    print(f"total clock rounds: {res.total_rounds}")
    print(f"all epochs converged: {res.converged}")
    print(f"all epochs SYSTEM-feasible: {res.feasible}")
    degraded = [s for s in res.stats if s.degraded]
    if degraded:
        print("\n== degraded-mode telemetry ==")
        print(f"degraded epochs: {[s.epoch for s in degraded]}")
        print(f"clock escalations: {sum(s.clock_escalations for s in res.stats)}")
        print(f"dropped bids: {sum(s.dropped_bids for s in res.stats)}")
        print(
            f"seller failures: {sum(s.seller_failures for s in res.stats)}, "
            f"failed pools: {sum(s.failed_pools for s in res.stats)}"
        )
        print(
            f"evictions: {sum(s.evictions for s in res.stats)}, "
            f"rationed rows: {sum(s.rationed_rows for s in res.stats)}"
        )
        print(
            f"clawback: {sum(s.clawback_units for s in res.stats):.1f} units, "
            f"compensation paid: {sum(s.compensation for s in res.stats):.2f}"
        )
        rel = eco.pool_reliability.reshape(eco.C, eco.T).min(axis=1)
        worst = int(np.argmin(rel))
        print(
            f"pool reliability (min per cluster): "
            f"{[round(float(r), 3) for r in rel]} — worst: "
            f"{eco.clusters[worst]}"
        )
    if not res.converged:
        starved = [s.epoch for s in res.stats if not s.converged]
        print(
            f"*** WARNING: epochs {starved} hit max_rounds without "
            "clearing — prices are truncated, not settled",
            file=sys.stderr,
        )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=6)
    ap.add_argument("--seed", type=int, default=3)
    ap.add_argument(
        "--scenario",
        choices=sorted(SCENARIOS),
        default=None,
        help="run a library scenario instead of the plain §V sim",
    )
    ap.add_argument("--list-scenarios", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.list_scenarios:
        for name in sorted(SCENARIOS):
            _, sc = SCENARIOS[name](seed=0, device=args.device)
            print(f"{name:20s} {sc.description}")
        return
    if args.scenario:
        run_scenario_mode(args)
        return

    eco = make_fleet_economy(seed=args.seed, device=args.device)
    print(f"fleet: {len(eco.clusters)} clusters × {eco.rtypes}, {len(eco.pop)} engineering teams")
    print(
        f"pre-market utilization by cluster: "
        f"{(eco.utilization().mean(axis=1) * 100).round(0).tolist()}"
    )

    print("\n== Table I: bid premium statistics ==")
    print("auction  median(γ)  mean(γ)  %settled  migrations  rounds  converged")
    stats = []
    for _ in range(args.epochs):
        s = eco.run_epoch()
        stats.append(s)
        print(
            f"  {s.epoch:2d}     {s.gamma_median:8.4f} {s.gamma_mean:8.4f}  "
            f"{s.pct_settled:6.1f}%   {s.migrations:4d}       {s.rounds:5d}  "
            f"{s.converged}"
        )
        if not s.converged:
            print(
                f"  *** WARNING: epoch {s.epoch} hit max_rounds="
                f"{eco.clock.max_rounds} without clearing — prices are "
                "truncated, not settled (raise max_rounds, enable the "
                "adaptive schedule, or warm-start the economy)",
                file=sys.stderr,
            )

    print("\n== Fig 6: settled price / former fixed price (last auction) ==")
    r = stats[-1].price_ratio.reshape(eco.C, eco.T)
    for c, name in enumerate(eco.clusters):
        print(f"  {name}: " + "  ".join(f"{eco.rtypes[t]}={r[c, t]:.2f}x" for t in range(eco.T)))

    print("\n== Fig 7: utilization percentile of settled trades ==")
    buys = np.concatenate([s.buy_util_percentiles for s in stats])
    sells = np.concatenate([s.sell_util_percentiles for s in stats])
    for name, arr in (("bids (buys)", buys), ("offers (sells)", sells)):
        if len(arr):
            q = np.percentile(arr, [25, 50, 75]).round(0)
            print(f"  {name:15s} n={len(arr):3d}  quartiles {q.tolist()}")

    print("\n== outcome ==")
    print(
        f"post-market utilization by cluster: "
        f"{(eco.utilization().mean(axis=1) * 100).round(0).tolist()}"
    )
    print(f"utilization spread (std across clusters): {np.std(eco.utilization().mean(axis=1)):.3f}")
    print(f"total migrations: {sum(s.migrations for s in stats)}")
    print(f"all epochs SYSTEM-feasible: {all(s.system_ok for s in stats)}")


if __name__ == "__main__":
    main()
