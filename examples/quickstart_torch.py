"""Quickstart on the PyTorch port: one clock auction over two clusters, end
to end (the twin of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Congestion-weighted reserve prices, operator supply, XOR bids via the tree
bidding language, ascending-clock settlement (each round one ``bid_eval``
launch on the card) and the SYSTEM feasibility checks.
"""
import argparse

import numpy as np
import torch

from repro_torch.core import (
    All, OneOf, Res, flatten, pool_index,
    ResourcePool, reserve_prices, operator_supply_bids, pack_bids,
    clock_auction, verify_system, surplus_and_trade,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    # -- pools: (cluster × resource) with base costs + current utilization ----
    pools = [
        ResourcePool("us-east", "tpu_chips", base_cost=10.0, utilization=0.93, supply=512),
        ResourcePool("us-east", "hbm_gb", base_cost=0.05, utilization=0.90, supply=8192),
        ResourcePool("eu-west", "tpu_chips", base_cost=10.0, utilization=0.35, supply=512),
        ResourcePool("eu-west", "hbm_gb", base_cost=0.05, utilization=0.30, supply=8192),
    ]
    idx = pool_index([p.name for p in pools])

    tilde_p = reserve_prices(pools)
    print("reserve prices (congestion-weighted):")
    for p, r in zip(pools, tilde_p):
        print(f"  {p.name:20s} util={p.utilization:.0%}  c(r)=${p.base_cost:<6} -> p̃=${r:.3f}")

    # -- bids ----------------------------------------------------------------
    bundle_lists, pis = operator_supply_bids(pools, tilde_p, lots=4)

    # Team A: 256 chips + 4 TB HBM, either cluster (XOR), pays up to $6k
    tree_a = OneOf(
        All(Res("us-east/tpu_chips", 256), Res("us-east/hbm_gb", 4096)),
        All(Res("eu-west/tpu_chips", 256), Res("eu-west/hbm_gb", 4096)),
    )
    bundle_lists.append(flatten(tree_a, idx))
    pis.append(6000.0)

    # Team B: must stay in congested us-east (data gravity), pays a premium
    tree_b = All(Res("us-east/tpu_chips", 128), Res("us-east/hbm_gb", 2048))
    bundle_lists.append(flatten(tree_b, idx))
    pis.append(9000.0)

    # Team C: low-value batch job, happy anywhere
    tree_c = OneOf(
        All(Res("us-east/tpu_chips", 128), Res("us-east/hbm_gb", 1024)),
        All(Res("eu-west/tpu_chips", 128), Res("eu-west/hbm_gb", 1024)),
    )
    bundle_lists.append(flatten(tree_c, idx))
    pis.append(1500.0)

    prob = pack_bids(bundle_lists, pis, base_cost=np.array([p.base_cost for p in pools]),
                     device=args.device)
    start = torch.from_numpy(np.asarray(tilde_p, np.float32)).to(prob.pi.device)
    res = clock_auction(prob, start)

    print(
        f"\nclock converged in {int(res.rounds)} rounds; SYSTEM feasible: "
        f"{all(verify_system(prob, res).values())}"
    )
    print("settled unit prices:")
    for p, pr0, pr1 in zip(pools, tilde_p, res.prices.cpu().numpy()):
        print(f"  {p.name:20s} reserve ${pr0:.3f} -> settled ${pr1:.3f}")

    names = ["team-A", "team-B", "team-C"]
    for u, name in zip(range(prob.num_users - 3, prob.num_users), names):
        won = bool(res.won[u])
        pay = float(res.payments[u])
        alloc = res.allocations[u].cpu().numpy()
        where = [pools[r].name for r in np.nonzero(alloc > 0)[0]]
        print(f"  {name}: {'WON ' + str(where) + f' for ${pay:.0f}' if won else 'priced out'}")

    s, t = surplus_and_trade(prob, res)
    print(f"realized surplus ${float(s):.0f}, value of trade ${float(t):.0f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
