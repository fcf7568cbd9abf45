"""The fleet a deployment describes.

Every per-agent and per-cluster array the benchmark hands to both the
program and the plain reference is made here, from the deployment's file
and ``--seed`` alone: jobs sized in chips with HBM and ICI in proportion,
homes skewed toward the congested clusters, capacity sized to aggregate
demand times the headroom, the congested clusters pre-loaded.  The jobs
and the capacity are drawn once, from the deployment's ``fleet_draw``, so
every seed brings the same jobs to the same clusters; the seed orders the
jobs (and, in the program, draws each epoch's coins).  The draws are those
of the repository's fleet generator, frozen here so that the yardstick cannot
move with the program.
"""
from __future__ import annotations

import numpy as np


def population(cfg: dict, seed: int) -> dict:
    """Per-agent arrays of ``cfg["agents"]`` jobs over ``cfg["clusters"]``, in
    the seed's order."""
    pop = _jobs(cfg)
    order = np.random.default_rng([seed, 3]).permutation(pop["req"].shape[0])
    return {k: v[order] for k, v in pop.items()}


def _jobs(cfg: dict) -> dict:
    d = cfg["distribution"]
    rng = np.random.default_rng(cfg["fleet_draw"])
    n, num_clusters = int(cfg["agents"]), int(cfg["clusters"])
    chips = rng.choice(np.asarray(d["chip_sizes"], np.float64), size=n)
    req = np.stack([chips, chips * rng.uniform(*d["hbm_per_chip"], n),
                    chips * rng.uniform(*d["ici_per_chip"], n)], axis=1)
    cost_est = req @ np.asarray(cfg["base_cost"], np.float64)
    n_congested = congested(cfg)
    home = np.where(rng.random(n) < d["congested_home_frac"],
                    rng.integers(0, n_congested, n), rng.integers(0, num_clusters, n))
    placed = np.where(rng.random(n) < d["placed_frac"], home, -1)
    return {
        "req": req,
        "value": cost_est * rng.uniform(*d["value_mult"], n),
        "home": home.astype(np.int64),
        "relocation_cost": cost_est * rng.uniform(*d["relocation_mult"], n),
        "mobility": rng.uniform(*d["mobility"], n),
        "margin0": rng.uniform(*d["margin0"], n),
        "margin_decay": np.full(n, d["margin_decay"]),
        "arbitrage": rng.uniform(*d["arbitrage"], n),
        "budget": np.full(n, np.inf),
        "placed": placed.astype(np.int64),
    }


def congested(cfg: dict) -> int:
    return max(int(round(cfg["congested_frac"] * cfg["clusters"])), 1)


def capacity(cfg: dict) -> np.ndarray:
    """(C, T) capacity: chips per cluster from aggregate demand, the other
    types in proportion (a stream of its own from ``fleet_draw``)."""
    rng = np.random.default_rng(cfg["fleet_draw"])
    n, c = int(cfg["agents"]), int(cfg["clusters"])
    chips_c = cfg["chips_per_agent"] * n / c * cfg["headroom"] * rng.uniform(
        *cfg["cluster_spread"], c)
    return np.stack([chips_c * m for m in cfg["units_per_chip"]], axis=1)


def initial_usage(cfg: dict, pop: dict, cap: np.ndarray) -> np.ndarray:
    """(C, T) units held by the placed agents, capped at capacity, with the
    congested clusters raised to the pre-load utilization."""
    usage = np.zeros_like(cap)
    held = pop["placed"] >= 0
    np.add.at(usage, pop["placed"][held], pop["req"][held])
    usage = np.minimum(usage, cap)
    for c in range(congested(cfg)):
        usage[c] = np.maximum(usage[c], cfg["preload_util"] * cap[c])
    return usage


def resting_bids(cfg: dict, pop: dict, belief: np.ndarray):
    """Every agent's standing buy bid, as the service's clients hold it:
    ``(keys, idx (N, C, T), val, mask (N, C), pi (N, C))``, one XOR bundle a
    reachable cluster (home first, then by cluster index, cut to the
    agent's mobility), priced at ``min(value - relocation, belief * (1 +
    margin), budget)``; a bundle priced at 0 or below is left out."""
    n = pop["req"].shape[0]
    C = int(cfg["clusters"])
    T = pop["req"].shape[1]
    home = pop["home"]
    n_reach = np.clip(np.rint(pop["mobility"] * C).astype(np.int64), 1, C)
    order_key = np.broadcast_to(np.arange(C, dtype=np.float64), (n, C)).copy()
    has_home = home >= 0
    order_key[np.flatnonzero(has_home), home[has_home]] = -1.0
    order = np.argsort(order_key, axis=1, kind="stable")
    valid = np.arange(C)[None, :] < n_reach[:, None]
    believed = cluster_costs(pop["req"], belief)
    away = np.arange(C)[None, :] != home[:, None]
    margin = pop["margin0"]  # epoch 0: no decay yet
    ceiling = np.minimum(
        np.minimum(pop["value"][:, None] - pop["relocation_cost"][:, None] * away,
                   believed * (1.0 + margin)[:, None]),
        pop["budget"][:, None])
    bc = np.where(valid, order, 0)
    idx = np.where(valid[:, :, None], (bc[:, :, None] * T + np.arange(T)), 0).astype(np.int32)
    val = np.where(valid[:, :, None], pop["req"][:, None, :], 0.0).astype(np.float32)
    pi = np.where(valid, np.take_along_axis(ceiling, bc, axis=1), 0.0).astype(np.float32)
    mask = valid & (pi > 0.0)
    pi = np.where(mask, pi, 0.0).astype(np.float32)
    val = np.where(mask[:, :, None], val, 0.0).astype(np.float32)
    idx = np.where(mask[:, :, None], idx, 0).astype(np.int32)
    keys = [f"agent-{u}" for u in range(n)]
    return keys, idx, val, mask, pi


def cluster_costs(req: np.ndarray, prices_flat: np.ndarray) -> np.ndarray:
    """(N, C) cost of each agent's bundle in each cluster, summed in
    resource-type order in float64."""
    p = np.asarray(prices_flat, np.float64).reshape(-1, req.shape[1])
    out = np.zeros((req.shape[0], p.shape[0]), np.float64)
    for t in range(req.shape[1]):
        out += req[:, t, None] * p[None, :, t]
    return out
