"""One auction epoch of the fleet economy (paper Sections III-V), plainly.

From the fleet's arrays and the state before the epoch (who holds what
where, the pools' usage, the agents' price beliefs and fill rates, the
pools' delivery record, the epoch's random stream) the reference works out
the epoch again: the faults that hold this epoch, the congestion-weighted
reserves, who sells and who buys and at what price, the clock's prices
and rounds, who wins, and the placements, usage, fills and beliefs after
it.  It reads nothing that the program made.

Host arithmetic is float64 numpy, the book float32 and the clock in
``dtype`` on ``device`` (float32, or bfloat16 for the control).  Order of
operations follows the deployment's stated numerics: quantities added into
a pool in submission order, a trader's sell row before its buy row.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import clock, numerics

SELL_DISCOUNT = 1.0 - 0.15  # a trader offers its holding 15% under believed revenue
SELL_UTIL = 0.75  # a holding is offered only where its home is this full
FILL_EMA = 0.5
BELIEF_KEEP = 0.25  # belief <- 0.25 belief + 0.75 price
RELIABILITY_EMA = 0.5


@dataclasses.dataclass
class State:
    placed: np.ndarray  # (N,) cluster held, -1 none
    home: np.ndarray  # (N,)
    fill_rate: np.ndarray  # (N,)
    usage: np.ndarray  # (C, T)
    belief: np.ndarray  # (R,)
    reliability: np.ndarray  # (R,) delivered-capacity EMA
    bids: int  # epochs bid so far (drives the margin decay)
    epoch: int  # the epoch about to settle
    rng_state: dict  # the epoch stream's state

    def copy(self) -> "State":
        return dataclasses.replace(
            self, **{k: np.array(getattr(self, k)) for k in
                     ("placed", "home", "fill_rate", "usage", "belief", "reliability")},
            rng_state=dict(self.rng_state))


def initial_state(cfg: dict, pop: dict, usage: np.ndarray, seed: int) -> State:
    n, C = pop["req"].shape[0], int(cfg["clusters"])
    return State(placed=pop["placed"].copy(), home=pop["home"].copy(),
                 fill_rate=np.ones(n), usage=usage.copy(),
                 belief=np.tile(np.asarray(cfg["base_cost"], np.float64), C),
                 reliability=np.ones(C * len(cfg["base_cost"])),
                 bids=int(cfg.get("epochs_before", 0)), epoch=0,
                 rng_state=np.random.default_rng(seed).bit_generator.state)


def capacity_scale(faults: dict, epoch: int, C: int, T: int):
    """(C, T) surviving capacity fraction of the region faults that hold at
    ``epoch``, or None."""
    scale = None
    for f in faults["region_faults"]:
        if epoch >= f["start"] and (f["end"] is None or epoch < f["end"]):
            if scale is None:
                scale = np.ones((C, T))
            t = slice(None) if f["rtype"] is None else f["rtype"]
            scale[f["cluster"], t] = np.minimum(scale[f["cluster"], t], f["scale"])
    return scale


def fault_coins(faults: dict, epoch: int, channel: int, size: int) -> np.ndarray:
    """The epoch's uniforms of one fault channel (0 bid dropout, 1 seller
    flake, 2 pool failure), a stream of its own from (seed, epoch, channel)."""
    return np.random.default_rng((faults["seed"], epoch, channel)).random(size)


def post_settlement(faults: dict, epoch: int, cap, cap_eff, usage, placed, req, sellers,
                    sell_clusters, buyers, buy_clusters, buy_scale):
    """Sellers that fail to deliver and pools that fail right after the
    auction: the capacity delivered, and the usage and placements after
    this epoch's buyers are evicted where usage exceeds it (the latest
    buyer into a cluster first)."""
    C, T = cap.shape
    delivered = np.array(cap_eff, np.float64)
    if faults["seller_fail"] > 0 and sellers.size:
        flake = fault_coins(faults, epoch, 1, req.shape[0])[sellers] < faults["seller_fail"]
        np.subtract.at(delivered, sell_clusters[flake], req[sellers[flake]])
        delivered = np.maximum(delivered, 0.0)
    if faults["pool_fail"] > 0:
        fail = (fault_coins(faults, epoch, 2, C * T) < faults["pool_fail"]).reshape(C, T)
        delivered = np.where(fail, delivered * faults["pool_fail_scale"], delivered)
    if np.any(usage > delivered + 1e-9):
        usage = usage.copy()
        placed = placed.copy()
        for c in np.flatnonzero((usage > delivered + 1e-9).any(axis=1)):
            for j in np.flatnonzero(buy_clusters == c)[::-1]:
                if not np.any(usage[c] > delivered[c] + 1e-9):
                    break
                usage[c] = np.maximum(usage[c] - buy_scale[j] * req[buyers[j]], 0.0)
                placed[buyers[j]] = -1
        usage = np.minimum(usage, delivered)
    return delivered, usage, placed


def claw_back(placed, req, usage, cap):
    """Holders evicted where usage exceeds capacity, the latest placed first
    (highest agent index), until the rest fit; the usage after."""
    usage = usage.copy()
    evict = np.zeros(placed.shape[0], bool)
    for c in np.flatnonzero((usage > cap + 1e-9).any(axis=1)):
        holders = np.flatnonzero(placed == c)[::-1]
        left = np.subtract.accumulate(np.concatenate([usage[c][None, :], req[holders]]), axis=0)
        fits = ~(np.maximum(left, 0.0) > cap[c] + 1e-9).any(axis=1)
        k = int(np.argmax(fits)) if fits.any() else holders.size
        evict[holders[:k]] = True
        usage[c] = np.minimum(np.maximum(left[k], 0.0), cap[c])
    return evict, usage


def ordered_add(target: np.ndarray, at: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """``target`` plus each of ``rows`` at its index, in row order; an index
    past the end adds nothing."""
    keep = at < target.shape[0]
    np.add.at(target, at[keep], rows[keep])
    return target


def run_epoch(cfg: dict, pop: dict, cap: np.ndarray, st: State, device, dtype=torch.float32):
    """Settle the epoch after ``st``; returns ``(outputs, state after)``."""
    st = st.copy()
    C, T = cap.shape
    R = C * T
    n = pop["req"].shape[0]
    req = pop["req"]
    base_cost = np.asarray(cfg["base_cost"], np.float64)
    faults = cfg.get("faults")
    cap_eff, usage = cap, st.usage
    if faults is not None:
        scale = capacity_scale(faults, st.epoch, C, T)
        if scale is not None:
            cap_eff = cap * scale
            if np.any(usage > cap_eff + 1e-9):
                evict, usage = claw_back(st.placed, req, usage, cap_eff)
                st.placed[evict] = -1
                st.usage = usage
    psi = np.clip(usage / np.maximum(cap_eff, 1e-9), 0.0, 1.0).reshape(-1)
    curve = cfg["reserve_curve"]
    psi32 = psi.astype(np.float32)
    if faults is not None:
        rel = np.clip(st.reliability.astype(np.float32), 0.0, 1.0)
        eff = np.maximum(np.float32(1.0) - np.float32(1.0) * (np.float32(1.0) - rel),
                         np.float32(1e-6))
        psi32 = np.clip(psi32 / eff, np.float32(0.0), np.float32(1.0))
    base32 = np.tile(base_cost, C).astype(np.float32)
    reserve = numerics.exp_reserve(psi32, base32, curve["k"], curve["target"], curve["gamma"])
    free_basis = cap_eff if faults is not None else cap

    rng = np.random.default_rng()
    rng.bit_generator.state = st.rng_state
    u_arb = rng.random(n)
    perm_keys = rng.random((n, C))

    # who sells, who buys, and at what price
    placed, home = st.placed, st.home
    free = np.maximum(free_basis - usage, 0.0).reshape(-1)
    pl = np.clip(placed, 0, C - 1)
    arb = pop["arbitrage"]
    sells = (placed >= 0) & (arb > 0) & (u_arb < arb) & (psi[pl * T] > SELL_UTIL)
    wants = (placed < 0) | sells
    if faults is not None and faults["bid_dropout"] > 0:
        dropped = fault_coins(faults, st.epoch, 0, n) < faults["bid_dropout"]
        sells, wants = sells & ~dropped, wants & ~dropped
    believed = np.zeros((n, C))
    belief_ct = st.belief.reshape(C, T)
    for t in range(T):
        believed = believed + req[:, t, None] * belief_ct[None, :, t]
    perm = np.argsort(perm_keys, axis=1, kind="stable")
    rank = np.argsort(perm, axis=1, kind="stable")
    n_reach = np.clip(np.rint(pop["mobility"] * C).astype(np.int64), 1, C)
    key = np.where(rank >= n_reach[:, None], np.inf, rank.astype(np.float64))
    key = np.where((home >= 0)[:, None] & (np.arange(C)[None, :] == home[:, None]), -1.0, key)
    order = np.argsort(key, axis=1, kind="stable")
    valid = np.arange(C)[None, :] < n_reach[:, None]
    margin = pop["margin0"] * pop["margin_decay"] ** st.bids
    raw_value = pop["value"][:, None] - pop["relocation_cost"][:, None] * (
        np.arange(C)[None, :] != home[:, None])
    ceiling = np.minimum(np.minimum(raw_value, believed * (1.0 + margin)[:, None]),
                         pop["budget"][:, None])
    bc = np.where(valid, order, 0)
    live = wants[:, None] & valid
    pi_buy = np.where(live, np.take_along_axis(ceiling, bc, axis=1).astype(np.float32), -np.inf)
    pi_sell = ((-believed[np.arange(n), pl]) * SELL_DISCOUNT).astype(np.float32)

    # the book: a lot per pool, then each agent's sell row and buy row
    U = R + 2 * n
    idx = np.zeros((U, C, T), np.int64)
    val = np.zeros((U, C, T), np.float32)
    mask = np.zeros((U, C), bool)
    pi = np.full((U, C), -np.inf, np.float32)
    lots = free > 1e-9
    idx[:R, 0, 0] = np.where(lots, np.arange(R), 0)
    val[:R, 0, 0] = np.where(lots, (-free).astype(np.float32), 0.0)
    mask[:R, 0] = lots
    pi[:R, 0] = np.where(lots, ((-free) * reserve.astype(np.float64)).astype(np.float32), -np.inf)
    s_rows, b_rows = R + 2 * np.arange(n), R + 2 * np.arange(n) + 1
    idx[s_rows, 0] = np.where(sells[:, None], pl[:, None] * T + np.arange(T), 0)
    val[s_rows, 0] = np.where(sells[:, None], (-req).astype(np.float32), 0.0)
    mask[s_rows, 0] = sells
    pi[s_rows, 0] = np.where(sells, pi_sell, -np.inf)
    idx[b_rows] = np.where(live[:, :, None], bc[:, :, None] * T + np.arange(T), 0)
    val[b_rows] = np.where(live[:, :, None], req.astype(np.float32)[:, None, :], 0.0)
    mask[b_rows] = live
    pi[b_rows] = pi_buy
    present = np.concatenate([lots, np.stack([sells, wants], axis=1).reshape(-1)])
    supply = np.zeros(R, np.float32)
    flat_i, flat_v = idx.reshape(-1), val.reshape(-1)
    nz = flat_v != 0
    np.add.at(supply, flat_i[nz], np.abs(flat_v[nz]))
    supply = np.maximum(supply, np.float32(1.0))

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dtype)

    book = clock.Book(torch.from_numpy(idx), torch.from_numpy(val), torch.from_numpy(mask),
                      torch.from_numpy(pi)).to(device, dtype)
    layout = clock.FusedLayout(torch.from_numpy(present).to(device), int(cfg["settle_blocks"]))
    out = clock.clock_auction(book, layout, dev(base32), dev(supply), dev(reserve),
                              cfg["clock"], int(cfg["clock_retries"]))
    prices = out["prices"].float().cpu().numpy()
    chosen = out["chosen"].cpu().numpy()
    chosen = np.where(present, chosen, -1)
    won = (chosen >= 0)[R:].reshape(n, 2)
    won_sell, won_buy = won[:, 0], won[:, 1]
    buy_cluster = order[np.arange(n), np.maximum(chosen[R:].reshape(n, 2)[:, 1], 0)]

    # apply: usage, placements, fills, beliefs
    none = np.full(n, C)
    old = np.where(won_sell, -1, placed)
    move = won_buy & (old >= 0) & (old != buy_cluster)
    sell_at = np.where(won_sell, placed, none)
    buy_at = np.where(won_buy, buy_cluster, none)
    move_at = np.where(move, old, none)
    converged = out["converged"]
    if cfg["ration_fallback"]:
        base = usage + ordered_add(np.zeros((C, T)), sell_at, -req)
        released = ordered_add(base.copy(), move_at, -req)
        room = np.maximum(cap_eff - np.maximum(released, 0.0), 0.0)
        claim = ordered_add(np.zeros((C, T)), buy_at, req)
        with np.errstate(divide="ignore", invalid="ignore"):
            frac = np.where(claim > 1e-12,
                            np.minimum(room / np.maximum(claim, 1e-12), 1.0), 1.0)
        scale_r = np.where(req > 0, frac[buy_cluster], 1.0).min(axis=1)
        buy_scale = np.where(won_buy & (not converged), scale_r, 1.0)
        u = ordered_add(base, np.concatenate([buy_at, move_at]),
                        np.concatenate([buy_scale[:, None] * req, -req]))
    else:
        buy_scale = np.ones(n)
        u = ordered_add(usage.copy(), np.concatenate([sell_at, buy_at, move_at]),
                        np.concatenate([-req, req, -req]))
    after = st.copy()
    after.usage = np.minimum(np.maximum(u, 0.0), cap_eff)
    after.placed = np.where(won_buy, buy_cluster, np.where(won_sell, -1, placed))
    after.home = np.where(won_buy, buy_cluster, home)
    after.fill_rate = np.where(wants, (1.0 - FILL_EMA) * st.fill_rate
                               + FILL_EMA * won_buy.astype(np.float64), st.fill_rate)
    after.belief = BELIEF_KEEP * st.belief + (np.float32(0.75) * prices).astype(np.float64)
    if faults is not None:
        buyers = np.flatnonzero(won_buy)
        sellers = np.flatnonzero(won_sell)
        delivered, after.usage, after.placed = post_settlement(
            faults, st.epoch, cap, cap_eff, after.usage, after.placed, req, sellers,
            placed[sellers], buyers, buy_cluster[buyers], buy_scale[buyers])
        obs = np.clip(delivered / np.maximum(cap, 1e-9), 0.0, 1.0).reshape(-1)
        after.reliability = (1.0 - RELIABILITY_EMA) * st.reliability + RELIABILITY_EMA * obs
    after.bids = st.bids + 1
    after.epoch = st.epoch + 1
    after.rng_state = rng.bit_generator.state
    outputs = {"prices": prices, "reserve": reserve, "rounds": out["rounds"],
               "converged": converged, "escalations": out["escalations"],
               "migrations": int(((home >= 0) & won_buy & (home != buy_cluster)).sum())}
    return outputs, after
