"""One auction epoch of the fleet economy whose teams re-bid from market
feedback (paper Section V), plainly.

The teams' policies, as the program's description of them states them:

* ``static`` bids as every team of the fleet cells does, and takes no
  action.
* ``price_chasing`` (at epoch 0, with no settled prices yet, no action):
  an agent's bundle costs, over each cluster, ``cost_prev`` at the last
  settled prices and ``cost_bel`` at the shared belief.  It *chases* where
  some move beats its friction: a homed agent where ``cost_prev[home] -
  cost_prev[c] - friction * relocation > 0`` for a cluster ``c`` other than
  its home, a homeless one where ``cost_bel[c] - cost_prev[c] - friction *
  relocation > 0`` for some ``c``.  A chaser re-draws its reach, biases
  each cluster priced below its belief by ``-strength * clip((cost_bel -
  cost_prev) / max(|cost_bel|, 1e-9), 0, 1)``, bids with the margin
  ``chase_margin`` and, where it holds a pool, with a sell intent of at
  least ``sell_prob``.  An agent that does not chase keeps its stored reach
  keys (sticky reach), its margin and its sell intent.
* ``budget_smoothing`` scales its price cap by ``floor + (1 - floor) *
  clip(fill_rate, 0, 1)``.

The fold into the epoch's inputs: an agent that keeps its reach takes the
keys its reach came from in the last epoch (where it has any), the bias is
added to the keys, the price cap ``min(value - relocation, believed * (1 +
margin), budget)`` is scaled in float64 before the book's float32, and the
sell intent and the margin replace the agent's own for the epoch.  Every
agent's keys, before the bias, are stored for the next epoch.  Policies
read the state before the epoch, after a region fault's claw-back.

Departures from the description, each so that an agent on the edge of a
decision falls on the side the program's float64 arithmetic puts it:
the two cost matrices come from one matrix product of the requirements
with the price and belief curves stacked side by side (the sums of three
products in the order the product takes them), and each comparison is
made on the difference in the order written above, not rearranged.

Everything else is :func:`.economy.run_epoch`, copied with the policy
inputs added; it reads nothing that the program made.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import clock, economy, numerics
from .economy import (BELIEF_KEEP, FILL_EMA, RELIABILITY_EMA, SELL_DISCOUNT, SELL_UTIL,
                      capacity_scale, claw_back, fault_coins, ordered_add, post_settlement)


@dataclasses.dataclass
class State(economy.State):
    reach_keys: np.ndarray | None = None  # (N, C) keys of the last epoch's reach, None before one
    prices: np.ndarray | None = None  # (R,) the last settled prices, None before an epoch
    reserve: np.ndarray | None = None  # (R,) the last epoch's reserve

    def copy(self) -> "State":
        out = super().copy()
        for k in ("reach_keys", "prices", "reserve"):
            v = getattr(self, k)
            setattr(out, k, None if v is None else np.array(v))
        return out


def initial_state(cfg: dict, pop: dict, usage: np.ndarray, seed: int) -> State:
    return State(**vars(economy.initial_state(cfg, pop, usage, seed)))


@dataclasses.dataclass
class Action:
    """One policy's inputs for its agents (None: the agent's own)."""

    redraw: np.ndarray | None = None  # (n,) bool: a fresh reach; None: fresh for all
    bias: np.ndarray | None = None  # (n, C) added to the reach keys
    pi_scale: np.ndarray | None = None  # (n,)
    arbitrage: np.ndarray | None = None  # (n,) sell intent
    margin: np.ndarray | None = None  # (n,)


def margins(pop: dict, bids: int) -> np.ndarray:
    return pop["margin0"] * pop["margin_decay"] ** bids


def price_chasing(params: dict, st: State, pop: dict, idx: np.ndarray, C: int, T: int):
    if st.prices is None:
        return None
    strength = params.get("strength", 2.0)
    friction = params.get("friction", 1.0)
    sell_prob = params.get("sell_prob", 0.35)
    sticky = params.get("sticky_reach", True)
    chase_margin = params.get("chase_margin", 50.0)
    n = idx.size
    curves = np.concatenate([np.asarray(st.prices, np.float64).reshape(C, T),
                             np.asarray(st.belief, np.float64).reshape(C, T)], axis=0).T
    costs = pop["req"][idx] @ curves
    cost_prev, cost_bel = costs[:, :C], costs[:, C:]
    cheap = cost_bel - cost_prev
    home = st.home[idx]
    reloc = friction * pop["relocation_cost"][idx][:, None]
    away = np.arange(C)[None, :] != home[:, None]
    at_home = cost_prev[np.arange(n), np.clip(home, 0, C - 1)][:, None]
    moves = (at_home - cost_prev - reloc > 0.0) & away
    chase = np.where(home >= 0, moves.any(axis=1), (cheap - reloc > 0.0).any(axis=1))
    rel = np.clip(cheap / np.maximum(np.abs(cost_bel), 1e-9), 0.0, 1.0)
    bias = np.where(chase[:, None] & (cheap > 0.0), -strength * rel, 0.0)
    own = pop["arbitrage"][idx]
    sellers = chase & (st.placed[idx] >= 0)
    arbitrage = np.where(sellers, np.maximum(own, sell_prob), own)
    margin = np.where(chase, chase_margin, margins(pop, st.bids)[idx])
    return Action(redraw=chase | (not sticky), bias=bias, arbitrage=arbitrage, margin=margin)


def budget_smoothing(params: dict, st: State, pop: dict, idx: np.ndarray, C: int, T: int):
    floor = params.get("floor", 0.5)
    return Action(pi_scale=floor + (1.0 - floor) * np.clip(st.fill_rate[idx], 0.0, 1.0))


def static(params, st, pop, idx, C, T):
    return None


POLICIES = {"static": static, "price_chasing": price_chasing,
            "budget_smoothing": budget_smoothing}


def actions(cfg: dict, pop: dict, st: State, C: int, T: int) -> list:
    """``(agents, Action or None)`` of each configured policy, in order."""
    out = []
    for pid, spec in enumerate(cfg["policies"]):
        params = {k: v for k, v in spec.items() if k != "name"}
        idx = np.flatnonzero(pop["policy"] == pid)
        out.append((idx, POLICIES[spec["name"]](params, st, pop, idx, C, T) if idx.size else None))
    return out


def fold(cfg: dict, pop: dict, st: State, perm_keys: np.ndarray, C: int, T: int):
    """The epoch's reach keys, π scales, sell intents and margins after
    every policy's action, and the keys to store for the next epoch."""
    n = perm_keys.shape[0]
    keys, store = perm_keys.copy(), perm_keys.copy()
    pi_scale = np.ones(n)
    arbitrage = pop["arbitrage"].copy()
    margin = margins(pop, st.bids)
    for idx, act in actions(cfg, pop, st, C, T):
        if act is None:
            continue
        if act.redraw is not None and st.reach_keys is not None:
            stored = st.reach_keys[idx]
            keep = idx[~act.redraw & ~np.isnan(stored).any(axis=1)]
            keys[keep] = st.reach_keys[keep]
            store[keep] = st.reach_keys[keep]
        if act.bias is not None:
            keys[idx] += act.bias
        for got, full in ((act.pi_scale, pi_scale), (act.arbitrage, arbitrage),
                          (act.margin, margin)):
            if got is not None:
                full[idx] = got
    return keys, store, pi_scale, arbitrage, margin


def run_epoch(cfg: dict, pop: dict, cap: np.ndarray, st: State, device, dtype=torch.float32):
    """Settle the epoch after ``st`` with the policies' actions folded in;
    returns ``(outputs, state after)``."""
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
    perm_keys, stored_keys, pi_scale, arb, margin = fold(cfg, pop, st, rng.random((n, C)), C, T)

    # who sells, who buys, and at what price
    placed, home = st.placed, st.home
    free = np.maximum(free_basis - usage, 0.0).reshape(-1)
    pl = np.clip(placed, 0, C - 1)
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
    raw_value = pop["value"][:, None] - pop["relocation_cost"][:, None] * (
        np.arange(C)[None, :] != home[:, None])
    ceiling = np.minimum(np.minimum(raw_value, believed * (1.0 + margin)[:, None]),
                         pop["budget"][:, None]) * pi_scale[:, None]
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
    after.reach_keys, after.prices, after.reserve = stored_keys, prices, reserve
    outputs = {"prices": prices, "reserve": reserve, "rounds": out["rounds"],
               "converged": converged, "escalations": out["escalations"],
               "migrations": int(((home >= 0) & won_buy & (home != buy_cluster)).sum())}
    return outputs, after
