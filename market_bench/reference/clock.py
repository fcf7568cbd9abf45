"""The ascending clock auction (paper Section III, Algorithm 1), plainly.

Each round every bidder takes its highest-surplus valid bundle while that
surplus is at least 0, the chosen bundles' quantities are summed into the
excess demand z of every pool, and each pool with z > tol rises by
``min(alpha * z / s * c, delta * max(p, eps * c))`` with the relative step
floored at ``step_floor``.  The clock stops at the first round whose z is
at most tol everywhere (that round keeps its prices), or after
``max_rounds``.  A clock whose z at its last prices is above tol somewhere
is re-run from there with twice the rounds and the adaptive schedule on, at
most ``retries`` times.

The book is K-padded: ``idx``/``val`` (U, B, K), ``mask``/``pi`` (U, B).
How the rows' demand is summed into z is the deployment's layout
(:class:`FusedLayout`, :class:`SlotLayout`).
"""
from __future__ import annotations

import dataclasses

import torch

from . import numerics


@dataclasses.dataclass
class Book:
    idx: torch.Tensor  # (U, B, K) int64 pool of each term
    val: torch.Tensor  # (U, B, K) quantity (< 0 offers)
    mask: torch.Tensor  # (U, B) bool valid bundles
    pi: torch.Tensor  # (U, B) willingness to pay (< 0: least revenue)

    def to(self, device, dtype) -> "Book":
        return Book(self.idx.to(device).long(), self.val.to(device, dtype),
                    self.mask.to(device), self.pi.to(device, dtype))


class SlotLayout:
    """Rows in ``blocks`` contiguous blocks of equal length; each block's
    column reduced by the windowed fold."""

    def __init__(self, rows: int, blocks: int):
        if rows % blocks or rows // blocks <= numerics.WINDOW:
            raise ValueError(f"{rows} rows do not make {blocks} blocks of more than "
                             f"{numerics.WINDOW}")
        self.blocks = blocks

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        cols = x.reshape(self.blocks, -1, x.shape[-1]).transpose(1, 2)
        return numerics.chain_sum(numerics.window_fold(cols))


class FusedLayout:
    """The fused epoch's blocked book: of ``slots`` slots the ``present`` ones,
    numbered q in slot order, sit in block ``q // m`` at row ``q % m``,
    ``m = ceil(present / blocks)``, of blocks ``ceil(slots / blocks)`` rows
    long; every other row is zero."""

    def __init__(self, present: torch.Tensor, blocks: int):
        slots = present.shape[0]
        self.blocks, self.m_cap = blocks, -(-slots // blocks)
        n = int(present.sum())
        m = -(-n // blocks)
        q = torch.cumsum(present.long(), 0) - present.long()
        self.rows = torch.nonzero(present)[:, 0]
        q = q[self.rows]
        self.dest = (q // m) * self.m_cap + q % m

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        grid = torch.zeros((self.blocks * self.m_cap, x.shape[-1]), dtype=x.dtype,
                           device=x.device)
        grid[self.dest] = x[self.rows]
        cols = grid.reshape(self.blocks, self.m_cap, -1).transpose(1, 2)
        return numerics.chain_sum(numerics.window_fold(cols))


def select(book: Book, prices: torch.Tensor):
    """(chosen (U,) with -1 = out, active (U,)): the first highest-surplus
    valid bundle, kept while its surplus is at least 0."""
    costs = numerics.bundle_costs(book.val, prices[book.idx])
    surplus = torch.where(book.mask, book.pi - costs, float("-inf"))
    best = surplus.max(dim=1).values
    first = (surplus == best[:, None]).to(torch.int32).argmax(dim=1)
    active = best >= 0
    return torch.where(active, first, -1), active


def demand(book: Book, layout, prices: torch.Tensor, num_pools: int):
    """(z, chosen, active) at ``prices``."""
    chosen, active = select(book, prices)
    pick = chosen.clamp(min=0)[:, None, None].expand(-1, 1, book.idx.shape[-1])
    sel_idx = book.idx.gather(1, pick)[:, 0, :]
    sel_val = book.val.gather(1, pick)[:, 0, :] * active[:, None].to(book.val.dtype)
    pools = torch.arange(num_pools, device=prices.device)
    x = torch.zeros((sel_idx.shape[0], num_pools), dtype=book.val.dtype, device=prices.device)
    for k in range(sel_idx.shape[1]):
        x = x + torch.where(pools[None, :] == sel_idx[:, k, None], sel_val[:, k, None], 0.0)
    return layout(x), chosen, active


def escalate(cfg: dict) -> dict:
    """An unconverged clock's next attempt: twice the rounds, the adaptive
    schedule on."""
    return dict(cfg, max_rounds=cfg["max_rounds"] * 2,
                alpha_growth=cfg["alpha_growth"] if cfg["alpha_growth"] > 1.0 else 1.6,
                delta_decay=cfg["delta_decay"] if cfg["delta_decay"] < 1.0 else 0.6)


def _stage(excess, c, s, p, cfg: dict):
    dt = p.dtype
    f = lambda v: torch.tensor(v, dtype=dt, device=p.device)  # noqa: E731
    alpha, delta, eps, tol = f(cfg["alpha"]), f(cfg["delta"]), f(cfg["price_floor_frac"]), \
        f(cfg["tol"])
    floor = f(cfg["step_floor_frac"])
    adaptive = cfg["alpha_growth"] != 1.0 or cfg["delta_decay"] != 1.0
    if adaptive:
        growth, decay, cap = f(cfg["alpha_growth"]), f(cfg["delta_decay"]), f(cfg["accel_cap"])
        dfloor = f(cfg["delta_floor_frac"]) * delta
        accel = torch.ones_like(p)
        dcap = torch.full_like(p, float(delta))
        prev_pos = torch.zeros(p.shape, dtype=torch.bool, device=p.device)
    t = 0
    while t < cfg["max_rounds"]:
        z = excess(p)
        t += 1
        if bool((z <= tol).all()):
            return p, t
        pos = z > tol
        rel = torch.maximum(alpha * torch.clamp_min(z, 0.0) / s, floor)
        if adaptive:
            step = torch.minimum(rel * accel * c, dcap * torch.maximum(p, eps * c))
            accel = torch.where(pos & prev_pos, torch.minimum(accel * growth, cap), 1.0)
            dcap = torch.where(prev_pos & ~pos, torch.maximum(dcap * decay, dfloor), dcap)
            prev_pos = pos
        else:
            step = torch.minimum(rel * c, delta * torch.maximum(p, eps * c))
        p = torch.where(pos, p + step, p)
    return p, t


def clock_auction(book: Book, layout, c, s, start, cfg: dict, retries: int) -> dict:
    """Run the clock and its escalations; the prices, the last attempt's
    rounds, and z and the choices at those prices."""
    num_pools = c.shape[0]

    def excess(p):
        return demand(book, layout, p, num_pools)[0]

    p, rounds = _stage(excess, c, s, start, cfg)
    escalations = 0
    z, chosen, active = demand(book, layout, p, num_pools)
    while not bool((z <= cfg["tol"]).all()) and escalations < retries:
        escalations += 1
        cfg = escalate(cfg)
        p, rounds = _stage(excess, c, s, p, cfg)
        z, chosen, active = demand(book, layout, p, num_pools)
    return {"prices": p, "rounds": rounds, "escalations": escalations, "z": z,
            "chosen": chosen, "active": active,
            "converged": bool((z <= cfg["tol"]).all())}
