"""The always-on market service, plainly: a slotted book, its delta queue,
and one warm-started clock auction a tick.

The book holds ``rows`` slots of B bundles of K (pool, quantity) terms.  A
new account takes the slot freed last, else the next unused one; a
withdrawn account's slot is zeroed and freed.  Between ticks deltas queue
per account, the last one for an account winning; a withdrawal of an
account that is queued but not yet in the book cancels it.  A tick applies
the queued submissions (in the order their accounts first queued), then
the withdrawals, and runs the clock from ``max(last prices, reserve)``
over every slot, the supply of a pool being the sum of the absolute
quantities in it.  Each bundle's terms are stored in ascending pool order.
"""
from __future__ import annotations

import numpy as np
import torch

from . import clock


class Book:
    def __init__(self, num_pools: int, bundles: int, terms: int, rows: int):
        self.R, self.B, self.K = num_pools, bundles, terms
        cap = 1
        while cap < rows:
            cap *= 2
        self.idx = np.zeros((cap, bundles, terms), np.int32)
        self.val = np.zeros((cap, bundles, terms), np.float32)
        self.mask = np.zeros((cap, bundles), bool)
        self.pi = np.zeros((cap, bundles), np.float32)
        self.slot: dict = {}
        self.free: list[int] = []
        self.next_slot = 0

    @property
    def rows(self) -> int:
        return self.mask.shape[0]

    def pack(self, bundles, pi):
        """One account's submission as a row (terms sorted by pool)."""
        idx = np.zeros((self.B, self.K), np.int32)
        val = np.zeros((self.B, self.K), np.float32)
        mask = np.zeros(self.B, bool)
        pis = np.zeros(self.B, np.float32)
        pi = np.broadcast_to(np.asarray(pi, np.float32), (len(bundles),))
        for b, (ii, vv) in enumerate(bundles):
            ii, vv = np.asarray(ii, np.int32), np.asarray(vv, np.float32)
            order = np.argsort(ii, kind="stable")
            idx[b, :ii.size], val[b, :ii.size] = ii[order], vv[order]
            mask[b], pis[b] = True, pi[b]
        return idx, val, mask, pis

    def put(self, key, row) -> None:
        s = self.slot.get(key)
        if s is None:
            if not self.free and self.next_slot == self.rows:
                self._grow()
            s = self.free.pop() if self.free else self.next_slot
            if s == self.next_slot:
                self.next_slot += 1
            self.slot[key] = s
        self.idx[s], self.val[s], self.mask[s], self.pi[s] = row

    def _grow(self) -> None:
        for name in ("idx", "val", "mask", "pi"):
            a = getattr(self, name)
            setattr(self, name, np.concatenate([a, np.zeros_like(a)]))

    def remove(self, key) -> bool:
        s = self.slot.pop(key, None)
        if s is None:
            return False
        self.idx[s], self.val[s], self.mask[s], self.pi[s] = 0, 0.0, False, 0.0
        self.free.append(s)
        return True

    def supply(self) -> np.ndarray:
        ledger = np.bincount(self.idx.reshape(-1).astype(np.int64),
                             weights=np.abs(self.val.reshape(-1).astype(np.float64)),
                             minlength=self.R)
        return np.maximum(ledger.astype(np.float32), np.float32(1.0))


class Service:
    def __init__(self, base_cost: np.ndarray, reserve: np.ndarray, bundles: int, terms: int,
                 rows: int, clock_cfg: dict, retries: int, blocks: int, warm_start: bool,
                 device, dtype=torch.float32):
        self.book = Book(base_cost.shape[0], bundles, terms, rows)
        self.base_cost = np.asarray(base_cost, np.float32)
        self.reserve = np.asarray(reserve, np.float64)
        self.clock_cfg, self.retries, self.blocks = clock_cfg, retries, blocks
        self.warm_start = warm_start
        self.device, self.dtype = device, dtype
        self.pending: dict = {}
        self.last_prices = None

    def submit(self, key, bundles, pi) -> bool:
        self.pending[key] = ("put", self.book.pack(bundles, pi))
        return True

    def withdraw(self, key) -> bool:
        queued = self.pending.get(key)
        if queued is not None and queued[0] == "put" and key not in self.book.slot:
            del self.pending[key]
            return True
        if key not in self.book.slot and queued is None:
            return False
        self.pending[key] = ("remove",)
        return True

    def drain(self) -> None:
        for key, q in self.pending.items():
            if q[0] == "put":
                self.book.put(key, q[1])
        for key, q in self.pending.items():
            if q[0] == "remove":
                self.book.remove(key)
        self.pending.clear()

    def tick(self) -> dict:
        self.drain()
        b = self.book
        start = self.reserve if self.last_prices is None or not self.warm_start else \
            np.maximum(self.last_prices, self.reserve)

        def dev(a):
            return torch.from_numpy(np.asarray(a, np.float32)).to(self.device, self.dtype)

        book = clock.Book(torch.from_numpy(b.idx), torch.from_numpy(b.val),
                          torch.from_numpy(b.mask), torch.from_numpy(b.pi)).to(self.device,
                                                                               self.dtype)
        out = clock.clock_auction(book, clock.SlotLayout(b.rows, self.blocks),
                                  dev(self.base_cost), dev(b.supply()), dev(start),
                                  self.clock_cfg, self.retries)
        prices = out["prices"].float().cpu().numpy()
        if out["converged"]:
            self.last_prices = prices
        return {"prices": prices, "rounds": out["rounds"], "converged": out["converged"]}
