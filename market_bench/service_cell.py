"""A market service cell: the always-on service under its clients' deltas.

The program is ``repro_torch.serve.market.MarketService`` bridged from an
``Economy`` over the fleet's arrays (:mod:`.fleet`), durable in a directory
under the run's temporary directory.  The window is one closed loop of
clients (:class:`.load.Clients`): each cycle a batch of deltas goes in
through ``submit`` and ``withdraw``, then the service ticks.  The output
check replays every tick with the plain reference from the same
fleet and the same deltas, compares the book the program holds at the
end, and rebuilds a service from the durable directory and compares its
book too.
"""
from __future__ import annotations

import gc
import os
import time

import numpy as np
import torch

from . import fleet, load
from .economy_cell import economy, rel_gap, tenths
from .reference import numerics
from .reference import service as ref


class Cell:
    def __init__(self, cfg: dict, params: dict, seed: int, device: torch.device,
                 workdir: str):
        self.cfg, self.params, self.seed, self.device = cfg, params, seed, device
        self.workdir = workdir
        self.pop = fleet.population(cfg, seed)
        self.cap = fleet.capacity(cfg)
        self.usage0 = fleet.initial_usage(cfg, self.pop, self.cap)
        C = int(cfg["clusters"])
        self.belief0 = np.tile(np.asarray(cfg["base_cost"], np.float64), C)
        self.rows = fleet.resting_bids(cfg, self.pop, self.belief0)
        self.clients = load.Clients(self.rows, params, seed)
        self.svc = self.eco = None
        # a tick: (submit?, agent, scale, acknowledged) a delta, prices, rounds, committed
        self.ticks: list = []
        self.ack_us: list = []  # a tick: each call's microseconds
        self.settle_ms: list = []  # a tick: each settled delta's wait for it
        self.attempted = self.failed = 0
        self.timings: list[dict] = []

    def service_config(self):
        from repro_torch.serve.config import ServiceConfig

        d = os.path.join(self.workdir, "market")
        os.makedirs(d, exist_ok=True)
        return ServiceConfig(wal_path=os.path.join(d, "market.wal"),
                             checkpoint_dir=os.path.join(d, "ckpt"), **self.cfg["service"])

    def build(self) -> None:
        from repro_torch.serve.market import MarketService

        self.eco = economy(self.cfg, self.pop, self.cap, self.usage0, self.seed, self.device)
        self.svc = MarketService.from_economy(self.eco, config=self.service_config())

    def warm_up(self) -> None:
        for _ in range(int(self.params["warmup"])):
            self.cycle(warm=True)

    def cycle(self, tracer=None, warm: bool = False) -> None:
        """Send one batch of the clients' deltas (none in warm-up), then tick."""
        from repro_torch.serve.market import BidDelta

        svc, c = self.svc, self.clients
        batch = [] if warm else c.batch()
        oks = np.zeros(len(batch), bool)
        returned = np.zeros(len(batch))
        ack_us = np.zeros(len(batch))
        clock = time.perf_counter
        for j, (kind, i, s) in enumerate(batch):
            if kind == "submit":
                bundles, pi = c.submission(i, s)
                delta = BidDelta(c.keys[i], bundles, pi)
                t0 = clock()
                ok = svc.submit(delta)
            else:
                t0 = clock()
                ok = svc.withdraw(c.keys[i])
            returned[j] = t1 = clock()
            ack_us[j] = (t1 - t0) * 1e6
            oks[j] = ok
        if tracer is not None:
            from repro_torch.kernels import ops

            launches0 = ops.launch_counts().get("sparse_bid_eval_partials", 0)
        stats = svc.tick()
        t_end = clock()
        committed = bool(stats.converged)
        settled = oks & committed
        self.attempted += len(batch)
        self.failed += int((~settled).sum())
        self.ack_us.append(ack_us)
        self.settle_ms.append((t_end - returned[settled]) * 1e3)
        self.ticks.append((np.array([k == "submit" for k, _, _ in batch], bool),
                           np.array([i for _, i, _ in batch], np.int64),
                           np.array([1.0 if s is None else s for _, _, s in batch], np.float32),
                           oks, stats.prices, int(stats.rounds), committed))
        if tracer is not None:
            self.timings.append(dict(svc.last_tick_timings, deltas=len(batch)))
            if tracer.profiling:
                b = svc.book
                tracer.count("partials_calls", (
                    ops.launch_counts().get("sparse_bid_eval_partials", 0) - launches0,
                    (b.rows_cap, b.num_bundles, b.k_bound, int(b.mask.sum()),
                     b.num_resources, int(self.cfg["settle_blocks"]))))
            else:
                tracer.count("rounds", int(stats.rounds))
                tracer.units += 1

    def window(self, seconds: float, tracer=None) -> dict:
        """Cycles back to back for ``seconds``: each one batch of the
        clients' deltas, then a tick; the window ends with the tick that
        crosses it (traced, with one past the profiled stretch at least)."""
        self.ack_us.clear()
        self.settle_ms.clear()
        self.attempted = self.failed = 0
        profile_units = int(self.params["profile_units"]) if tracer is not None else 0
        prof = tracer.profile() if profile_units else None
        if prof is not None:
            prof.__enter__()
        t0 = time.perf_counter()
        ends = []
        n = 0
        while True:
            self.cycle(tracer)
            ends.append(time.perf_counter() - t0)
            n += 1
            if prof is not None and n == profile_units:
                prof.__exit__(None, None, None)
                prof = None
            if time.perf_counter() - t0 >= seconds and n > profile_units:
                break
        elapsed = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        ack = np.concatenate(self.ack_us)
        settle = np.concatenate(self.settle_ms)
        return {"units": n, "attempted": self.attempted, "seconds": elapsed,
                "tenths_ms": tenths(ends), "ack_p99_us": percentile(ack, 99), "metrics": {
            "tick_ms": (elapsed * 1e3 / n, "ms"),
            "settle_p95_ms": (percentile(settle, 95), "ms")}}

    def instrument(self, tracer) -> None:
        """The benchmark's spans around the service's calls and its tick's
        stages (the journal append inside each submit and withdraw)."""
        for attr in ("submit", "withdraw", "tick", "_drain", "_settle", "_commit_durable",
                     "_wal_append"):
            tracer.wrap(self.svc, attr, "service." + attr.lstrip("_").replace("_durable", ""))
        tracer.timings = self.timings

    def release(self) -> None:
        """Keep the program's final book (host arrays), drop the service."""
        book = self.svc.book
        self.final = {"arrays": (book.idx.copy(), book.val.copy(), book.mask.copy(),
                                 book.pi.copy()), "rows": book.num_rows,
                      "has": lambda key, book=book: key in book}
        self.svc = self.eco = None
        gc.collect()

    # -- the check -----------------------------------------------------------
    def reference(self, device, dtype=torch.float32) -> ref.Service:
        cfg = self.cfg
        C, T = self.cap.shape
        psi = np.clip(self.usage0 / np.maximum(self.cap, 1e-9), 0.0, 1.0).reshape(-1)
        curve = cfg["reserve_curve"]
        base32 = np.tile(np.asarray(cfg["base_cost"], np.float64), C).astype(np.float32)
        reserve = numerics.exp_reserve(psi.astype(np.float32), base32, curve["k"],
                                       curve["target"], curve["gamma"])
        n = self.pop["req"].shape[0]
        r = ref.Service(base32, reserve.astype(np.float64), C, T, max(n + C * T, 64),
                        cfg["clock"], int(cfg["service"].get("max_escalations", 2)),
                        int(cfg["settle_blocks"]), bool(cfg["service"].get("warm_start", True)),
                        device, dtype)
        free = np.maximum(self.cap - self.usage0, 0.0).reshape(-1)
        for p in np.flatnonzero(free > 1e-9):
            r.book.put(f"op-{p}", r.book.pack([([p], [-free[p]])],
                                              [float(-free[p] * reserve[p])]))
        keys, idx, val, mask, pi = self.rows
        for i, key in enumerate(keys):
            r.book.put(key, (idx[i], val[i], mask[i], pi[i]))
        return r

    def check(self, device, dtype=torch.float32) -> dict:
        r = self.reference(device, dtype)
        keys = self.clients.keys
        price_gap, rounds_gap, ack_mismatch = 0.0, 0, 0
        for submit, agent, scale, oks, prices, rounds, committed in self.ticks:
            for sub, i, s, ok in zip(submit, agent, scale, oks):
                if sub:
                    bundles, pi = self.clients.submission(i, s)
                    want = r.submit(keys[i], bundles, pi)
                else:
                    want = r.withdraw(keys[i])
                ack_mismatch += int(bool(ok) != want)
            got = r.tick()
            price_gap = max(price_gap, rel_gap(prices, got["prices"]))
            rounds_gap = max(rounds_gap, abs(rounds - got["rounds"]))
            ack_mismatch += int(committed != got["converged"])
        want = (r.book.idx.reshape(-1), r.book.val.reshape(-1), r.book.mask, r.book.pi)
        book_mismatch = rows_differ(self.final["arrays"], want) + abs(
            self.final["rows"] - len(r.book.slot)) + sum(
            not self.final["has"](k) for k in r.book.slot)
        rebuilt = self.rebuild()
        durable_mismatch = rows_differ(rebuilt, want)
        return {"ticks_compared": len(self.ticks), "price_gap": price_gap,
                "rounds_gap": rounds_gap, "ack_mismatch": ack_mismatch,
                "book_mismatch": book_mismatch, "durable_mismatch": durable_mismatch}

    def rebuild(self):
        """The book of a service rebuilt from the durable directory."""
        from repro_torch.serve.market import MarketService

        eco = economy(self.cfg, self.pop, self.cap, self.usage0, self.seed, "cpu")
        svc = MarketService.from_economy(eco, config=self.service_config(), device="cpu")
        b = svc.book
        out = (b.idx.copy(), b.val.copy(), b.mask.copy(), b.pi.copy())
        del svc
        gc.collect()
        return out

def rows_differ(got, want) -> int:
    """Slots whose (idx, val, mask, pi) differ, plus slots one side lacks."""
    gi, gv, gm, gp = got
    wi, wv, wm, wp = want
    rows = min(gm.shape[0], wm.shape[0])
    per = gi.reshape(gm.shape[0], -1)[:rows], gv.reshape(gm.shape[0], -1)[:rows]
    wper = wi.reshape(wm.shape[0], -1)[:rows], wv.reshape(wm.shape[0], -1)[:rows]
    diff = ((per[0] != wper[0]).any(1) | (per[1] != wper[1]).any(1)
            | (gm[:rows] != wm[:rows]).any(1) | (gp[:rows] != wp[:rows]).any(1))
    extra = int(gm[rows:].any()) + int(wm[rows:].any())
    return int(diff.sum()) + extra


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (linear between order statistics)."""
    values = np.asarray(values, np.float64)
    return float(np.percentile(values, q)) if values.size else float("nan")
