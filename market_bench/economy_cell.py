"""A fleet economy cell: the operator's periodic auction over the fleet.

The program is ``repro_torch.core.Economy`` built on the fleet's arrays
(:mod:`.fleet`) with the deployment's settings; the window drives
``Economy.run_epoch`` back to back.  The output check replays the warm-up
epochs from the seed with the plain reference, and the window epochs the
mix samples from the program's state just before each of them.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from . import fleet, load
from .reference import economy as ref


class Cell:
    def __init__(self, cfg: dict, params: dict, seed: int, device: torch.device,
                 workdir: str):
        self.cfg = dict(cfg, faults=load.fault_spec(params, seed))
        self.params, self.seed, self.device = params, seed, device
        self.pop = fleet.population(cfg, seed)
        self.cap = fleet.capacity(cfg)
        self.usage0 = fleet.initial_usage(cfg, self.pop, self.cap)
        self.eco = None
        self.warm: list = []  # (outputs, state after) of each warm-up epoch
        self.samples: dict = {}  # window epoch -> (state before, outputs, state after)
        self.rounds: list[int] = []
        self.failed = 0

    # -- the program ---------------------------------------------------------
    def build(self) -> None:
        from repro_torch.core.faults import FaultModel, RegionFault

        faults = None
        spec = self.cfg["faults"]
        if spec is not None:
            faults = FaultModel(**dict(spec, region_faults=tuple(
                RegionFault(**f) for f in spec["region_faults"])))
        cfg = self.cfg
        self.eco = economy(cfg, self.pop, self.cap, self.usage0, self.seed, self.device,
                           faults=faults, clock_retries=cfg["clock_retries"],
                           ration_fallback=cfg["ration_fallback"], **cfg["settings"])

    def state(self) -> ref.State:
        """The program's market state, as the reference takes it."""
        eco = self.eco
        return ref.State(
            placed=eco.pop.placed.copy(), home=eco.pop.home.copy(),
            fill_rate=eco.pop.fill_rate.copy(), usage=eco.usage.copy(),
            belief=eco.belief.copy(), reliability=eco.pool_reliability.copy(),
            bids=int(eco.pop.epoch[0]), epoch=len(eco.price_history),
            rng_state=eco.rng.bit_generator.state)

    @staticmethod
    def outputs(stats) -> dict:
        return {"prices": stats.prices, "reserve": stats.reserve, "rounds": stats.rounds,
                "converged": stats.converged, "escalations": stats.clock_escalations,
                "migrations": stats.migrations,
                "faults": (stats.dropped_bids, stats.seller_failures, stats.failed_pools,
                           stats.evictions)}

    def warm_up(self) -> None:
        for _ in range(int(self.params["warmup"])):
            stats = self.eco.run_epoch()
            self.warm.append((self.outputs(stats), self.state()))

    def window(self, seconds: float, tracer=None) -> dict:
        """Epochs back to back until ``seconds`` have passed; the window
        ends with the epoch that crosses it (traced, with one past the
        profiled stretch at least).  The output check samples the
        mix's early epochs and the first to start after a share of
        ``seconds`` drawn from the seed."""
        sample = set(load.sample_epochs(self.params, self.seed))
        late_at = seconds * load.late_fraction(self.seed)
        late = None
        profile_units = int(self.params["profile_units"]) if tracer is not None else 0
        prof = tracer.profile() if profile_units else None
        if prof is not None:
            prof.__enter__()
        t0 = time.perf_counter()
        ends = []
        n = 0
        while True:
            if late is None and n > max(sample, default=-1) and ends and ends[-1] >= late_at:
                late = n
                sample.add(n)
            before = self.state() if n in sample else None
            stats = self.epoch(tracer)
            if before is not None:
                self.samples[n] = (before, self.outputs(stats), self.state())
            self.rounds.append(stats.rounds)
            self.failed += int(not stats.converged)
            ends.append(time.perf_counter() - t0)
            n += 1
            if prof is not None and n == profile_units:
                prof.__exit__(None, None, None)
                prof = None
            if time.perf_counter() - t0 >= seconds and n > profile_units:
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        return {"units": n, "attempted": n, "seconds": elapsed, "rounds": int(sum(self.rounds)),
                "tenths_ms": tenths(ends), "metrics": {"epoch_ms": (elapsed * 1e3 / n, "ms")}}

    def epoch(self, tracer):
        if tracer is None:
            return self.eco.run_epoch()
        from repro_torch.kernels import ops

        cap0 = ops.capture_stats()["seconds"]
        launches0 = ops.launch_counts().get("sparse_bid_eval_partials", 0)
        stats = self.eco.run_epoch()
        if tracer.profiling:
            tracer.count("partials_calls", (
                ops.launch_counts().get("sparse_bid_eval_partials", 0) - launches0,
                book_shape(self.eco)))
        else:  # the timed epochs after the profiled stretch
            tracer.count("rounds", stats.rounds)
            tracer.count("capture_ms", (ops.capture_stats()["seconds"] - cap0) * 1e3)
            tracer.units += 1
        return stats

    def instrument(self, tracer) -> None:
        """The benchmark's spans around the economy's host stages and the
        fused program's stages."""
        eco = self.eco
        for attr, name in (("_fused_prepare", "economy.prepare"),
                           ("_fused_dispatch", "economy.dispatch"),
                           ("_fused_adopt", "economy.adopt"),
                           ("_fused_finalize", "economy.finalize")):
            tracer.wrap(eco, attr, name)
        prog = getattr(eco, "_fused_fn", None)
        if prog is not None:
            tracer.wrap(prog, "_run", lambda stage, *a, **k: f"fused.{stage}",
                        when=lambda stage, *a, **k: stage in ("pack", "settle"))
            tracer.wrap(prog, "_clock", "fused.clock")

    def release(self) -> None:
        self.eco = None

    # -- the check -----------------------------------------------------------
    def check(self, device, dtype=torch.float32) -> dict:
        """Readings of the numbers compared (:class:`Comparison`): the
        warm-up epochs replayed from the seed, each sampled window epoch
        from the program's state before it."""
        cmp = Comparison()
        st = ref.initial_state(self.cfg, self.pop, self.usage0, self.seed + 1)
        for got, got_after in self.warm:
            want, st = ref.run_epoch(self.cfg, self.pop, self.cap, st, device, dtype)
            cmp.add(got, got_after, want, st)
        for before, got, got_after in self.samples.values():
            want, want_after = ref.run_epoch(self.cfg, self.pop, self.cap, before, device, dtype)
            cmp.add(got, got_after, want, want_after)
        return cmp.readings()


def economy(cfg: dict, pop: dict, cap, usage, seed: int, device, **settings):
    """The program's ``Economy`` over the fleet's arrays (its epoch stream
    seeded ``seed + 1``, as the repository's fleet generators do), its teams
    having bid ``epochs_before`` epochs already."""
    from repro_torch.core import AgentPopulation, ClockConfig, Economy

    n = pop["req"].shape[0]
    agents = AgentPopulation(epoch=np.full(n, int(cfg.get("epochs_before", 0)), np.int64),
                             **{k: np.array(v) for k, v in pop.items()})
    eco = Economy(
        clusters=[f"cluster-{c}" for c in range(cfg["clusters"])], rtypes=cfg["rtypes"],
        capacity=cap, base_cost=np.asarray(cfg["base_cost"]), agents=agents,
        clock=ClockConfig(**cfg["clock"]), seed=seed + 1, settle_blocks=cfg["settle_blocks"],
        device=device, **settings)
    eco.usage = usage.copy()
    return eco


def tenths(ends: list[float]) -> list[float]:
    """Mean milliseconds a unit in the first and the last tenth of the
    window's units (``ends``: each unit's end, seconds into the window)."""
    k = max(len(ends) // 10, 1)
    first = ends[k - 1] / k
    last = (ends[-1] - (ends[-k - 1] if len(ends) > k else 0.0)) / k
    return [first * 1e3, last * 1e3]


def book_shape(eco):
    """(rows, bundles, terms, valid bundles, pools, blocks) of the fused
    program's settlement book this epoch, or None where it has none."""
    book = getattr(getattr(eco, "_fused_fn", None), "_book", None)
    if not isinstance(book, dict) or "b_mask" not in book or "b_idx" not in book:
        return None
    rows, b, k = book["b_idx"].shape
    return rows, b, k, int(book["b_mask"].sum()), eco.R, eco.settle_blocks


def rel_gap(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if a.shape != b.shape:
        return float("inf")
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1e-30)).max()) if a.size else 0.0


class Comparison:
    """Epoch by epoch: the settled prices, the reserves, the rounds, the
    placements and homes after it, and the usage, beliefs, fill rates and
    delivery record after it."""

    def __init__(self):
        self.epochs = 0
        self.price_gap = self.reserve_gap = self.state_gap = 0.0
        self.rounds_gap = self.placement_mismatch = 0

    def add(self, got, got_after, want, want_after) -> None:
        self.epochs += 1
        self.price_gap = max(self.price_gap, rel_gap(got["prices"], want["prices"]))
        self.reserve_gap = max(self.reserve_gap, rel_gap(got["reserve"], want["reserve"]))
        self.rounds_gap = max(self.rounds_gap, abs(int(got["rounds"]) - int(want["rounds"])))
        self.placement_mismatch += int((got_after.placed != want_after.placed).sum()
                                       + (got_after.home != want_after.home).sum())
        for f in ("usage", "belief", "fill_rate", "reliability"):
            self.state_gap = max(self.state_gap, rel_gap(getattr(got_after, f),
                                                         getattr(want_after, f)))

    def readings(self) -> dict:
        return {"epochs_compared": self.epochs, "price_gap": self.price_gap,
                "reserve_gap": self.reserve_gap, "rounds_gap": self.rounds_gap,
                "placement_mismatch": self.placement_mismatch, "state_gap": self.state_gap}
