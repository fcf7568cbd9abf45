"""An adaptive fleet cell: the operator's periodic auction over the fleet,
with teams whose tooling re-bids every epoch from the market's feedback.

A deployment of ``"kind": "adaptive"`` is a fleet deployment (see
:mod:`.economy_cell`) with one key more: ``policies``, the bidder
policies of ``repro_torch.core.policies`` by their registry names, each
with its parameters; :func:`policy_ids` assigns the agents to them.
The program is ``Economy(policies=[...])`` on the fleet's arrays with
each agent's policy id; the output check replays the
epochs through the plain reference of :mod:`.reference.adaptive`, which
folds the policies' actions into the epoch, and compares the agents'
stored reach keys after each epoch besides the fleet's numbers.

With a trace, each timed epoch counts the agents whose reach a policy
re-drew (``Economy.last_policy_counts``, where the program keeps it).
"""
from __future__ import annotations

import numpy as np
import torch

from . import economy_cell, fleet
from .reference import adaptive as ref


def policy_ids(cfg: dict, pop: dict) -> np.ndarray:
    """Each agent's index into ``cfg["policies"]``: agents homed in a
    congested cluster run ``price_chasing``; every other agent runs
    ``static`` at an even position and ``budget_smoothing`` at an odd one."""
    names = [p["name"] for p in cfg["policies"]]
    n = pop["home"].shape[0]
    hot = pop["home"] < fleet.congested(cfg)
    others = np.where(np.arange(n) % 2 == 0, names.index("static"),
                      names.index("budget_smoothing"))
    return np.where(hot, names.index("price_chasing"), others).astype(np.int64)


class Cell(economy_cell.Cell):
    def __init__(self, cfg, params, seed, device, workdir):
        super().__init__(cfg, params, seed, device, workdir)
        self.pop["policy"] = policy_ids(cfg, self.pop)
        self.policy_counts: list[dict] = []  # the program's counts, an epoch each

    def build(self) -> None:
        from repro_torch.core.policies import POLICY_REGISTRY

        self.cfg["settings"] = dict(self.cfg["settings"], policies=[
            POLICY_REGISTRY[p["name"]](**{k: v for k, v in p.items() if k != "name"})
            for p in self.cfg["policies"]])
        super().build()

    def state(self) -> ref.State:
        eco = self.eco
        return ref.State(**vars(super().state()),
                         reach_keys=None if eco._reach_keys is None else eco._reach_keys.copy(),
                         prices=eco.price_history[-1].copy() if eco.price_history else None,
                         reserve=None if eco._last_reserve is None else eco._last_reserve.copy())

    def warm_up(self) -> None:
        for _ in range(int(self.params["warmup"])):
            stats = self.eco.run_epoch()
            self.warm.append((self.outputs(stats), self.state()))
            self._keep_counts()

    def epoch(self, tracer):
        stats = super().epoch(tracer)
        counts = self._keep_counts()
        if tracer is not None and not tracer.profiling and "policy_redraws" in counts:
            tracer.count("policy_redraws", counts["policy_redraws"])
        return stats

    def _keep_counts(self) -> dict:
        counts = dict(getattr(self.eco, "last_policy_counts", {}))
        self.policy_counts.append(counts)
        return counts

    # -- the check -----------------------------------------------------------
    def check(self, device, dtype=torch.float32) -> dict:
        """The fleet's readings (:class:`economy_cell.Comparison`) and the
        agents whose stored reach keys differ, through the adaptive reference."""
        cmp = Comparison()
        st = ref.initial_state(self.cfg, self.pop, self.usage0, self.seed + 1)
        for got, got_after in self.warm:
            want, st = ref.run_epoch(self.cfg, self.pop, self.cap, st, device, dtype)
            cmp.add(got, got_after, want, st)
        for before, got, got_after in self.samples.values():
            want, want_after = ref.run_epoch(self.cfg, self.pop, self.cap, before, device, dtype)
            cmp.add(got, got_after, want, want_after)
        readings = cmp.readings()
        redraws = [c["policy_redraws"] for c in self.policy_counts if "policy_redraws" in c]
        readings["policy_redraws"] = sum(redraws) if redraws else None
        return readings


class Comparison(economy_cell.Comparison):
    def __init__(self):
        super().__init__()
        self.reach_mismatch = 0

    def add(self, got, got_after, want, want_after) -> None:
        super().add(got, got_after, want, want_after)
        a, b = got_after.reach_keys, want_after.reach_keys
        if a is None or b is None or a.shape != b.shape:
            self.reach_mismatch += 0 if a is None and b is None else want_after.placed.shape[0]
        else:
            same = (a == b) | (np.isnan(a) & np.isnan(b))
            self.reach_mismatch += int((~same.all(axis=1)).sum())

    def readings(self) -> dict:
        return dict(super().readings(), reach_mismatch=self.reach_mismatch)
