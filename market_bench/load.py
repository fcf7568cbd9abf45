"""The one load generator: it reads a traffic mix's parameters from
``traffic/<mix>.json`` and makes the cell's load from them and the seed.

Two shapes of load, named by the mix's ``"load"``:

* ``"epochs"``: the operator's periodic auction, epochs back to back.  The
  mix names the faults that hold (``faults``: every field of the
  program's fault model, region faults as a list of objects; see
  :func:`fault_spec`), the warm-up epochs before the window, and how many
  window epochs the output check samples: ``check_sample`` drawn from the
  seed among the first ``sample_span``, and one more late in the window.
* ``"batches"``: the always-on service's clients, one closed loop
  (:class:`Clients`): each cycle sends a batch of ``submits`` re-pricings
  (a standing bid's willingness to pay times U(``wtp_scale``)) and
  ``withdraws`` withdrawals, interleaved evenly, then the service ticks.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent

# the fault model's fields and their values when a mix leaves them out
FAULT_DEFAULTS = {"region_faults": [], "bid_dropout": 0.0, "seller_fail": 0.0,
                  "pool_fail": 0.0, "pool_fail_scale": 0.5}
REGION_DEFAULTS = {"end": None, "scale": 0.0, "rtype": None}


def mix(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def fault_spec(params: dict, seed: int) -> dict | None:
    """The mix's faults with every field filled in, drawn on the run's seed,
    or None where no fault channel is on."""
    given = params.get("faults")
    if not given:
        return None
    unknown = set(given) - set(FAULT_DEFAULTS)
    if unknown:
        raise ValueError(f"unknown fault fields {sorted(unknown)}")
    spec = dict(FAULT_DEFAULTS, **given, seed=seed)
    spec["region_faults"] = [dict(REGION_DEFAULTS, **f) for f in spec["region_faults"]]
    on = spec["region_faults"] or any(spec[k] > 0 for k in
                                      ("bid_dropout", "seller_fail", "pool_fail"))
    return spec if on else None


def sample_epochs(params: dict, seed: int) -> list[int]:
    """Window epochs (0 = the first in the window) whose outputs are checked,
    among the first ``sample_span``."""
    rng = np.random.default_rng([seed, 1])
    k = min(int(params["check_sample"]), int(params["sample_span"]))
    return sorted(int(i) for i in rng.choice(int(params["sample_span"]), size=k, replace=False))


def late_fraction(seed: int) -> float:
    """The share of the window after which the first epoch to start is
    checked too: drawn from the seed in [0.5, 0.9)."""
    return float(np.random.default_rng([seed, 4]).uniform(0.5, 0.9))


class Clients:
    """The service's clients, one closed loop: each batch re-prices
    ``submits`` standing bids (willingness to pay times U(``wtp_scale``))
    and withdraws ``withdraws``, the withdrawals spread evenly through it;
    a re-priced withdrawn bid stands again.  The agents are drawn from the
    seed, so every seed sends as many deltas of each kind in each batch.

    ``rows`` is every agent's standing bid ``(keys, idx, val, mask, pi)``;
    only agents with a valid bundle take part.
    """

    def __init__(self, rows, params: dict, seed: int):
        self.keys, self.idx, self.val, self.mask, self.pi = rows
        self.live = np.flatnonzero(self.mask.any(axis=1))
        self.submits = int(params["submits"])
        self.withdraws = int(params["withdraws"])
        self.scale = tuple(params["wtp_scale"])
        self.rng = np.random.default_rng([seed, 2])
        self.gone: set = set()

    def batch(self) -> list[tuple[str, int, object]]:
        """The next batch: ``(kind, agent, scale)`` a delta."""
        n = self.submits + self.withdraws
        every = n // self.withdraws if self.withdraws else 0
        out = []
        left = self.withdraws
        for k in range(n):
            if left and k % every == every - 1:
                left -= 1
                i = self.pick()
                while self.keys[i] in self.gone:
                    i = self.pick()
                self.gone.add(self.keys[i])
                out.append(("withdraw", i, None))
            else:
                i = self.pick()
                self.gone.discard(self.keys[i])  # a re-submission revives the account
                out.append(("submit", i, np.float32(self.rng.uniform(*self.scale))))
        return out

    def pick(self) -> int:
        return int(self.live[self.rng.integers(self.live.size)])

    def submission(self, i: int, scale):
        """Agent ``i``'s re-priced bid: its valid bundles and their prices."""
        valid = np.flatnonzero(self.mask[i])
        return [(self.idx[i, b], self.val[i, b]) for b in valid], self.pi[i][valid] * scale
