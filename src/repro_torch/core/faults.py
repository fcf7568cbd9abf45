"""Seed-deterministic failure injection for the market economy.

The paper's market is a *long-term* provisioning mechanism, so it has to
keep clearing while the infrastructure it prices is failing underneath it:
regions lose capacity mid-horizon, sellers flake on delivery (Tycoon's
unreliable participants), and a fraction of bidders simply never submit an
epoch.  :class:`FaultModel` injects all three as **pure array overlays** in
the style of :class:`~repro_torch.core.policies.PolicyAction` — one
:class:`FaultDraw` of optional arrays per epoch, consumed by the economy's
settlement path and then discarded.  A disabled model (the defaults) emits
no overlays at all, so the fault-free trajectory stays bit-identical to an
economy with no model attached.

Three fault channels:

* **capacity faults** (:class:`RegionFault`): a deterministic schedule of
  per-cluster effective-capacity windows — region loss (``scale=0``),
  partial degradation (``0 < scale < 1``), and recovery (``end``).  The
  nominal ``Economy.capacity`` is untouched; the fault scales the
  *effective* capacity the epoch sees, so recovery is exact.
* **seller failures** (``seller_fail``): each *winning* sell row's agent
  flakes with this probability — the capacity it handed back turns out
  dead for the epoch, and the buyers who claimed it are clawed back with
  compensation.
* **bid-stream dropout** (``bid_dropout``): each agent independently fails
  to submit its bids this epoch.  Dropout only masks rows out of the book —
  the epoch's pre-drawn randomness is consumed identically, so the
  vectorized and loop packers stay bit-parity under dropout.
* **pool failures** (``pool_fail``): right after settlement a pool fails
  outright, delivering only ``pool_fail_scale`` of its capacity this epoch;
  over-placed winners are evicted with compensation (quota clawback).

Randomness is **counter-based**: every epoch's draws come from a fresh
``np.random.default_rng((seed, epoch, channel))``, so the model carries no
mutable state at all.  That is what makes dry runs trivially side-effect
free and lets a crash-resumed horizon (see
:func:`repro_torch.core.state.economy_state`) reproduce the exact
fault sequence of an uninterrupted run.
"""
from __future__ import annotations

import dataclasses

import numpy as np

# channel tags for the per-epoch counter-based RNG streams — each fault
# channel draws from its own stream so enabling one channel never perturbs
# another channel's realizations
_CH_DROPOUT = 0
_CH_SELLER = 1
_CH_POOL = 2


@dataclasses.dataclass(frozen=True)
class RegionFault:
    """One scheduled capacity-loss window on a cluster.

    Active for epochs ``start <= e`` (and ``e < end`` when ``end`` is set —
    ``end`` is the first *recovered* epoch).  While active, the cluster's
    effective capacity is ``scale`` times nominal: ``scale=0`` is a full
    region loss, ``0 < scale < 1`` partial degradation.  ``rtype=None``
    hits every resource type in the cluster.
    """

    cluster: int
    start: int
    end: int | None = None  # first epoch the region is back; None = never
    scale: float = 0.0  # surviving capacity fraction while active
    rtype: int | None = None  # None = all resource types

    def active(self, epoch: int) -> bool:
        return epoch >= self.start and (self.end is None or epoch < self.end)


@dataclasses.dataclass(frozen=True)
class FaultDraw:
    """One epoch's realized faults — pure overlays, never mutated.

    ``None`` fields mean "channel inactive this epoch"; the economy skips
    the corresponding handling entirely, which is what keeps the disabled
    path bit-identical.
    """

    epoch: int
    capacity_scale: np.ndarray | None  # (C, T) effective-capacity multiplier
    dropout: np.ndarray | None  # (N,) bool — agent fails to submit
    seller_fail_u: np.ndarray | None  # (N,) uniforms for seller flake coins
    pool_fail: np.ndarray | None  # (R,) bool — pool fails post-settlement

    @property
    def any_fault(self) -> bool:
        return (
            self.capacity_scale is not None
            or self.dropout is not None
            or self.seller_fail_u is not None
            or self.pool_fail is not None
        )


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Seed-deterministic fault injector (all channels default to off).

    With the defaults — no region faults, all probabilities zero — the
    model is :attr:`disabled` and the economy's settlement path is
    bit-identical to running with no model attached: no overlays are
    built, no extra RNG is consumed (the fault streams are counter-based
    and separate from the economy's stream either way).
    """

    seed: int = 0
    region_faults: tuple[RegionFault, ...] = ()
    bid_dropout: float = 0.0  # P(agent submits nothing this epoch)
    seller_fail: float = 0.0  # P(winning seller fails to deliver)
    pool_fail: float = 0.0  # P(pool fails right after settlement)
    pool_fail_scale: float = 0.5  # delivered fraction of a failed pool

    def __post_init__(self):
        for name in ("bid_dropout", "seller_fail", "pool_fail"):
            p = getattr(self, name)
            if not 0.0 <= p <= 1.0:
                raise ValueError(f"{name} must be a probability, got {p}")
        if not 0.0 <= self.pool_fail_scale <= 1.0:
            raise ValueError(
                f"pool_fail_scale must be in [0, 1], got {self.pool_fail_scale}"
            )

    @property
    def disabled(self) -> bool:
        return (
            not self.region_faults
            and self.bid_dropout == 0.0
            and self.seller_fail == 0.0
            and self.pool_fail == 0.0
        )

    def _rng(self, epoch: int, channel: int) -> np.random.Generator:
        # counter-based: (seed, epoch, channel) fully determines the stream,
        # so draws are stateless, resumable, and per-channel independent
        return np.random.default_rng((self.seed, epoch, channel))

    def capacity_scale(self, epoch: int, C: int, T: int) -> np.ndarray | None:
        """(C, T) effective-capacity multiplier, or None if no active fault."""
        scale = None
        for rf in self.region_faults:
            if not rf.active(epoch):
                continue
            if scale is None:
                scale = np.ones((C, T), np.float64)
            sel = slice(None) if rf.rtype is None else rf.rtype
            scale[rf.cluster, sel] = np.minimum(scale[rf.cluster, sel], rf.scale)
        return scale

    def draw(self, epoch: int, num_agents: int, C: int, T: int) -> FaultDraw:
        """Realize one epoch's faults (pure — consumes no mutable state)."""
        dropout = None
        if self.bid_dropout > 0.0:
            u = self._rng(epoch, _CH_DROPOUT).random(num_agents)
            dropout = u < self.bid_dropout
        seller_u = None
        if self.seller_fail > 0.0:
            seller_u = self._rng(epoch, _CH_SELLER).random(num_agents)
        pool_fail = None
        if self.pool_fail > 0.0:
            u = self._rng(epoch, _CH_POOL).random(C * T)
            pool_fail = u < self.pool_fail
        return FaultDraw(
            epoch=epoch,
            capacity_scale=self.capacity_scale(epoch, C, T),
            dropout=dropout,
            seller_fail_u=seller_u,
            pool_fail=pool_fail,
        )
