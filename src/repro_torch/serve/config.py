"""Consolidated, validated configuration for the always-on market service.

Counterpart of ``repro.serve.config``, field for field: :class:`ServiceConfig`
is the one frozen home for every operational knob of
:class:`~repro_torch.serve.market.MarketService` (WAL path and sync mode,
backpressure caps, deadline, checkpoint directory and retention, history
rings, the incremental/async commit knobs), validated at construction so a
typo'd sync mode or a zero retention fails at config time, not at the first
tick.  A config written for the reference service configures this one.

``clock`` / ``rows_cap`` / ``settle_blocks`` default to ``None`` meaning
"derive": the service substitutes its own defaults (``ClockConfig()``,
64, 8) and ``MarketService.from_economy`` substitutes the economy's
values, so one config object works both standalone and bridged.  The
device is not a config field: the service takes it as its own argument.
"""
from __future__ import annotations

import dataclasses

_WAL_SYNC_MODES = ("none", "flush", "fsync")


@dataclasses.dataclass(frozen=True)
class ServiceConfig:
    """Every operational knob of a :class:`~repro_torch.serve.market.MarketService`.

    Settlement shape (``None`` = derive from the economy / defaults):

    * ``clock`` — :class:`~repro_torch.core.auction.ClockConfig` for each tick.
    * ``rows_cap`` — initial book capacity (power-of-two rounded).
    * ``settle_blocks`` — demand-fold block count.

    Ingestion:

    * ``max_pending`` — backpressure cap on fresh pending keys.
    * ``max_quantity`` — per-element |q| bound keeping the f64 ledger exact.
    * ``max_history`` — price/stats history ring length.
    * ``warm_start`` — start the clock at ``max(p_prev, reserve)``.

    Durability:

    * ``wal_path`` / ``wal_sync`` — write-ahead journal and its sync mode
      (``"none"`` | ``"flush"`` | ``"fsync"``).
    * ``checkpoint_dir`` / ``checkpoint_keep`` — tick-boundary checkpoints
      and how many restore points to retain.
    * ``checkpoint_interval`` — cut a record every N binding ticks
      (skipped ticks group-fsync the WAL instead; recovery replays from
      the last record).
    * ``checkpoint_full_every`` — compact the delta chain into a full
      record every N deltas.
    * ``async_commit`` — serialize the record on a background thread and
      block only the *next* tick's commit on its durability.

    Tick bounding / health:

    * ``tick_deadline_s`` — settlement wall-time budget per tick.
    * ``max_escalations`` — bounded ``escalate_clock`` ladder length.
    * ``backoff_base_s`` / ``backoff_cap_s`` — failed-tick retry backoff.
    """

    clock: object | None = None
    rows_cap: int | None = None
    settle_blocks: int | None = None
    max_pending: int = 100_000
    max_quantity: float = 1e6
    max_history: int = 512
    warm_start: bool = True
    wal_path: str | None = None
    wal_sync: str = "flush"
    checkpoint_dir: str | None = None
    checkpoint_keep: int = 2
    checkpoint_interval: int = 1
    checkpoint_full_every: int = 8
    async_commit: bool = False
    tick_deadline_s: float | None = None
    max_escalations: int = 2
    backoff_base_s: float = 1.0
    backoff_cap_s: float = 60.0

    def __post_init__(self) -> None:
        if self.wal_sync not in _WAL_SYNC_MODES:
            raise ValueError(
                f"wal_sync must be one of {_WAL_SYNC_MODES}, "
                f"got {self.wal_sync!r}"
            )
        for name, lo in (
            ("max_pending", 1),
            ("max_history", 1),
            ("checkpoint_keep", 1),
            ("checkpoint_interval", 1),
            ("checkpoint_full_every", 1),
            ("max_escalations", 0),
        ):
            v = getattr(self, name)
            if int(v) != v or int(v) < lo:
                raise ValueError(f"{name} must be an integer >= {lo}, got {v!r}")
        for name in ("rows_cap", "settle_blocks"):
            v = getattr(self, name)
            if v is not None and (int(v) != v or int(v) < 1):
                raise ValueError(f"{name} must be None or an integer >= 1, got {v!r}")
        if not self.max_quantity > 0:
            raise ValueError(f"max_quantity must be > 0, got {self.max_quantity!r}")
        # 0.0 is legal: an already-expired deadline runs exactly one clock
        # attempt and reports deadline_missed — used to pin ladder semantics
        if self.tick_deadline_s is not None and not self.tick_deadline_s >= 0:
            raise ValueError(
                f"tick_deadline_s must be None or >= 0, got {self.tick_deadline_s!r}"
            )
        if not self.backoff_base_s > 0 or not self.backoff_cap_s > 0:
            raise ValueError("backoff_base_s and backoff_cap_s must be > 0")
        if self.async_commit and self.checkpoint_dir is None:
            raise ValueError(
                "async_commit=True requires checkpoint_dir (there is no "
                "record to commit in the background without one)"
            )

    def replace(self, **changes) -> "ServiceConfig":
        """A copy with ``changes`` applied (re-validated)."""
        return dataclasses.replace(self, **changes)
