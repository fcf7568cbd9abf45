"""Always-on market service: durable streaming ingestion over a persistent book.

    PYTHONPATH=src python -m repro_torch.serve.market --agents 2000 --clusters 4 \
        --ticks 3 --churn 0.05 --durable-dir /tmp/market [--device cpu]

Counterpart of ``repro.serve.market``: fed the same delta stream, it settles
the same ticks (prices, rounds, flags, counters and book arrays bit for bit;
payment-derived stats to float tolerance), and its WAL and checkpoints read
in either package.  The paper runs its clock auction "at regular time
intervals" so prices fluctuate like a real economy, which only works if the
next round will happen and standing bids survive it.  This module is the
production shape of that loop: a :class:`MarketService` accepts a *stream*
of :class:`BidDelta` records between auctions (``submit`` / ``withdraw``),
validates and batches them, and settles the book on a ``tick``.

The book is a :class:`repro_torch.core.MarketBook`: host numpy arrays are
the master copy, and a device mirror on the service's ``device`` (the card
unless asked otherwise) receives only the rows written since the last tick.
Each tick settles the mirror read in place as its K-padded book through the
settlement demand fn (:func:`repro_torch.kernels.ops.blocked_bid_demand_fn`:
the ``sparse_bid_eval_partials`` kernel on the card, its plain version on
the CPU), warm-started at ``max(p_prev, reserve)``.  The full repack
(``MarketBook.rebuilt``) is the parity oracle.

Three layers make the loop durable and available:

* **Write-ahead log** (``wal_path=``): every ``submit``/``withdraw`` is
  journaled (:class:`repro_torch.serve.wal.WriteAheadLog`) *before* it is
  acknowledged; recovery replays the tail through the unchanged validation
  path, and last-write-wins pending semantics make the replay idempotent.
* **Tick-boundary checkpoints** (``checkpoint_dir=``): every binding tick
  commits the service state through
  :class:`repro_torch.checkpoint.service.ServiceCheckpointer` (full records
  and dirty-row deltas, ``parity_check()`` as the restore oracle) and then
  compacts the WAL.  Recovery = restore latest checkpoint + replay the WAL
  tail, bit-identical to the uninterrupted service.
* **Deadline-bounded ticks**: ``tick(deadline_s=...)`` bounds wall time
  with a bounded escalation ladder (``escalate_clock`` continuations); on
  deadline miss or non-convergence nothing commits, ``poll_prices`` keeps
  serving the last-good curve, and the :class:`ServiceHealth` machine
  steps healthy → degraded → recovering with exponential-backoff counters.

Backpressure is explicit: a bounded pending queue defers excess
submissions (``bids_deferred``) and validation failures are rejected
loudly (``bids_rejected``); both counters ride on the tick's
:class:`repro_torch.core.economy.EpochStats`.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from ..checkpoint.service import ServiceCheckpointer
from ..core.auction import (
    ClockConfig,
    clock_auction,
    escalate_clock,
    surplus_and_trade,
    verify_system,
)
from ..core.economy import Economy, EpochStats
from ..core.faults import FaultModel
from ..core.reserve import reserve_prices
from ..core.types import MarketBook, as_device
from ..kernels import ops
from ..trace import Stopwatch, traced
from .config import ServiceConfig
from .wal import WriteAheadLog


@dataclasses.dataclass(frozen=True)
class BidDelta:
    """One streamed bid-book mutation.

    ``bundles`` is the XOR list of flat ``(idx, val)`` pairs (the
    ``MarketBook`` row submission format) and ``pi`` the per-bundle (or
    scalar) willingness-to-pay; ``bundles=None`` withdraws the key."""

    key: object
    bundles: Sequence | None = None
    pi: object = None

    @property
    def is_withdraw(self) -> bool:
        return self.bundles is None


def _tolist(x):
    return x.tolist() if isinstance(x, np.ndarray) else x


def _submit_record(delta: BidDelta) -> tuple:
    """WAL record for a submit, with numpy leaves down-converted to plain
    lists: pickling a dozen tiny arrays costs ~4 us apiece in per-object
    overhead, which alone would blow the <2x ingestion-overhead budget.
    The round trip is exact (int32 -> int -> int32; float32 -> float ->
    float32) and validation-faithful (``_pack_row`` re-converts through the
    same ``np.asarray`` calls either way).  Anything that is not a plain
    list/tuple of array pairs journals as-is — the replay path must see
    malformed submissions exactly as the live path did."""
    bundles = delta.bundles
    if isinstance(bundles, (list, tuple)):
        try:
            bundles = [(_tolist(i), _tolist(v)) for i, v in bundles]
        except (TypeError, ValueError):
            bundles = delta.bundles
    return ("submit", delta.key, bundles, _tolist(delta.pi))


@dataclasses.dataclass
class ServiceHealth:
    """Serving-health state machine for the always-on loop.

    ``healthy`` → (failed tick) → ``degraded`` → (one good tick) →
    ``recovering`` → (another good tick) → ``healthy``.  A failed tick is
    one whose settlement did not converge within the deadline-bounded
    escalation ladder; the service keeps serving the last-good curve and
    suggests an exponentially backed-off retry interval.
    """

    state: str = "healthy"  # healthy | degraded | recovering
    consecutive_failures: int = 0
    total_failures: int = 0
    recoveries: int = 0
    retry_backoff_s: float = 0.0
    last_good_epoch: int = -1

    def on_failure(self, base_s: float, cap_s: float) -> None:
        self.consecutive_failures += 1
        self.total_failures += 1
        self.state = "degraded"
        self.retry_backoff_s = min(
            base_s * 2.0 ** (self.consecutive_failures - 1), cap_s
        )

    def on_success(self, epoch: int) -> None:
        if self.state == "degraded":
            self.state = "recovering"
            self.recoveries += 1
        elif self.state == "recovering":
            self.state = "healthy"
        self.consecutive_failures = 0
        self.retry_backoff_s = 0.0
        self.last_good_epoch = epoch


class MarketService:
    """Ingestion front end + periodic settlement over a persistent book.

    Deltas stream in via :meth:`submit` / :meth:`withdraw` (journaled to
    the WAL before acknowledgment when ``wal_path`` is set, validated
    immediately, queued per key — last write wins, so one tick's batch
    never carries duplicate keys).  :meth:`tick` drains the queue into the
    book, syncs the device mirror in O(Δ), and runs one clock auction
    warm-started at ``max(p_prev, reserve)`` under a deadline-bounded
    escalation ladder; :meth:`preview` settles the committed book without
    draining or recording anything.  :meth:`poll_prices` serves the
    last-good settled curve to clients between auctions — including
    through degraded ticks that fail to converge.

    Durability contract: reconstruct the service with the same arguments
    (same ``wal_path`` / ``checkpoint_dir``) after a crash and the
    constructor restores the latest checkpoint (base full + ordered delta
    replay), recovers the WAL's torn tail, and replays the
    un-checkpointed records through the validation path — state is
    bit-identical to the moment before the kill.

    Configuration lives in one frozen :class:`repro_torch.serve.ServiceConfig`
    (``config=``), the reference's fields.  ``device`` places the book's
    mirror and the settlement: the card unless the caller asks for the CPU.

    Each binding tick leaves the host milliseconds of its stages in
    ``last_tick_timings`` (drain, device sync, settle and the CUDA-graph
    capture inside it, commit, the whole tick), each read after the device
    has finished the stage, and of the commit's phases that ran in the
    tick: the record's snapshot, its write and its publish (the rename,
    the prune and the WAL's truncation, or the WAL's sync where no record
    was cut); with a record, how many accounts it encoded
    (``commit_accounts``) and how many of them raw
    (``commit_raw_accounts``).  Each stage and phase is a span of
    :mod:`repro_torch.trace`.
    ``build_timings`` holds the constructor's restore and WAL replay, and
    :meth:`from_economy`'s bulk load and bootstrap record.
    """

    def __init__(
        self,
        base_cost: np.ndarray,
        num_bundles: int,
        k_bound: int,
        *,
        reserve: np.ndarray | None = None,
        faults: FaultModel | None = None,
        config: ServiceConfig | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        cfg = config if config is not None else ServiceConfig()
        self.config = cfg
        self.device = as_device(device)
        self.book = MarketBook(
            base_cost,
            num_bundles,
            k_bound,
            cfg.rows_cap if cfg.rows_cap is not None else 64,
            device=self.device,
        )
        self.reserve = (
            np.asarray(base_cost, np.float64)
            if reserve is None
            else np.asarray(reserve, np.float64)
        )
        if self.reserve.shape != (self.book.num_resources,):
            raise ValueError(
                f"reserve must be ({self.book.num_resources},), "
                f"got {self.reserve.shape}"
            )
        self.clock = cfg.clock if cfg.clock is not None else ClockConfig()
        self.settle_blocks = (
            int(cfg.settle_blocks) if cfg.settle_blocks is not None else 8
        )
        self.max_pending = int(cfg.max_pending)
        # the f64 supply ledger is exact only while every |q| (and their
        # per-pool sums) stays well inside the 2^53 integer window — bound it
        self.max_quantity = float(cfg.max_quantity)
        # bounded history rings: an always-on process must not grow without
        # bound, and warm starts / poll_prices only ever read the tail
        self.max_history = max(int(cfg.max_history), 1)
        self.warm_start = bool(cfg.warm_start)
        self.faults = faults
        self.tick_deadline_s = cfg.tick_deadline_s
        self.max_escalations = int(cfg.max_escalations)
        self.backoff_base_s = float(cfg.backoff_base_s)
        self.backoff_cap_s = float(cfg.backoff_cap_s)
        self.checkpoint_interval = int(cfg.checkpoint_interval)
        self.async_commit = bool(cfg.async_commit)
        self.epoch = 0
        self.price_history: list[np.ndarray] = []
        self.stats_history: list[EpochStats] = []
        self.health = ServiceHealth()
        # key -> ("upsert", packed_row, raw) | ("remove",) — insertion-ordered
        self._pending: dict = {}
        self._rejected = 0
        self._deferred = 0
        self._last_price_epoch = -1
        self._operator_keys: set = set()
        self._test_hooks: dict = {}  # name -> callable, crash-point probes
        self._replaying = False
        self._restored_wal_offset = 0
        self._restored_wal_generation = 0
        self._prices_since_ckpt = 0
        self._stats_since_ckpt = 0
        self._commit_failures = 0
        self.last_tick_timings: dict = {}
        self.build_timings: dict = {}

        # -- crash recovery: checkpoint first, then the WAL tail -------------
        self._ckpt = (
            ServiceCheckpointer(
                cfg.checkpoint_dir,
                keep=cfg.checkpoint_keep,
                full_every=cfg.checkpoint_full_every,
            )
            if cfg.checkpoint_dir is not None
            else None
        )
        t0 = self._now()
        self.restored_step = (
            self._ckpt.restore_latest(self) if self._ckpt is not None else None
        )
        self.build_timings["restore_ms"] = (self._now() - t0) * 1e3
        self._wal = (
            WriteAheadLog(cfg.wal_path, sync=cfg.wal_sync)
            if cfg.wal_path is not None
            else None
        )
        self.replayed_records = 0
        self._wal_drained_offset = 0
        self._durable_wal_offset = 0
        if self._wal is not None:
            if self._wal.generation == self._restored_wal_generation:
                replay_start = self._restored_wal_offset
            else:
                # the log was compacted after the checkpoint was cut, so the
                # stored offset points into a dead generation — everything
                # that survives compaction is post-checkpoint and replays
                replay_start = self._wal.data_start
            t0 = self._now()
            self.replayed_records = self._replay_wal(replay_start)
            self.build_timings["wal_replay_ms"] = (self._now() - t0) * 1e3
            # records at or before this offset are already inside the book
            # (or consumed counters); only the tail past it needs replay
            self._wal_drained_offset = replay_start
            # everything the restored checkpoint covers is durable on disk
            self._durable_wal_offset = replay_start

    # -- ingestion -----------------------------------------------------------

    def _hook(self, name: str) -> None:
        fn = self._test_hooks.get(name)
        if fn is not None:
            fn()

    @traced("service.wal_append")
    def _wal_append(self, record) -> None:
        if self._wal is not None and not self._replaying:
            self._wal.append(record)
            self._hook("mid_ingest")

    def _replay_wal(self, start: int) -> int:
        """Replay the un-checkpointed WAL tail through submit/withdraw.

        Every record goes through the *same* validation, backpressure, and
        last-write-wins queue logic it originally took, so the pending
        queue and counters re-derive exactly; duplicated records (a crash
        between checkpoint and compaction cannot happen thanks to the
        stored generation+offset, but a duplicated client retry can)
        collapse idempotently in the pending dict."""
        self._replaying = True
        count = 0
        try:
            for record, _ in self._wal.records(start):
                if record[0] == "submit":
                    self.submit(BidDelta(record[1], record[2], record[3]))
                elif record[0] == "withdraw":
                    self.withdraw(record[1])
                count += 1
        finally:
            self._replaying = False
        return count

    @traced("service.submit")
    def submit(self, delta: BidDelta) -> bool:
        """Queue one delta for the next tick.  Returns acceptance.

        With a WAL attached the raw attempt is journaled (and flushed per
        the WAL's sync mode) *before* anything is mutated or acknowledged,
        so an accepted delta survives a kill at any later point.  Invalid
        submissions (malformed bundles, out-of-range pools, non-finite or
        oversized quantities) are rejected; fresh keys beyond the
        ``max_pending`` backpressure cap are deferred.  Both outcomes
        return False and surface in the next tick's EpochStats."""
        if delta.is_withdraw:
            return self.withdraw(delta.key)
        self._wal_append(_submit_record(delta))
        if delta.key not in self._pending and len(self._pending) >= self.max_pending:
            self._deferred += 1
            return False
        try:
            row = self.book._pack_row(delta.bundles, delta.pi)
        except (ValueError, TypeError):
            self._rejected += 1
            return False
        if row[1].size and float(np.abs(row[1]).max()) > self.max_quantity:
            self._rejected += 1
            return False
        raw = (
            tuple(
                (np.array(ii, np.int32), np.array(vv, np.float32))
                for ii, vv in delta.bundles
            ),
            np.asarray(delta.pi, np.float32),
        )
        self._pending[delta.key] = ("upsert", row, raw)
        return True

    @traced("service.withdraw")
    def withdraw(self, key) -> bool:
        """Queue a withdrawal.  Unknown keys are rejected (False)."""
        self._wal_append(("withdraw", key))
        pending = self._pending.get(key)
        if pending is not None and pending[0] == "upsert" and key not in self.book:
            # an unsettled submission cancels without ever touching the book
            del self._pending[key]
            return True
        if key not in self.book and pending is None:
            self._rejected += 1
            return False
        self._pending[key] = ("remove",)
        return True

    def poll_prices(self) -> tuple[np.ndarray, int]:
        """Last-good settled price curve (reserve before any tick) + its epoch.

        Degraded ticks never publish here: on non-convergence or a
        deadline miss the previous converged curve keeps serving."""
        if self.price_history:
            return self.price_history[-1].copy(), self._last_price_epoch
        return self.reserve.astype(np.float32).copy(), -1

    @property
    def pending(self) -> int:
        return len(self._pending)

    # -- settlement ----------------------------------------------------------

    def _drain(self) -> tuple[int, int]:
        """Apply the pending queue to the book: one vectorized multi-row
        upsert (keys are unique by construction) plus individual removes."""
        ups = [
            (k, v[1], v[2]) for k, v in self._pending.items() if v[0] == "upsert"
        ]
        removes = [k for k, v in self._pending.items() if v[0] == "remove"]
        if ups:
            keys = [k for k, _, _ in ups]
            self.book.upsert_rows(
                keys,
                np.stack([r[0] for _, r, _ in ups]),
                np.stack([r[1] for _, r, _ in ups]),
                np.stack([r[2] for _, r, _ in ups]),
                np.stack([r[3] for _, r, _ in ups]),
                raw=[raw for _, _, raw in ups],
            )
        withdrawn = sum(self.book.remove(k) for k in removes)
        self._pending.clear()
        if self._wal is not None:
            self._wal_drained_offset = self._wal.offset
        return len(ups), int(withdrawn)

    def _settle(self, problem, start, deadline_s):
        """Deadline-bounded settlement: one clock run plus a bounded
        escalation ladder (``escalate_clock`` continuations from the
        truncated ascending trajectory).  Wall time only decides how much
        of the ladder runs — a committed (converged) result is always
        produced by a deterministic attempt sequence, so recovery re-runs
        settle bit-identically.  Settlement demand is the partials kernel
        (its plain version on the CPU); the wall clock is read once the
        device has finished the attempt."""
        t0 = time.monotonic()
        config = self.clock
        demand_fn = ops.blocked_bid_demand_fn(self.settle_blocks)
        result = clock_auction(problem, start, config, demand_fn=demand_fn)
        escalations = 0
        deadline_missed = (
            deadline_s is not None and self._now() - t0 >= deadline_s
        )
        while (
            not bool(result.converged)
            and not deadline_missed
            and escalations < self.max_escalations
        ):
            config = escalate_clock(config)
            result = clock_auction(problem, result.prices, config, demand_fn=demand_fn)
            escalations += 1
            deadline_missed = (
                deadline_s is not None and self._now() - t0 >= deadline_s
            )
        return result, escalations, deadline_missed

    def _now(self) -> float:
        """Monotonic host seconds, read after the device's queued work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.monotonic()

    def _settled_psi(self, won: np.ndarray, chosen: np.ndarray) -> np.ndarray:
        """Real per-pool utilization of the offered supply: settled buy
        units over the book's exact f64 offered-supply ledger (pools with
        nothing on offer report 0)."""
        r = self.book.num_resources
        offered = self.book.offered_supply()
        won_slots = np.flatnonzero(won)
        if won_slots.size:
            b, k = self.book.num_bundles, self.book.k_bound
            el = (
                (won_slots * b + chosen[won_slots])[:, None] * k
                + np.arange(k)[None, :]
            ).reshape(-1)
            demand = np.bincount(
                self.book.idx[el].astype(np.int64),
                weights=np.maximum(self.book.val[el].astype(np.float64), 0.0),
                minlength=r,
            )
        else:
            demand = np.zeros(r, np.float64)
        return np.divide(
            demand,
            offered,
            out=np.zeros(r, np.float64),
            where=offered > 0,
        )

    def _operator_slot_mask(self) -> np.ndarray:
        is_op = np.zeros(self.book.rows_cap, bool)
        for key in self._operator_keys:
            slot = self.book._key_slot.get(key)
            if slot is not None:
                is_op[slot] = True
        return is_op

    @traced("service.tick")
    def tick(
        self, dry_run: bool = False, deadline_s: float | None = None
    ) -> EpochStats:
        """Settle one auction over the book; binding ticks drain the queue.

        ``deadline_s`` (default: the service's ``tick_deadline_s``) bounds
        the settlement ladder's wall time.  A binding tick *commits* —
        publishes prices, appends history, advances the epoch, checkpoints,
        compacts the WAL — only when the clock converged; otherwise the
        tick is recorded as failed (health machine, backoff counters), the
        last-good curve keeps serving, and nothing is re-queued: drained
        bids rest in the book for the retry, and a crash replays them from
        the WAL.

        A dry run (:meth:`preview`) settles the *committed* book — pending
        deltas stay queued for the next binding tick — and records nothing,
        mirroring ``Economy.preview_prices``'s side-effect-free contract.
        """
        if deadline_s is None:
            deadline_s = self.tick_deadline_s
        watch = Stopwatch(self._now)
        t_start = self._now()
        with watch.stage("service.drain", "drain_ms"):
            if dry_run:
                submitted = withdrawn = 0
            else:
                submitted, withdrawn = self._drain()
                self._hook("post_drain")
        # the mirror read in place as the K-padded book: the same numbers the
        # reference reconstructs from its CSR view, without a per-tick gather
        with watch.stage("service.sync", "sync_ms"):
            problem = self.book.device_padded_problem()
        sync_rows = self.book.last_sync_rows

        dropped = 0
        if self.faults is not None and not self.faults.disabled:
            # bid-stream dropout as a PURE mask overlay: the book is not
            # mutated, so the incremental/full-repack parity is unaffected
            # and the same epoch's dry run sees the identical draw (the
            # fault stream is counter-based on the epoch index)
            draw = self.faults.draw(
                self.epoch, self.book.rows_cap, 1, self.book.num_resources
            )
            if draw.dropout is not None:
                drop = np.asarray(draw.dropout, bool)
                live = self.book.mask.any(axis=1)
                dropped = int((drop & live).sum())
                if dropped:
                    problem = dataclasses.replace(
                        problem,
                        bundle_mask=problem.bundle_mask
                        & ~torch.from_numpy(drop).to(self.device)[:, None],
                    )

        warm = self.warm_start and bool(self.price_history)
        start = (
            np.maximum(self.price_history[-1], self.reserve)
            if warm
            else self.reserve
        )
        captured = ops.capture_stats()["seconds"]
        with watch.stage("service.settle", "settle_ms"):
            result, escalations, deadline_missed = self._settle(
                problem,
                torch.from_numpy(np.asarray(start, np.float32)).to(self.device),
                deadline_s,
            )
        captured = ops.capture_stats()["seconds"] - captured
        prices = result.prices.cpu().numpy()
        converged = bool(result.converged)
        sys_ok = all(verify_system(problem, result).values())
        surplus, trade = surplus_and_trade(problem, result)

        won = result.won.cpu().numpy()
        chosen = np.maximum(result.chosen_bundle.cpu().numpy(), 0)
        pay = result.payments.cpu().numpy().astype(np.float64)
        pi = np.take_along_axis(
            problem.pi.cpu().numpy().astype(np.float64), chosen[:, None], axis=1
        )[:, 0]
        g = won & (np.abs(pay) > 1e-9)
        gammas = np.abs(pi[g] - pay[g]) / np.abs(pay[g])
        base = np.asarray(self.book.base_cost, np.float64)
        # operator rows are supply, not demand: they settle by construction
        # whenever p >= reserve, so they belong in neither side of the
        # "how many bids settled" ratio
        is_op = self._operator_slot_mask()
        agent_rows = self.book.num_rows - int(is_op.sum())
        agent_won = int((won & ~is_op).sum())
        self._hook("post_settle")

        if not dry_run:
            if converged:
                self.health.on_success(self.epoch)
            else:
                self.health.on_failure(self.backoff_base_s, self.backoff_cap_s)

        stats = EpochStats(
            epoch=self.epoch,
            prices=prices,
            reserve=np.asarray(self.reserve),
            psi=self._settled_psi(won, chosen),
            price_ratio=prices / base,
            gamma_median=float(np.median(gammas)) if gammas.size else float("nan"),
            gamma_mean=float(np.mean(gammas)) if gammas.size else float("nan"),
            pct_settled=100.0 * agent_won / max(agent_rows, 1),
            buy_util_percentiles=np.empty(0),
            sell_util_percentiles=np.empty(0),
            migrations=0,
            surplus=float(surplus),
            value_of_trade=float(trade),
            rounds=int(result.rounds),
            converged=converged,
            system_ok=sys_ok,
            warm_started=warm,
            degraded=bool(not converged or dropped or deadline_missed),
            clock_escalations=escalations,
            dropped_bids=dropped,
            bids_submitted=submitted,
            bids_withdrawn=withdrawn,
            bids_rejected=self._rejected,
            bids_deferred=self._deferred,
            deadline_missed=deadline_missed,
            tick_failures=self.health.consecutive_failures,
            retry_backoff_s=self.health.retry_backoff_s,
            health=self.health.state,
        )
        if not dry_run:
            self._rejected = 0
            self._deferred = 0
            if converged:
                self.price_history.append(prices)
                self._last_price_epoch = self.epoch
                self._prices_since_ckpt += 1
                del self.price_history[: -self.max_history]
            self.stats_history.append(stats)
            self._stats_since_ckpt += 1
            del self.stats_history[: -self.max_history]
            self.epoch += 1
            with watch.stage("service.commit", "commit_ms"):
                record = self._commit_durable(watch)
            t_end = self._now()
            # drain, sync, settle, commit and the commit's phases; the
            # accounts a cut record encoded
            self.last_tick_timings = dict(
                watch.ms, sync_rows=sync_rows, capture_ms=captured * 1e3, record=record,
                **(self._ckpt.last_accounts if record is not None else {}),
                tick_ms=(t_end - t_start) * 1e3)
        return stats

    def _settle_async_save(self) -> bool:
        """Resolve the previous tick's in-flight background save, if any.

        Success advances the durable WAL watermark to the offset that save
        covered.  Failure is *this* tick's problem — never silently
        dropped: the failed delta's rows are re-marked dirty (so the next
        record covers both windows), the health machine steps, and the
        commit-failure counter rides on the service."""
        payload, err = self._ckpt.wait_commit(self)
        if payload is None and err is None:
            return True
        if err is not None:
            self._commit_failures += 1
            self.health.on_failure(self.backoff_base_s, self.backoff_cap_s)
            return False
        self._durable_wal_offset = payload.wal_offset
        return True

    def _truncate_wal(self) -> None:
        """Drop the WAL prefix that durable checkpoints already cover.

        Only records at or before ``_durable_wal_offset`` go — an async
        save that has not been waited on yet keeps its tail journaled, so
        a crash during the overlap window replays it."""
        if self._wal is None:
            return
        removed = self._wal.truncate_to(self._durable_wal_offset)
        if removed:
            floor = self._wal.data_start
            self._wal_drained_offset = max(
                self._wal_drained_offset - removed, floor
            )
            self._durable_wal_offset = max(
                self._durable_wal_offset - removed, floor
            )

    def _commit_durable(self, watch: Stopwatch) -> str | None:
        """Tick-boundary durability: checkpoint, then compact the WAL;
        returns the kind of record cut (``"full"`` / ``"delta"``), if any.
        ``watch`` times the phases that are the tick's own: the record's
        snapshot, write and publish, the WAL's truncation or sync with
        them, and with ``async_commit`` the snapshot alone.

        The pending queue is empty here (the tick just drained it), so a
        cut checkpoint covers every drained WAL record.  Ordering contract:

        1. settle the *previous* tick's background save (``async_commit``)
           — its failure fails this tick's commit, stepping health;
        2. cut this tick's record — a dirty-row delta chained to the last
           full checkpoint, or a compacted full every ``full_every``;
        3. only after a record is *durable* does the WAL truncate up to
           the offset that record covers (sync path truncates after its
           own blocking save; async path truncates up to the previous
           save settled in step 1).

        Ticks between ``checkpoint_interval`` boundaries group-fsync the
        WAL instead, as does a service with no checkpointer — committed
        ticks are power-durable even under the cheap per-append flush
        mode."""
        publish = ("service.commit.publish", "commit_publish_ms")
        if self._ckpt is None:
            if self._wal is not None:
                with watch.stage(*publish):
                    self._wal.sync()
            return None
        self._hook("pre_commit_wait")
        self._settle_async_save()
        if self.epoch % self.checkpoint_interval != 0:
            if self._wal is not None:
                with watch.stage(*publish):
                    self._wal.sync()
            return None
        if self.async_commit:
            # truncate to the *previous* save's durable offset before
            # dispatching this one — the new record's tail stays journaled
            # until the next tick proves it durable
            self._truncate_wal()
            self._ckpt.save_async(self, watch=watch)
            if self._wal is not None:
                self._wal.sync()
        else:
            self._ckpt.save(self, block=True, watch=watch)
            if self._wal is not None:
                self._durable_wal_offset = self._wal_drained_offset
                self._hook("post_delta_pre_truncate")
                with watch.stage(*publish):
                    self._truncate_wal()
        return self._ckpt.last_kind

    def flush(self) -> bool:
        """Settle any in-flight background save and sync the WAL.

        Returns False when the settled save had failed (the failure has
        been absorbed into health/counters and the rows re-marked dirty).
        Call before dropping an ``async_commit`` service in-process."""
        ok = True
        if self._ckpt is not None:
            ok = self._settle_async_save()
        if self._wal is not None:
            self._wal.sync()
        return ok

    def checkpoint(self) -> int | None:
        """Cut an out-of-band checkpoint (after bridge loads/syncs, which
        mutate the book without passing through the WAL).  Always a
        blocking save; the WAL truncates up to the drained offset — queued
        records past it must survive until a tick drains them."""
        if self._ckpt is None:
            return None
        self._settle_async_save()
        step = self._ckpt.save(self, block=True)
        if self._wal is not None:
            self._durable_wal_offset = self._wal_drained_offset
            self._truncate_wal()
            self._wal.sync()
        return step

    def preview(self) -> EpochStats:
        """Side-effect-free settlement of the committed book."""
        return self.tick(dry_run=True)

    # -- economy bridge ------------------------------------------------------

    @classmethod
    def from_economy(
        cls,
        eco: Economy,
        *,
        config: ServiceConfig | None = None,
        faults: FaultModel | None = None,
        device: str | torch.device | None = None,
    ) -> "MarketService":
        """Stand up a service over an Economy's current market, on ``device``
        (default: the economy's).

        Operator supply (the free capacity of every pool, priced at the
        reserve curve) and every agent's sticky buy bid
        (``Economy.export_bid_rows``) are bulk-loaded; afterwards
        :meth:`sync_from_economy` keeps agent rows current in O(Δ) via the
        economy's dirty-uid tracking.  Operator rows are snapshot at bridge
        time (a production deployment would re-quote them per tick).

        The config's ``None`` settlement-shape fields (``clock`` /
        ``settle_blocks`` / ``rows_cap``) derive from the economy, so the
        bridged service settles exactly like the simulator it mirrors.

        With ``checkpoint_dir`` set, a prior checkpoint wins: the restored
        book already holds the bridged rows, so the bulk load is skipped
        and the service resumes where it crashed.  A fresh durable bridge
        cuts a bootstrap checkpoint, because the bulk load bypasses the
        WAL."""
        base_cost = np.tile(eco.base_cost_rt, eco.C).astype(np.float32)
        reserve = np.asarray(reserve_prices(eco.pools(), eco.weighting))
        cfg = config if config is not None else ServiceConfig()
        derived = {}
        if cfg.clock is None:
            derived["clock"] = eco.clock
        if cfg.settle_blocks is None:
            derived["settle_blocks"] = eco.settle_blocks
        if cfg.rows_cap is None:
            derived["rows_cap"] = max(len(eco.pop) + eco.R, 64)
        if derived:
            cfg = cfg.replace(**derived)
        svc = cls(
            base_cost, num_bundles=eco.C, k_bound=eco.T,
            reserve=reserve, faults=faults, config=cfg,
            device=eco.device if device is None else device,
        )
        if svc.restored_step is not None:
            return svc
        t0 = svc._now()
        free = np.maximum(eco.capacity - eco.usage, 0.0).reshape(-1)
        for r in np.flatnonzero(free > 1e-9):
            svc.book.upsert(
                f"op-{r}",
                [(np.array([r], np.int32), np.array([-free[r]], np.float32))],
                [float(-free[r] * reserve[r])],
            )
            svc._operator_keys.add(f"op-{r}")
        svc.book.upsert_rows(*eco.export_bid_rows())
        t1 = svc._now()
        svc.build_timings["load_ms"] = (t1 - t0) * 1e3
        if svc._ckpt is not None:
            svc.checkpoint()
            svc.build_timings["bootstrap_ms"] = (svc._now() - t1) * 1e3
        return svc

    def sync_from_economy(self, eco: Economy) -> tuple[int, int]:
        """Drain the economy's dirty-bid deltas into the book (O(Δ)).

        Bridge syncs bypass the WAL (they are derived from the economy's
        own durable state), so a durable service cuts a checkpoint right
        after.  Returns ``(upserted, withdrawn)``."""
        withdraw_keys, upserts = eco.drain_bid_deltas()
        withdrawn = sum(self.book.remove(k) for k in withdraw_keys)
        if upserts[0]:
            self.book.upsert_rows(*upserts)
        if self._ckpt is not None and (upserts[0] or withdrawn):
            self.checkpoint()
        return len(upserts[0]), int(withdrawn)


# -- driver ------------------------------------------------------------------


def main(argv=None):
    from ..core.markets import fleet_economy

    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=2000)
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--ticks", type=int, default=3)
    ap.add_argument("--churn", type=float, default=0.05,
                    help="fraction of agents re-pricing their bid per tick")
    ap.add_argument("--withdraw-frac", type=float, default=0.01,
                    help="fraction of agents withdrawing their bid per tick")
    ap.add_argument("--dropout", type=float, default=0.0,
                    help="per-tick bid-stream dropout probability (fault)")
    ap.add_argument("--durable-dir", default=None,
                    help="directory for WAL + checkpoints (enables kill-resume)")
    ap.add_argument("--async-commit", action="store_true",
                    help="cut checkpoints on a background thread")
    ap.add_argument("--kill-resume", action="store_true",
                    help="drop the service mid-horizon and resume from disk")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import os

    eco = fleet_economy(args.agents, args.clusters, seed=args.seed, device=args.device)
    cfg = ServiceConfig()
    if args.durable_dir:
        os.makedirs(args.durable_dir, exist_ok=True)
        cfg = cfg.replace(
            wal_path=os.path.join(args.durable_dir, "market.wal"),
            checkpoint_dir=os.path.join(args.durable_dir, "ckpt"),
            async_commit=args.async_commit,
        )
    faults = (
        FaultModel(bid_dropout=args.dropout, seed=args.seed)
        if args.dropout > 0
        else None
    )
    svc = MarketService.from_economy(eco, config=cfg, faults=faults)
    rng = np.random.default_rng(args.seed)
    print(
        f"[market] book: {svc.book.num_rows} rows "
        f"({svc.book.rows_cap} slots, {svc.book.nnz_cap} nnz cap)",
        flush=True,
    )
    keys, idx_rows, val_rows, mask_rows, pi_rows = eco.export_bid_rows()
    live = np.flatnonzero(mask_rows.any(axis=1))
    withdrawn_keys: set = set()
    for t in range(args.ticks):
        n_delta = max(1, int(args.churn * args.agents))
        pick = rng.choice(live, size=min(n_delta, live.size), replace=False)
        scale = rng.uniform(0.9, 1.1, size=pick.size).astype(np.float32)
        for j, i in enumerate(pick):
            if keys[i] in withdrawn_keys:
                withdrawn_keys.discard(keys[i])  # re-submission revives it
            bundles = [
                (idx_rows[i, b], val_rows[i, b])
                for b in np.flatnonzero(mask_rows[i])
            ]
            pi = pi_rows[i][mask_rows[i]] * scale[j]
            svc.submit(BidDelta(keys[i], bundles, pi))
        n_wd = int(args.withdraw_frac * args.agents)
        if n_wd:
            for i in rng.choice(live, size=min(n_wd, live.size), replace=False):
                if keys[i] not in withdrawn_keys and svc.withdraw(keys[i]):
                    withdrawn_keys.add(keys[i])
        if args.kill_resume and args.durable_dir and t == args.ticks // 2:
            pend = svc.pending
            del svc  # hard drop mid-horizon: no checkpoint, no drain
            svc = MarketService.from_economy(eco, config=cfg, faults=faults)
            print(
                f"[market] killed + resumed: epoch {svc.epoch}, "
                f"{svc.replayed_records} WAL records replayed, "
                f"{svc.pending}/{pend} pending reconstructed",
                flush=True,
            )
        t0 = time.time()
        s = svc.tick()
        dt = time.time() - t0
        print(
            f"[market] tick {t}: {s.bids_submitted} bids in, "
            f"{s.bids_withdrawn} out, {s.dropped_bids} dropped, "
            f"{s.rounds} rounds, converged={s.converged}, "
            f"health={s.health}, pct_settled={s.pct_settled:.1f}%, "
            f"peak psi={s.psi.max():.2f}, {dt*1e3:.0f} ms",
            flush=True,
        )
    svc.book.parity_check()
    print("[market] incremental book bit-identical to full repack", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
