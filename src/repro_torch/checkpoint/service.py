"""Crash-recoverable market service state (tick-boundary checkpointing).

Counterpart of ``repro.checkpoint.service``, record for record: a record cut
by either package restores in the other.  :class:`ServiceCheckpointer`
persists the always-on :class:`~repro_torch.serve.market.MarketService` on
the shared :class:`~repro_torch.checkpoint.store.CheckpointStore` protocol,
with two commit-latency measures:

**Incremental delta chain.**  A full record (``ckpt_%08d``) persists the
complete service state.  In between, each binding tick cuts a *delta*
record (``delta_%08d``) carrying only what changed since the previous
record: the book rows dirtied in the window
(``MarketBook.export_dirty_state``), the price / stats history rows
appended in the window, the tiny O(R) ledgers and counters, and a
``parent_step`` pointer.  Every ``full_every`` deltas (or whenever a delta
cannot represent the window: ring overflow, a re-save at the same
boundary) the chain compacts into a fresh full record.  Restore walks the
parent pointers back to the base full, replays the deltas in order, and
runs ``parity_check()`` once at the end.

**Async commit.**  ``save_async`` snapshots the state at the commit point
(delta exports are fancy-indexed copies; full exports are copied
explicitly) and writes the record on a background thread, which touches
only those host copies, never the book's device mirror; the *next* tick's
commit joins it via ``wait_commit``.  A failed background write is never
dropped: ``wait_commit`` rolls the snapshot back (re-marks the delta's
dirty rows, re-counts the history tails, rewinds the chain state) and
returns the error so the service can fail *that* tick's commit and step
its health machine.  The WAL is only truncated up to the offset a
*durable* record covers.

Keep-N pruning is delta-chain aware: the newest ``keep`` restore points
are kept together with every record their chains reference, so a base
full is never deleted while deltas still point at it.
"""
from __future__ import annotations

import dataclasses
import threading

import numpy as np

from ..core.economy import EpochStats
from ..core.types import MarketBook
from .store import CheckpointStore

# EpochStats fields that are numpy arrays (stacked across the history ring);
# everything else is a JSON scalar.  Derived once from the dataclass, whose
# fields are the reference's in the same order, so the JSON scalars decode
# across packages.
_STATS_FIELDS = [f.name for f in dataclasses.fields(EpochStats)]
_STATS_ARRAY_FIELDS = (
    "prices",
    "reserve",
    "psi",
    "price_ratio",
    "buy_util_percentiles",
    "sell_util_percentiles",
)

_FULL = "ckpt"
_DELTA = "delta"


@dataclasses.dataclass
class _Payload:
    """One commit's snapshot, stable against in-flight tick mutation."""

    kind: str  # "full" | "delta"
    step: int
    tree: dict
    meta: dict
    hook: object  # svc._hook — crash probes fire from the writer too
    dirty_slots: list  # delta only: rows to re-mark if the write fails
    n_prices: int  # history-tail rows this record consumed
    n_stats: int
    wal_offset: int  # drained offset this record covers (current coords)
    prev_last_step: int | None  # chain state to rewind to on failure
    prev_deltas_since_full: int
    prev_base_step: int | None


class ServiceCheckpointer(CheckpointStore):
    """Persist/restore full mutable MarketService state at tick boundaries."""

    def __init__(self, directory: str, keep: int = 2, full_every: int = 8):
        super().__init__(directory)
        # an always-on service checkpoints every tick forever; retain only
        # the newest ``keep`` restore points (>= 2 so a crash mid-save of
        # step N can still fall back to step N-1) plus whatever their delta
        # chains reference
        self.keep = max(int(keep), 1)
        self.full_every = max(int(full_every), 1)
        self._last_step: int | None = None  # newest durable/snapshotted step
        self._base_step: int | None = None  # full record anchoring the chain
        self._deltas_since_full = 0
        self._force_full = False  # set after a failed full write
        self._inflight: _Payload | None = None
        self.last_kind: str | None = None  # "full" | "delta": the newest record cut
        self._lock = threading.Lock()  # prune vs. read listing

    # -- write ----------------------------------------------------------------

    def _stats_tree(self, history: list[EpochStats]) -> dict[str, np.ndarray]:
        tree = {}
        for name in _STATS_ARRAY_FIELDS:
            if history:
                tree[f"stats/{name}"] = np.stack(
                    [np.asarray(getattr(s, name)) for s in history]
                )
            else:
                tree[f"stats/{name}"] = np.zeros((0, 0))
        return tree

    def _stats_scalars(self, history: list[EpochStats]) -> list[dict]:
        return [
            {
                name: _jsonable(getattr(s, name))
                for name in _STATS_FIELDS
                if name not in _STATS_ARRAY_FIELDS
            }
            for s in history
        ]

    def _service_meta(self, svc) -> dict:
        return {
            "epoch": int(svc.epoch),
            "rejected": int(svc._rejected),
            "deferred": int(svc._deferred),
            "last_price_epoch": int(svc._last_price_epoch),
            "operator_keys": sorted(svc._operator_keys),
            "health": dataclasses.asdict(svc.health),
            "wal_offset": (
                int(svc._wal_drained_offset) if svc._wal is not None else 0
            ),
            "wal_generation": (
                int(svc._wal.generation) if svc._wal is not None else 0
            ),
        }

    def _snapshot(self, svc, force_full: bool = False, copy: bool = False):
        """Capture one commit's state as a :class:`_Payload`.

        Advances the chain state and clears the book's dirty set / the
        service's history-tail counters — :meth:`_rollback` is the undo if
        the write never becomes durable.
        """
        step = int(svc.epoch)
        n_prices = int(getattr(svc, "_prices_since_ckpt", 0))
        n_stats = int(getattr(svc, "_stats_since_ckpt", 0))
        full = (
            force_full
            or self._force_full
            or self._last_step is None
            # full_every=1 means every record is self-contained; larger
            # values let full_every deltas ride each base before compacting
            or self.full_every == 1
            or self._deltas_since_full >= self.full_every
            # an out-of-band re-save at the same boundary (bridge sync)
            # cannot chain off itself — self-contain it
            or step == self._last_step
            # the history rings trimmed rows the window appended: a delta
            # tail can no longer represent the window
            or n_prices > len(svc.price_history)
            or n_stats > len(svc.stats_history)
        )
        prev = (self._last_step, self._deltas_since_full, self._base_step)

        if full:
            book_arrays, book_meta = svc.book.export_state(clear_dirty=True)
            tree = {f"book/{k}": v for k, v in book_arrays.items()}
            tree["reserve"] = svc.reserve
            tree["price_history"] = (
                np.stack(svc.price_history)
                if svc.price_history
                else np.zeros((0, svc.book.num_resources), np.float32)
            )
            tree.update(self._stats_tree(svc.stats_history))
            if copy:
                # export_state aliases live book storage; a background
                # writer must not race the next tick's row writes
                tree = {k: np.array(v, copy=True) for k, v in tree.items()}
            meta = {
                "book": book_meta,
                "stats_scalars": self._stats_scalars(svc.stats_history),
                **self._service_meta(svc),
            }
            dirty: list = []
        else:
            dirty = sorted(svc.book._ckpt_dirty)
            book_arrays, book_meta = svc.book.export_dirty_state(clear=True)
            tree = {f"book/{k}": v for k, v in book_arrays.items()}
            tree["reserve"] = np.array(svc.reserve, copy=True)
            r = svc.book.num_resources
            tree["price_tail"] = (
                np.stack(svc.price_history[-n_prices:])
                if n_prices
                else np.zeros((0, r), np.float32)
            )
            stats_tail = svc.stats_history[-n_stats:] if n_stats else []
            tree.update(self._stats_tree(stats_tail))
            meta = {
                "book": book_meta,
                "stats_scalars": self._stats_scalars(stats_tail),
                "n_prices": n_prices,
                "n_stats": n_stats,
                "parent_step": int(self._last_step),
                "base_step": (
                    int(self._base_step) if self._base_step is not None else None
                ),
                **self._service_meta(svc),
            }

        payload = _Payload(
            kind="full" if full else "delta",
            step=step,
            tree=tree,
            meta=meta,
            hook=getattr(svc, "_hook", lambda name: None),
            dirty_slots=dirty,
            n_prices=n_prices,
            n_stats=n_stats,
            wal_offset=meta["wal_offset"],
            prev_last_step=prev[0],
            prev_deltas_since_full=prev[1],
            prev_base_step=prev[2],
        )
        svc._prices_since_ckpt = 0
        svc._stats_since_ckpt = 0
        self._last_step = step
        self.last_kind = payload.kind
        if full:
            self._base_step = step
            self._deltas_since_full = 0
            self._force_full = False
        else:
            self._deltas_since_full += 1
        return payload

    def _rollback(self, payload: _Payload, svc) -> None:
        """Undo a snapshot whose record never became durable."""
        if payload.kind == "delta":
            svc.book.mark_dirty(payload.dirty_slots)
        else:
            # the failed full export cleared the whole dirty set; only
            # another full can re-establish a delta baseline
            self._force_full = True
        svc._prices_since_ckpt += payload.n_prices
        svc._stats_since_ckpt += payload.n_stats
        self._last_step = payload.prev_last_step
        self._deltas_since_full = payload.prev_deltas_since_full
        self._base_step = payload.prev_base_step

    def _write_payload(self, payload: _Payload) -> None:
        prefix = _FULL if payload.kind == "full" else _DELTA
        probe = "mid_compaction" if payload.kind == "full" else "mid_delta"
        self.write_record(
            prefix,
            payload.step,
            payload.tree,
            metadata=payload.meta,
            pre_replace=lambda: payload.hook(probe),
        )
        if payload.kind == "full":
            # the new full supersedes the old chain; the probe below kills
            # between the replace and the prune (both generations on disk)
            payload.hook("post_compaction")
        self._prune()

    def save(self, svc, block: bool = True, force_full: bool = False) -> int:
        """Checkpoint at the current tick boundary; returns the step.

        The step is ``svc.epoch`` — the number of binding ticks committed.
        Chooses full vs. delta automatically (``force_full`` overrides);
        ``block=False`` is :meth:`save_async`.  Any in-flight background
        save is settled first; its failure raises here (callers that want
        graceful failure semantics settle via :meth:`wait_commit`
        themselves, as the service's commit path does)."""
        _, err = self.wait_commit(svc)
        if err is not None:
            raise err
        if not block:
            return self.save_async(svc, force_full=force_full)
        payload = self._snapshot(svc, force_full=force_full)
        try:
            self._write_payload(payload)
        except BaseException:
            self._rollback(payload, svc)
            raise
        return payload.step

    def save_async(self, svc, force_full: bool = False) -> int:
        """Cut the snapshot now, write it on a background thread.

        Overlaps serialization with the next tick's settlement; the next
        commit joins via :meth:`wait_commit`.  The snapshot is stable by
        construction (copied arrays), so the in-flight tick can mutate the
        book freely."""
        _, err = self.wait_commit(svc)
        if err is not None:
            raise err
        payload = self._snapshot(svc, force_full=force_full, copy=True)
        self._inflight = payload

        def work():
            try:
                payload.hook("pre_delta_write")
                self._write_payload(payload)
            except BaseException as e:  # surfaced by wait_commit
                self._thread_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        return payload.step

    def wait_commit(self, svc) -> tuple[_Payload | None, BaseException | None]:
        """Join the in-flight background save, if any.

        Returns ``(payload, error)``.  On success the caller may advance
        its durable WAL frontier to ``payload.wal_offset``.  On failure the
        snapshot has already been rolled back (dirty rows re-marked,
        history tails re-counted, chain state rewound) — the caller must
        treat its current commit as failed rather than silently dropping
        durability."""
        payload, self._inflight = self._inflight, None
        try:
            self.wait()
        except BaseException as e:
            if payload is not None:
                self._rollback(payload, svc)
            return payload, e
        return payload, None

    # -- prune ----------------------------------------------------------------

    def _parent_of(self, step: int) -> int | None:
        try:
            meta = self.read_manifest(_DELTA, step)["metadata"]
        except OSError:
            return None
        parent = meta.get("parent_step")
        return int(parent) if parent is not None else None

    def _prune(self) -> None:
        """Delete records no restore point references.

        A restore point is any on-disk step; the newest ``keep`` of them
        survive, together with every record their chains walk through —
        so a base full is never deleted while a kept delta still chains
        to it (the bug the old full-only pruning had)."""
        with self._lock:
            fulls = set(self.record_steps(_FULL))
            deltas = set(self.record_steps(_DELTA))
            points = sorted(fulls | deltas, reverse=True)[: self.keep]
            required: set[tuple[str, int]] = set()
            for point in points:
                step: int | None = point
                while step is not None and (_FULL, step) not in required:
                    if step in fulls:
                        # a full at this step self-contains the chain
                        required.add((_FULL, step))
                        break
                    if step not in deltas or (_DELTA, step) in required:
                        break
                    required.add((_DELTA, step))
                    step = self._parent_of(step)
            for step in fulls:
                if (_FULL, step) not in required:
                    self.remove_record(_FULL, step)
            for step in deltas:
                if (_DELTA, step) not in required:
                    self.remove_record(_DELTA, step)

    # -- read -----------------------------------------------------------------

    def _check_book_shape(self, book_meta: dict, svc) -> None:
        if (
            book_meta["num_resources"] != svc.book.num_resources
            or book_meta["num_bundles"] != svc.book.num_bundles
            or book_meta["k_bound"] != svc.book.k_bound
        ):
            raise ValueError(
                f"checkpoint is for a (R={book_meta['num_resources']}, "
                f"B={book_meta['num_bundles']}, K={book_meta['k_bound']}) "
                f"book, got (R={svc.book.num_resources}, "
                f"B={svc.book.num_bundles}, K={svc.book.k_bound}) — "
                "reconstruct the same service before restoring"
            )

    def _restore_full(self, step: int, svc) -> None:
        tree, manifest = self.read_record(_FULL, step)
        meta = manifest["metadata"]
        book_meta = meta["book"]
        self._check_book_shape(book_meta, svc)
        book_arrays = {
            k[len("book/") :]: v for k, v in tree.items() if k.startswith("book/")
        }
        svc.book = MarketBook.from_state(book_arrays, book_meta, svc.device)
        svc.reserve = np.asarray(tree["reserve"], np.float64)
        svc.price_history = [row.copy() for row in tree["price_history"]]
        svc.stats_history = _decode_stats(tree, meta["stats_scalars"])
        self._apply_service_meta(meta, svc)

    def _apply_delta(self, step: int, svc) -> None:
        tree, manifest = self.read_record(_DELTA, step)
        meta = manifest["metadata"]
        book_meta = meta["book"]
        self._check_book_shape(book_meta, svc)
        book_arrays = {
            k[len("book/") :]: v for k, v in tree.items() if k.startswith("book/")
        }
        svc.book.apply_dirty_state(book_arrays, book_meta)
        svc.reserve = np.asarray(tree["reserve"], np.float64)
        max_history = int(getattr(svc, "max_history", 0)) or None
        for row in tree["price_tail"]:
            svc.price_history.append(row.copy())
        svc.stats_history.extend(_decode_stats(tree, meta["stats_scalars"]))
        if max_history:
            # mirror the live ring trim exactly, so the restored rings are
            # bit-identical to the uninterrupted service's
            del svc.price_history[:-max_history]
            del svc.stats_history[:-max_history]
        self._apply_service_meta(meta, svc)

    def _apply_service_meta(self, meta: dict, svc) -> None:
        svc.epoch = int(meta["epoch"])
        svc._rejected = int(meta["rejected"])
        svc._deferred = int(meta["deferred"])
        svc._last_price_epoch = int(meta["last_price_epoch"])
        svc._operator_keys = set(meta["operator_keys"])
        svc.health = type(svc.health)(**meta["health"])
        svc._pending.clear()
        svc._prices_since_ckpt = 0
        svc._stats_since_ckpt = 0
        svc._restored_wal_offset = int(meta.get("wal_offset", 0))
        svc._restored_wal_generation = int(meta.get("wal_generation", 0))

    def restore(self, step: int, svc) -> int:
        """Overwrite ``svc``'s mutable state from *full* checkpoint ``step``."""
        self._restore_full(step, svc)
        # restore oracle: the incremental arrays must match a from-scratch
        # repack of the restored raw accounts, or the checkpoint is corrupt
        svc.book.parity_check()
        self._last_step = self._base_step = step
        self._deltas_since_full = 0
        return step

    def restore_latest(self, svc) -> int | None:
        """Restore the newest restorable state into ``svc``.

        Walks the newest record's parent chain back to its base full, then
        replays base + deltas in order; ``parity_check()`` asserts the
        result bit-matches a from-scratch repack.  A broken chain (orphan
        delta) falls back to the newest full.  Returns the restored step,
        or None if the directory holds nothing."""
        fulls = set(self.record_steps(_FULL))
        deltas = set(self.record_steps(_DELTA))
        if not fulls and not deltas:
            return None
        target = max(fulls | deltas)
        chain: list[int] | None = []
        step = target
        while step not in fulls:
            if step not in deltas:
                chain = None  # orphan delta: chain broken
                break
            chain.append(step)
            parent = self._parent_of(step)
            if parent is None:
                chain = None
                break
            step = parent
        if chain is None:
            if not fulls:
                raise ValueError(
                    f"no restorable checkpoint in {self.dir!r}: delta chain "
                    "is broken and no full base exists"
                )
            step, chain = max(fulls), []
        base = step
        self._restore_full(base, svc)
        for s in reversed(chain):
            self._apply_delta(s, svc)
        svc.book.parity_check()
        self._base_step = base
        self._deltas_since_full = len(chain)
        self._last_step = chain[0] if chain else base
        return self._last_step


def _jsonable(v):
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    return v


def _decode_stats(tree: dict, scalars: list[dict]) -> list[EpochStats]:
    out = []
    for i, rec in enumerate(scalars):
        fields = dict(rec)
        for name in _STATS_ARRAY_FIELDS:
            fields[name] = np.asarray(tree[f"stats/{name}"][i])
        out.append(EpochStats(**fields))
    return out
