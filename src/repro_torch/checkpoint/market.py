"""Crash-recoverable market state (epoch-boundary checkpointing).

Counterpart of ``repro.checkpoint.market``, record for record: a record cut
by either package restores in the other.  :class:`MarketCheckpointer`
persists the full mutable state of an :class:`~repro_torch.core.economy.
Economy` at epoch boundaries, so a horizon killed mid-run resumes
bit-identically.  The state is :func:`~repro_torch.core.state.economy_state`'s
tree (the population's arrays, pool state, the settled price history and
the epoch-to-epoch carry arrays, under the reference's keys) plus the bid
RNG's exact PCG64 state as JSON metadata (its counters exceed 64 bits,
which npz integers would wrap).

Fault injection needs no persistence: :class:`~repro_torch.core.faults.
FaultModel` draws are counter-based on ``(seed, epoch, channel)``, so a
resumed horizon replays the identical fault sequence.

The restore contract is *reconstruct, then restore*: build the same economy
(same constructor arguments) and call :meth:`MarketCheckpointer.restore_latest`,
which overwrites every mutable field.
"""
from __future__ import annotations

import numpy as np

from ..core.economy import Economy
from ..core.state import economy_state, load_economy_state
from .store import CheckpointStore


class MarketCheckpointer(CheckpointStore):
    """Persist/restore full mutable Economy state at epoch boundaries."""

    def save(self, eco: Economy, block: bool = True) -> int:
        """Checkpoint at the current epoch boundary; returns the step.

        The step is ``len(price_history)``, the number of settled epochs, so
        saving after each binding ``run_epoch`` yields one checkpoint per
        epoch and ``restore_latest`` resumes from the newest boundary.  With
        ``block=False`` the record is written on a background thread from a
        copy of the state taken now.
        """
        step = len(eco.price_history)
        tree, rng_state = economy_state(eco)
        meta = {"rng_state": rng_state, "num_agents": len(eco.pop)}
        if block:
            self.wait()
            self.write_record("ckpt", step, tree, metadata=meta)
        else:
            tree = {k: np.array(v, copy=True) for k, v in tree.items()}
            self.write_record_async("ckpt", step, tree, metadata=meta)
        return step

    def restore(self, step: int, eco: Economy) -> int:
        """Overwrite ``eco``'s mutable state from checkpoint ``step``."""
        tree, manifest = self.read_record("ckpt", step)
        load_economy_state(eco, tree, manifest["metadata"]["rng_state"])
        return step

    def restore_latest(self, eco: Economy) -> int | None:
        """Restore the newest checkpoint into ``eco``; None if none exist."""
        step = self.latest_step("ckpt")
        if step is None:
            return None
        return self.restore(step, eco)
