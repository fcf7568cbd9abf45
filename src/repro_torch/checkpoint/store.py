"""Shared atomic record store behind the market and service checkpointers.

Counterpart of ``repro.checkpoint.store``, record for record:
:class:`~repro_torch.checkpoint.market.MarketCheckpointer` and
:class:`~repro_torch.checkpoint.service.ServiceCheckpointer` share one
on-disk protocol: write ``arrays.npz`` + ``manifest.json`` into a
``.tmp.*`` staging directory, ``os.replace`` it into place, read the npz
back with the manifest dtypes (float64 state stays float64), and prune old
steps.  A record cut by either package reads in the other.

Record layout::

  <dir>/<prefix>_%08d/
      manifest.json   # {"step", "keys" (sorted), "shapes", "dtypes",
                      #  "metadata"} in exactly that insertion order
      arrays.npz      # one member per key, written in sorted-key order

``np.savez`` stamps every zip member with the ZipInfo default epoch, so
the same arrays always produce the same bytes.  A tensor leaf is brought
to the host first (``.detach().cpu().numpy()``); every other leaf goes
through ``np.asarray``.

Multiple prefixes can share one directory (the service checkpointer
stores full records as ``ckpt_*`` and incremental ones as ``delta_*``);
``record_steps`` filters by prefix.  Writes are crash-atomic: a kill
mid-write leaves only a ``.tmp.*`` directory, which every reader ignores.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading

import numpy as np


def _host(leaf) -> np.ndarray:
    """A record leaf as a host array: tensors leave their device."""
    if hasattr(leaf, "detach"):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


class CheckpointStore:
    """Atomic manifest+npz record read/write/prune, shared by subclasses."""

    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._thread_error: BaseException | None = None

    # -- write ----------------------------------------------------------------

    def write_record(
        self,
        prefix: str,
        step: int,
        tree: dict,
        metadata: dict | None = None,
        pre_replace=None,
    ) -> str:
        """Atomically persist one record; returns its directory name.

        ``tree`` is a flat ``{key: array}`` dict (keys may contain ``/``).
        ``pre_replace`` is an optional callback fired after the staging
        directory is fully written but *before* the atomic rename — the
        crash-probe point the recovery suite kills at (a record must be
        all-or-nothing, never half-visible).
        """
        staged = self.stage_record(prefix, step, tree, metadata)
        if pre_replace is not None:
            pre_replace()
        return self.publish_record(staged)

    def stage_record(
        self, prefix: str, step: int, tree: dict, metadata: dict | None = None
    ) -> tuple[str, str]:
        """The first half of :meth:`write_record`: the host copies, the npz
        and the manifest, in the record's staging directory, which no reader
        sees.  Returns ``(staging directory, final directory)``."""
        host = {k: _host(tree[k]) for k in sorted(tree.keys())}
        manifest = {
            "step": int(step),
            "keys": sorted(host.keys()),
            "shapes": {k: list(v.shape) for k, v in host.items()},
            "dtypes": {k: str(v.dtype) for k, v in host.items()},
            "metadata": metadata or {},
        }
        name = f"{prefix}_{step:08d}"
        tmp = os.path.join(self.dir, f".tmp.{name}")
        final = os.path.join(self.dir, name)
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        return tmp, final

    def publish_record(self, staged: tuple[str, str]) -> str:
        """The second half of :meth:`write_record`: the staged record
        renamed into place (replacing one of the same step); returns its
        directory name."""
        tmp, final = staged
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        return os.path.basename(final)

    def write_record_async(self, *args, **kwargs) -> None:
        """Run :meth:`write_record` on a background thread (one in flight).

        A previous in-flight write is joined first; its error, if any, is
        re-raised *here* — a failed write is surfaced at the next commit
        attempt, never dropped."""
        self.wait()

        def work():
            try:
                self.write_record(*args, **kwargs)
            except BaseException as e:  # surfaced by wait()
                self._thread_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Join any in-flight background write; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._thread_error is not None:
            err, self._thread_error = self._thread_error, None
            raise err

    # -- read -----------------------------------------------------------------

    def record_path(self, prefix: str, step: int) -> str:
        return os.path.join(self.dir, f"{prefix}_{step:08d}")

    def has_record(self, prefix: str, step: int) -> bool:
        return os.path.isdir(self.record_path(prefix, step))

    def read_manifest(self, prefix: str, step: int) -> dict:
        with open(os.path.join(self.record_path(prefix, step), "manifest.json")) as f:
            return json.load(f)

    def read_record(self, prefix: str, step: int) -> tuple[dict, dict]:
        """Read one record as ``({key: array}, manifest)``.

        Arrays come back as host numpy with the manifest dtypes, so float64
        state stays float64.
        """
        manifest = self.read_manifest(prefix, step)
        data = np.load(
            os.path.join(self.record_path(prefix, step), "arrays.npz")
        )
        tree = {
            k: data[k].astype(np.dtype(manifest["dtypes"][k]), copy=False)
            for k in manifest["keys"]
        }
        return tree, manifest

    def record_steps(self, prefix: str) -> list[int]:
        """All on-disk steps for ``prefix``, ascending."""
        steps = []
        pat = re.compile(re.escape(prefix) + r"_(\d+)")
        for name in os.listdir(self.dir):
            m = pat.fullmatch(name)
            if m:
                steps.append(int(m.group(1)))
        return sorted(steps)

    def latest_step(self, prefix: str = "ckpt") -> int | None:
        steps = self.record_steps(prefix)
        return steps[-1] if steps else None

    # -- prune ----------------------------------------------------------------

    def remove_record(self, prefix: str, step: int) -> None:
        shutil.rmtree(self.record_path(prefix, step), ignore_errors=True)
