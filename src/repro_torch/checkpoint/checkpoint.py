"""Atomic, asynchronous training checkpoints (the port of
``repro.checkpoint.checkpoint``).

Layout, one directory a step, the reference's:

  <dir>/ckpt_00001234/
      manifest.json      # step, keys, shapes/dtypes, user metadata
      arrays.npz         # one entry a leaf (key = the leaf's path)

A leaf's key is its path in the tree, dict keys and list indices joined by
``/``, dict keys in sorted order, as the reference's
``tree_flatten_with_path`` names them; so a checkpoint written by either
package restores in the other, bit for bit.  Writes go to
``<dir>/.tmp.<step>`` and are ``os.replace``d into place: a crash in the
middle of a write never corrupts the latest checkpoint.  ``save`` copies
the tree to the host at once and writes the files on a background thread;
``wait()`` (or the next ``save``) joins it.  ``restore`` puts each array on
the target leaf's device in its dtype: a job restores onto whatever device
its new grant gives it.

Sharded trees (DTensor leaves, ``sharding.use_mesh``): ``save`` gathers
each leaf (``full_tensor()``, a collective every rank joins), then rank 0
writes, synchronously, and every rank waits at a barrier: two ranks
writing one directory would race.  ``restore`` places each leaf as its
``shardings`` entry (a ``sharding.NamedSharding``) says, or like its target
leaf when that is a DTensor; each rank keeps its own slice of the array it
read.  A checkpoint holds whole arrays, whatever mesh wrote it.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.ops import is_dtensor

_SEP = "/"


def _flatten(tree: Any, prefix: str = "") -> dict:
    """{path: leaf} in the reference's flatten order."""
    if isinstance(tree, dict):
        items = ((str(key), tree[key]) for key in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), node) for i, node in enumerate(tree))
    else:
        return {prefix or "_root": tree}
    out: dict = {}
    for key, node in items:
        out.update(_flatten(node, f"{prefix}{_SEP}{key}" if prefix else key))
    return out


def _rebuild(tree: Any, values: dict, prefix: str = "") -> Any:
    if isinstance(tree, dict):
        return {key: _rebuild(tree[key], values, f"{prefix}{_SEP}{key}" if prefix else str(key))
                for key in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(node, values, f"{prefix}{_SEP}{i}" if prefix else str(i))
                          for i, node in enumerate(tree))
    return values[prefix or "_root"]


def _to_host(leaf: Any) -> np.ndarray:
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError("Checkpointer: numpy has no bfloat16; save float32 leaves")
        # a copy even on the CPU: the optimizer updates its tensors in place
        # while the background thread writes
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.asarray(leaf)


class Checkpointer:
    def __init__(self, directory: str):
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # -- write ----------------------------------------------------------------
    def save(self, step: int, tree, metadata: dict | None = None, block: bool = False):
        self.wait()
        flat = _flatten(tree)
        sharded = any(is_dtensor(v) for v in flat.values())
        host = {k: _to_host(v) for k, v in flat.items()}
        manifest = {
            "step": int(step),
            "keys": sorted(host.keys()),
            "shapes": {k: list(v.shape) for k, v in host.items()},
            "dtypes": {k: str(v.dtype) for k, v in host.items()},
            "metadata": metadata or {},
        }

        def write():
            tmp = os.path.join(self.dir, f".tmp.{step}")
            final = os.path.join(self.dir, f"ckpt_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)

        if sharded:  # one writer, the others wait for its files
            if dist.get_rank() == 0:
                write()
            dist.barrier()
            return
        self._thread = threading.Thread(target=write, name=f"ckpt-write-{step}", daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    # -- read -----------------------------------------------------------------
    def latest_step(self) -> int | None:
        steps = [int(m.group(1)) for m in (re.fullmatch(r"ckpt_(\d+)", name)
                                           for name in os.listdir(self.dir)) if m]
        return max(steps) if steps else None

    def restore(self, step: int, target_tree, shardings=None):
        """``target_tree``'s structure with the saved values, each on its
        target leaf's device in its dtype → (tree, manifest).

        ``shardings``: a tree of ``target_tree``'s structure (dicts may
        leave keys out) whose ``NamedSharding`` leaves place their arrays
        on that mesh: elastic restore onto another mesh than the one that
        saved.  Without one, a DTensor target leaf gives its placements.
        """
        from ..sharding.specs import NamedSharding, distribute_local, spec_of

        path = os.path.join(self.dir, f"ckpt_{step:08d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        values = {}
        with np.load(os.path.join(path, "arrays.npz")) as data:
            sh = _flatten(shardings) if shardings is not None else {}
            for key, ref in _flatten(target_tree).items():
                arr = data[key]
                if not isinstance(ref, torch.Tensor):
                    values[key] = arr
                    continue
                t = torch.from_numpy(arr).to(device=ref.device, dtype=ref.dtype)
                where = sh.get(key)
                if where is None and is_dtensor(ref):
                    where = NamedSharding(ref.device_mesh,
                                          spec_of(ref.placements, ref.device_mesh, ref.ndim))
                if where is not None and where.mesh.size() > 1:
                    t = distribute_local(t, where.mesh, where.spec)
                values[key] = t
        return _rebuild(target_tree, values), manifest

    def restore_latest(self, target_tree, shardings=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return self.restore(step, target_tree, shardings)
