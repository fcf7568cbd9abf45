"""Deterministic, shardable, checkpoint-free-resumable data pipelines (the
port of ``repro.data.pipeline``).

A batch is a pure function of (seed, step, shard): no mutable iterator
state, so resume after a restart is exact by construction (the train loop
continues from the restored step), and any shard can be regenerated on any
host after an elastic re-shard.  Both pipelines draw with numpy's Philox
from the reference's counters, so their batches are the reference's bit
for bit.  They return numpy arrays; the trainer moves them to its device
(``train.train_step.batch_to_device``).  The float draws (audio ``frames``,
vlm ``image_embeds``) stay float32 here: the reference rounds them to
``cfg.adt()`` with ``ml_dtypes``, the trainer on the device, both to
nearest even, so the batch the model sees is the reference's bit for bit.

* SyntheticLM: a Philox counter-based token stream (``counter = step ·
  65536 + shard``; benchmarks, smoke runs, tests; no I/O).
* MemmapLM: fixed-window sampling over a tokenized binary corpus with a
  per-epoch deterministic permutation (file-backed).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..models import ModelConfig


@dataclasses.dataclass(frozen=True)
class SyntheticLM:
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0

    def __call__(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        b = self.batch // num_shards
        rng = np.random.Generator(
            np.random.Philox(key=self.seed, counter=step * 65536 + shard)
        )
        if self.cfg.family == "audio":
            return {
                "frames": rng.standard_normal(
                    (b, self.cfg.encdec.num_frames, self.cfg.d_model), dtype=np.float32),
                "tokens": rng.integers(0, self.cfg.vocab_size, (b, self.seq), dtype=np.int32),
                "labels": rng.integers(0, self.cfg.vocab_size, (b, self.seq), dtype=np.int32),
            }
        toks = rng.integers(0, self.cfg.vocab_size, (b, self._text_len()), dtype=np.int32)
        out = {"tokens": toks, "labels": toks.copy()}
        if self.cfg.vlm_patches:
            out["image_embeds"] = rng.standard_normal(
                (b, self.cfg.vlm_patches, self.cfg.d_model), dtype=np.float32)
        return out

    def _text_len(self) -> int:
        return max(self.seq - self.cfg.vlm_patches, 8) if self.cfg.vlm_patches else self.seq


@dataclasses.dataclass(frozen=True)
class MemmapLM:
    """Windows over a flat int32 token file; deterministic epoch shuffles."""

    path: str
    cfg: ModelConfig
    batch: int
    seq: int
    seed: int = 0

    def __post_init__(self):
        tokens = np.memmap(self.path, dtype=np.int32, mode="r")
        object.__setattr__(self, "_tokens", tokens)
        object.__setattr__(self, "_windows", len(tokens) // (self.seq + 1))
        if self._windows < 1:
            raise ValueError(f"{self.path}: corpus shorter than one window")

    def __call__(self, step: int, shard: int = 0, num_shards: int = 1) -> dict:
        b = self.batch // num_shards
        idx_global = step * self.batch + shard * b
        epoch = idx_global // self._windows
        rng = np.random.Generator(np.random.Philox(key=self.seed, counter=epoch))
        perm = rng.permutation(self._windows)
        rows = []
        for i in range(b):
            w = perm[(idx_global + i) % self._windows]
            start = w * (self.seq + 1)
            rows.append(np.asarray(self._tokens[start : start + self.seq + 1]))
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1].astype(np.int32), "labels": arr[:, 1:].astype(np.int32)}
