"""Collective-byte accounting from the counting mode's records (the port of
``repro.roofline.hlo_parse``, which scans XLA's partitioned HLO text).

:mod:`.count` records every ``c10d_functional`` collective a rank issues:
its kind (named as HLO names it), the bytes of its result on this rank
and its group's size.  Per record, the result bytes are what one device
puts on the wire, times a ring-algorithm factor:

  all-reduce          2·(n−1)/n ≈ 2     (reduce-scatter + all-gather phases)
  all-gather          (n−1)/n   ≈ 1     (result bytes gathered)
  reduce-scatter      (n−1)/n   ≈ 1     (result bytes of the scatter)
  all-to-all          (n−1)/n   ≈ 1
  collective-permute  1                 (point-to-point)

``wire_bytes`` is therefore *per-chip wire bytes*, matching the roofline
denominator (one chip's link bandwidth).
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

RING_FACTORS = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
    "ragged-all-to-all": 1.0,
}


@dataclasses.dataclass(frozen=True)
class Collective:
    """One collective a rank issued: its kind, its result's bytes on this
    rank, and the number of ranks in its group."""

    kind: str
    result_bytes: int
    group_size: int


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: dict
    wire_bytes: float  # Σ result bytes × ring factor (per chip)
    count_by_kind: dict

    @property
    def total_bytes(self) -> float:
        return float(sum(self.bytes_by_kind.values()))


def collective_stats(records: Iterable[Collective]) -> CollectiveStats:
    bytes_by_kind: dict[str, float] = {}
    count_by_kind: dict[str, int] = {}
    wire = 0.0
    for rec in records:
        if rec.kind not in RING_FACTORS:
            raise ValueError(f"unknown collective kind {rec.kind!r}")
        bytes_by_kind[rec.kind] = bytes_by_kind.get(rec.kind, 0.0) + rec.result_bytes
        count_by_kind[rec.kind] = count_by_kind.get(rec.kind, 0) + 1
        wire += rec.result_bytes * RING_FACTORS[rec.kind]
    return CollectiveStats(bytes_by_kind, wire, count_by_kind)
