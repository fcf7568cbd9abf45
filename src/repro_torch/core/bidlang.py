"""Tree-based bidding language (paper §II; TBBL-inspired, cf. Parkes et al. ICE).

Users express preferences as trees of:

* ``Res(pool, qty)``   — leaf: qty units of one resource pool (neg = offer);
* ``All(children...)`` — conjunction: every child bundle combined (AND);
* ``OneOf(children...)`` — exclusive choice: exactly one child (XOR).

``flatten`` lowers a tree to the dense XOR-of-bundles form consumed by the
clock auction: a list of R-vectors, over which the user is indifferent.  AND
of XORs expands via cartesian product (bounded by ``max_bundles`` to keep the
auction tensors small — the paper's experiments used shallow trees).

Example — "CPU+RAM+disk in cluster1 XOR the same in cluster2"::

    OneOf(All(Res("c1/cpu", 100), Res("c1/ram", 400), Res("c1/disk", 10)),
          All(Res("c2/cpu", 100), Res("c2/ram", 400), Res("c2/disk", 10)))
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Sequence

import numpy as np


class BidNode:
    pass


@dataclasses.dataclass(frozen=True)
class Res(BidNode):
    pool: str
    qty: float


@dataclasses.dataclass(frozen=True)
class All(BidNode):
    children: tuple[BidNode, ...]

    def __init__(self, *children: BidNode):
        object.__setattr__(self, "children", tuple(children))


@dataclasses.dataclass(frozen=True)
class OneOf(BidNode):
    children: tuple[BidNode, ...]

    def __init__(self, *children: BidNode):
        object.__setattr__(self, "children", tuple(children))


class BundleExplosion(ValueError):
    pass


def flatten(
    node: BidNode, pool_index: dict[str, int], max_bundles: int = 64
) -> list[np.ndarray]:
    """Lower a bid tree to its XOR-of-bundles list of dense R-vectors."""
    num_res = len(pool_index)

    def rec(n: BidNode) -> list[np.ndarray]:
        if isinstance(n, Res):
            q = np.zeros((num_res,), dtype=np.float32)
            if n.pool not in pool_index:
                raise KeyError(f"unknown resource pool {n.pool!r}")
            q[pool_index[n.pool]] = n.qty
            return [q]
        if isinstance(n, All):
            alts = [rec(c) for c in n.children]
            count = 1
            for a in alts:
                count *= len(a)
                if count > max_bundles:
                    raise BundleExplosion(
                        f"AND-of-XOR expansion exceeds max_bundles={max_bundles}"
                    )
            return [sum(combo) for combo in itertools.product(*alts)]
        if isinstance(n, OneOf):
            out: list[np.ndarray] = []
            for c in n.children:
                out.extend(rec(c))
                if len(out) > max_bundles:
                    raise BundleExplosion(
                        f"XOR expansion exceeds max_bundles={max_bundles}"
                    )
            return out
        raise TypeError(f"not a BidNode: {n!r}")

    return rec(node)


def flatten_sparse(
    node: BidNode, pool_index: dict[str, int], max_bundles: int = 64
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Lower a bid tree to XOR-of-bundles as sparse ``(idx, val)`` pairs.

    Emits exactly the bundles :func:`flatten` would, but as ascending-index
    ``(int32 idx, float32 val)`` pairs with no dense ``(R,)`` rows — the
    shape a CSR packer consumes directly, so a tree
    touching 3 of 10⁶ pools costs O(3) per bundle instead of O(R).
    Per-pool quantities accumulate in child order with float32 arithmetic
    (the same fold as the dense path's vector sums), and pools whose merged
    quantity is exactly zero are dropped — mirroring the dense path, where
    ``flatnonzero`` skips them at pack time.
    """
    num_res = len(pool_index)

    def rec(n: BidNode) -> list[dict[int, np.float32]]:
        if isinstance(n, Res):
            if n.pool not in pool_index:
                raise KeyError(f"unknown resource pool {n.pool!r}")
            return [{pool_index[n.pool]: np.float32(n.qty)}]
        if isinstance(n, All):
            alts = [rec(c) for c in n.children]
            count = 1
            for a in alts:
                count *= len(a)
                if count > max_bundles:
                    raise BundleExplosion(
                        f"AND-of-XOR expansion exceeds max_bundles={max_bundles}"
                    )
            out: list[dict[int, np.float32]] = []
            for combo in itertools.product(*alts):
                merged: dict[int, np.float32] = {}
                for d in combo:
                    for p, v in d.items():
                        merged[p] = np.float32(merged.get(p, np.float32(0.0)) + v)
                out.append(merged)
            return out
        if isinstance(n, OneOf):
            out = []
            for c in n.children:
                out.extend(rec(c))
                if len(out) > max_bundles:
                    raise BundleExplosion(
                        f"XOR expansion exceeds max_bundles={max_bundles}"
                    )
            return out
        raise TypeError(f"not a BidNode: {n!r}")

    pairs: list[tuple[np.ndarray, np.ndarray]] = []
    for merged in rec(node):
        pools = sorted(p for p, v in merged.items() if v != 0)
        if pools and (pools[0] < 0 or pools[-1] >= num_res):
            raise KeyError(f"pool index out of range [0, {num_res})")
        pairs.append(
            (
                np.asarray(pools, np.int32),
                np.asarray([merged[p] for p in pools], np.float32),
            )
        )
    return pairs


def pool_index(pool_names: Sequence[str]) -> dict[str, int]:
    return {name: i for i, name in enumerate(pool_names)}
