"""Quota → device grants (counterpart of ``repro.core.provisioner``).

Winning auction allocations (chips per cluster) become per-job
:class:`DeviceGrant`\\ s, and a grant's chips factor into a (data, model)
mesh shape.  Building the mesh itself waits for the training slice, where a
``torch.distributed`` process group exists to hold it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

from .types import AuctionResult


@dataclasses.dataclass(frozen=True)
class DeviceGrant:
    """Chips granted to one job in one cluster for one epoch."""

    job: str
    cluster: str
    chips: int
    hbm_gb: float = 0.0
    ici_gbps: float = 0.0
    unit_price: float = 0.0  # settled $/chip, for charge-back accounting


def plan_mesh_shape(chips: int, min_model: int = 1, max_model: int = 256) -> tuple[int, int]:
    """Factor a chip grant into (data, model) mesh axes: the smallest
    power-of-two model axis ≥ ``min_model`` that divides the grant, the rest
    to data; else the largest power of two ≤ chips as the model axis."""
    if chips <= 0:
        raise ValueError("empty grant")
    model = 1 << max(0, math.ceil(math.log2(max(min_model, 1))))
    while model <= min(chips, max_model):
        if chips % model == 0:
            return chips // model, model
        model *= 2
    model = 1 << int(math.log2(chips))
    return chips // model, model


def grants_from_allocation(
    result: AuctionResult,
    job_names: Sequence[str],
    pool_clusters: Sequence[str],
    pool_rtypes: Sequence[str],
    user_jobs: Sequence[int],
) -> list[DeviceGrant]:
    """Convert settled (U, R) allocations into per-job DeviceGrants
    (``user_jobs[u]`` maps auction user u to a job index, −1 = operator)."""
    alloc = result.allocations.cpu().numpy()
    prices = result.prices.cpu().numpy()
    won = result.won.cpu().numpy()
    grants: list[DeviceGrant] = []
    for u in range(alloc.shape[0]):
        j = user_jobs[u]
        if j < 0 or not bool(won[u]):
            continue
        by_cluster: dict[str, dict[str, float]] = {}
        for r in range(alloc.shape[1]):
            q = float(alloc[u, r])
            if q <= 0:
                continue
            d = by_cluster.setdefault(pool_clusters[r], {})
            d[pool_rtypes[r]] = d.get(pool_rtypes[r], 0.0) + q
            d.setdefault("_price_chips", prices[r] if pool_rtypes[r] == "tpu_chips" else 0.0)
        for cluster, d in by_cluster.items():
            chips = int(round(d.get("tpu_chips", 0.0)))
            if chips <= 0:
                continue
            grants.append(
                DeviceGrant(
                    job=job_names[j],
                    cluster=cluster,
                    chips=chips,
                    hbm_gb=d.get("hbm_gb", 0.0),
                    ici_gbps=d.get("ici_gbps", 0.0),
                    unit_price=float(d.get("_price_chips", 0.0)),
                )
            )
    return grants


def grant_to_mesh(grant: DeviceGrant, min_model: int = 1, devices: Sequence | None = None):
    """Build a (data, model) mesh over the granted chips: not ported yet.

    The reference returns a JAX ``Mesh``; the port's twin is a
    ``torch.distributed`` device mesh, which comes with the training slice
    (ROADMAP queue 1, "Model zoo and training").
    """
    raise NotImplementedError(
        "grant_to_mesh waits for the port's training slice (ROADMAP queue 1, "
        "'Model zoo and training'): it needs a torch.distributed process group; "
        f"plan_mesh_shape({grant.chips}) gives the (data, model) shape meanwhile"
    )

