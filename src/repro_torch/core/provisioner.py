"""Quota → device grants → job meshes (counterpart of
``repro.core.provisioner``).

Winning auction allocations (chips per cluster) become per-job
:class:`DeviceGrant`\\ s, and a grant's chips become a (data, model)
``torch.distributed`` device mesh that the training runtime consumes.
"""
from __future__ import annotations

import dataclasses
import math
import os
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .types import AuctionResult, as_device


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


def init_world_from_env(device: str | torch.device = "cuda") -> None:
    """Make the default process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``): NCCL for the card, one device a rank; gloo for the CPU.
    Nothing when the group exists or the environment has no world."""
    if dist.is_initialized() or "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return
    if as_device(device).type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")


def world_size() -> int:
    """Ranks in the default process group; 1 without one."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def lead_rank() -> bool:
    """Whether this process is rank 0 of its world (or has none): the one
    that prints and writes a job's logs."""
    return world_size() == 1 or dist.get_rank() == 0


def mesh_shape(chips: int, available: int, min_model: int = 1) -> tuple[int, int]:
    """The (data, model) shape of a grant of ``chips`` over ``available``
    devices: :func:`plan_mesh_shape`, then the data axis halved until the
    mesh fits, then one model row of every device, as the reference's
    ``grant_to_mesh`` degrades."""
    data, model = plan_mesh_shape(chips, min_model=min_model)
    while data > 1 and data * model > available:
        data //= 2
    if data * model > available:
        data, model = 1, max(1, available)
    return data, model


def grant_to_mesh(grant: DeviceGrant, min_model: int = 1, devices: Sequence[int] | None = None,
                  device: str | torch.device = "cuda") -> DeviceMesh:
    """A (data, model) ``DeviceMesh`` over the granted chips, on ``device``'s
    type (the card unless the caller asks for the CPU).

    ``devices`` are the ranks of the default process group given to the job
    (default: every rank of the group); the mesh shape is :func:`mesh_shape`
    of the grant over them, truncated to the grant.  Without an initialised
    process group the job is this process alone: ``devices`` defaults to
    rank 0 and the mesh is built without process groups, as rank 0 (as
    ``core.auction.users_mesh`` is one rank without a group).
    """
    dev_type = as_device(device).type
    wired = dist.is_available() and dist.is_initialized()
    ranks = list(devices) if devices is not None else list(range(world_size()))
    data, model = mesh_shape(grant.chips, len(ranks), min_model)
    mesh = torch.tensor(ranks[: data * model], dtype=torch.int64).reshape(data, model)
    if wired:
        return DeviceMesh(dev_type, mesh, mesh_dim_names=("data", "model"))
    return DeviceMesh(dev_type, mesh, mesh_dim_names=("data", "model"), _init_backend=False,
                      _rank=0)
