"""Production meshes (the port of ``repro.launch.mesh``).

Single pod: (data=16, model=16), 256 chips.
Multi-pod:  (pod=2, data=16, model=16), 512 chips; the ``pod`` axis crosses
the slower inter-pod fabric and defaults to pure data parallelism (one
gradient all-reduce a step crosses it), switchable to pipeline stages.

:func:`make_production_mesh` builds the ``DeviceMesh`` over an initialised
``torch.distributed`` world of exactly that size (torchrun's, one rank a
card); :func:`abstract_mesh` is its shape alone, for reasoning about the
layout (``models.params.validated_pspec_tree``,
``train.optimizer.zero1_state_specs``) on one machine.  The other helpers
take either.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


class AbstractMesh(NamedTuple):
    """A mesh's axis names and sizes, without ranks."""

    mesh_dim_names: tuple[str, ...]
    shape: tuple[int, ...]


def abstract_mesh(multi_pod: bool = False) -> AbstractMesh:
    """The production mesh's axis names and sizes."""
    if multi_pod:
        return AbstractMesh(("pod", "data", "model"), (2, 16, 16))
    return AbstractMesh(("data", "model"), (16, 16))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    want = abstract_mesh(multi_pod)
    size = math.prod(want.shape)
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0
    if world != size:
        raise RuntimeError(f"the production mesh {want.shape} needs an initialised "
                           f"torch.distributed world of {size} ranks, found {world or 'none'}")
    ranks = torch.arange(size, dtype=torch.int64).reshape(want.shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=want.mesh_dim_names)


def data_axes(mesh) -> tuple[str, ...]:
    """Axes that carry pure data parallelism (``pod`` too when present)."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def axis_size(mesh, *names: str) -> int:
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    return math.prod(sizes.get(n, 1) for n in names)
