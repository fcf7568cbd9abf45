"""Parameter declarations and their initialisation (the port of
``repro.models.params``).

Models declare parameters as trees (nested dicts and lists) of
:class:`ParamDecl`: a shape, a logical axis name per dimension and an
initialiser.  :func:`init_params` materialises a tree of the same structure
holding tensors, with the reference's init kinds and fan-in scales, drawn
from a ``torch.Generator`` on the target device (its numbers differ from
``jax.random``'s; :func:`.convert.params_from_reference` gives the port the
reference's own weights).  :func:`tree_map` and :func:`tree_leaves` walk
such trees in ``jax.tree_util``'s order.

The same declarations give the layout: :func:`pspec_tree` maps each leaf's
logical axes through a rules table (:data:`DEFAULT_RULES`, Megatron-style)
to a spec, a tuple of mesh-axis names (``repro_torch.sharding``);
:func:`validated_pspec_tree` drops the axes whose size on a mesh does not
divide the dim, reading only the mesh's axis names and sizes; and
:func:`shard_params` places a tree of full tensors on a ``DeviceMesh`` as
DTensors by those specs, each rank keeping its own slice (no
communication: every rank drew the same full tensor).  A mesh of one rank
keeps plain tensors.  :func:`abstract_params` stands in for the weights on
the ``meta`` device, so a 1T-parameter tree allocates nothing.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from ..core.types import as_device
from ..sharding.specs import Spec, axis_sizes, distribute_local


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]  # logical axis name per dim (None = never shard)
    init: str = "normal"  # "normal" | "zeros" | "ones" | "embed" | "uniform_pm"
    scale: float | None = None  # stddev override; default fan-in

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def map_decls(fn: Callable[[ParamDecl], Any], decls: Any) -> Any:
    """``decls`` with every :class:`ParamDecl` replaced by ``fn(decl)``; dict
    keys are visited in sorted order, as ``jax.tree_util`` flattens them."""
    if isinstance(decls, ParamDecl):
        return fn(decls)
    if isinstance(decls, dict):
        return {key: map_decls(fn, decls[key]) for key in sorted(decls)}
    if isinstance(decls, (list, tuple)):
        return type(decls)(map_decls(fn, d) for d in decls)
    raise TypeError(f"not a declaration tree: {type(decls)}")


def _init_leaf(gen: torch.Generator, d: ParamDecl, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    if d.init == "uniform_pm":  # uniform in [-scale, scale]
        s = d.scale if d.scale is not None else 1.0
        u = torch.rand(d.shape, generator=gen, device=device)
        return u.mul_(2 * s).sub_(s).to(dtype)
    if d.init == "embed":
        s = d.scale if d.scale is not None else 1.0
    else:  # fan-in scaled normal
        fan_in = d.shape[0] if len(d.shape) == 1 else math.prod(d.shape[:-1])
        s = d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    return torch.randn(d.shape, generator=gen, device=device).mul_(s).to(dtype)


def init_params(generator: torch.Generator, decls: Any, dtype: torch.dtype = torch.float32,
                device: str | torch.device = "cuda") -> Any:
    """Materialise ``decls`` on ``device`` (the card unless the caller asks
    for the CPU); ``generator`` lives on the same device."""
    dev = as_device(device)
    return map_decls(lambda d: _init_leaf(generator, d, dtype, dev), decls)


def abstract_params(decls: Any, dtype: torch.dtype = torch.bfloat16) -> Any:
    """Shape-and-dtype stand-ins of ``decls`` on the ``meta`` device."""
    return map_decls(lambda d: torch.empty(d.shape, dtype=dtype, device="meta"), decls)


# Megatron-style default layout: shard the contracting-free "wide" axes over
# the model axis; replicate d_model; layers are stacked, never sharded.
DEFAULT_RULES: dict[str | None, Any] = {
    None: None,
    "layers": None,
    "embed": None,
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "qk_head_dim": None,
    "v_head_dim": None,
    "ff": "model",
    "experts": "model",
    "expert_ff": None,
    "expert_embed": None,
    "lora": None,
    "lru": "model",
    "conv": None,
    "frames": None,
}


def pspec_tree(decls: Any, rules: dict | None = None) -> Any:
    """A spec a leaf: each logical axis through ``rules`` over
    :data:`DEFAULT_RULES`."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    return map_decls(lambda d: tuple(rules.get(a, None) for a in d.axes), decls)


def validated_pspec_tree(decls: Any, mesh, rules: dict | None = None) -> Any:
    """:func:`pspec_tree`, with the entries whose mesh size does not divide
    the dim dropped; ``mesh`` is read for its axis names and sizes only."""
    rules = {**DEFAULT_RULES, **(rules or {})}
    sizes = axis_sizes(mesh)

    def to_spec(d: ParamDecl) -> Spec:
        spec = []
        for dim, a in zip(d.shape, d.axes):
            m = rules.get(a, None)
            if m is None:
                spec.append(None)
                continue
            total = math.prod(sizes[n] for n in (m if isinstance(m, tuple) else (m,)))
            spec.append(m if dim % total == 0 else None)
        return tuple(spec)

    return map_decls(to_spec, decls)


def shard_params(params: Any, mesh, specs: Any) -> Any:
    """``params`` (full tensors, the same on every rank) as DTensors on
    ``mesh`` laid out by ``specs``; unchanged on a mesh of one rank."""
    if mesh is None or mesh.size() == 1:
        return params
    return tree_map(lambda t, spec: distribute_local(t, mesh, spec), params, specs)


def count_params(decls: Any) -> int:
    sizes: list[int] = []
    map_decls(lambda d: sizes.append(math.prod(d.shape)), decls)
    return sum(sizes)


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of dicts, lists and tuples, dict keys in sorted
    order, as ``jax.tree_util.tree_leaves`` lists them."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in tree_leaves(tree[key])]
    if isinstance(tree, (list, tuple)):
        return [leaf for node in tree for leaf in tree_leaves(node)]
    return [tree]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` applied leaf by leaf to ``tree`` and the trees of the same
    structure in ``rest``."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest)) for key in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *nodes) for nodes in zip(tree, *rest))
    return fn(tree, *rest)


def tree_bytes(tree: Any) -> int:
    return sum(leaf.numel() * leaf.element_size() for leaf in tree_leaves(tree)
               if isinstance(leaf, torch.Tensor))
