"""Logical activation sharding, rules-driven, over a ``DeviceMesh`` (the port
of ``repro.sharding.specs``).

Model code never names mesh axes.  It annotates activations with *logical*
axes (``shard(x, "batch", "seq", "embed")``) and a rules table maps those to
mesh-axis names:

    default:   batch→data, everything else unsharded (TP flows from weights)
    SP:        seq→model between blocks (sequence parallelism)
    KV-shard:  kv_seq→model for decode (flash-decode style partial softmax)

A spec is a tuple with one entry a tensor dim: a mesh-axis name, a tuple
of names (major to minor) or None, as the reference's ``PartitionSpec``.
:func:`placements` turns it into ``torch.distributed.tensor`` placements,
and ``shard`` is ``DTensor.redistribute`` where the reference constrains
GSPMD.  The spec rules are the reference's: axes whose mesh size does not
divide the dim are dropped, a mesh axis is used once (first dim wins) and
full replication is never forced.

Outside :func:`use_mesh`, or on a tensor that is not a ``DTensor`` (a mesh
of one rank keeps plain tensors), every hint returns its input.  Under
:func:`use_mesh`, plain tensors that meet a ``DTensor`` in an op count as
replicated (``implicit_replication``), as GSPMD treats an unsharded array.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Sequence

from torch.distributed.tensor import DTensor, Partial, Placement, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

Spec = tuple  # one entry a dim: a mesh-axis name, a tuple of names, or None


class _ProcessVar:
    """A process-wide value with ``contextvars.ContextVar``'s ``get`` /
    ``set`` / ``reset``.  Not a context variable: autograd runs a backward
    pass on CUDA tensors on a thread of its own, and the recompute of a
    checkpointed block (``remat``) there must see the layout hints the
    forward pass saw."""

    def __init__(self):
        self._value = None

    def get(self):
        return self._value

    def set(self, value):
        token, self._value = self._value, value
        return token

    def reset(self, token) -> None:
        self._value = token


_MESH = _ProcessVar()  # the mesh under use_mesh, or None
_RULES = _ProcessVar()  # the activation rules under use_mesh / act_rules, or None

# Default mesh axis of each logical activation axis (the reference's table).
ACT_RULES: dict[str, Any] = {
    "batch": "data",
    "seq": None,  # set to "model" for sequence parallelism between blocks
    "act_embed": None,
    "heads": "model",
    "kv_heads": "model",
    "kv_seq": None,  # set to "model" to shard decode KV caches over seq
    "vocab": "model",
    "experts": "model",
    "ff": "model",
    "frames": None,
    "groups": "data",
    "capacity": None,
    "pod": "pod",  # pod-DP: leading batch dim over pods in multi-pod meshes
    "lru": "model",
    "state_k": None,
    "state_v": None,
}


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A layout on a mesh: ``mesh`` (a ``DeviceMesh``) and ``spec``, the
    counterpart of ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: Spec


def axis_sizes(mesh) -> dict[str, int]:
    """{axis name: size} of a ``DeviceMesh``, or of any object with
    ``mesh_dim_names`` and ``shape`` (the rules read nothing else, so a
    production mesh can be reasoned about without its ranks)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _names(entry) -> tuple:
    if entry is None:
        return ()
    return entry if isinstance(entry, tuple) else (entry,)


def placements(spec: Sequence, mesh) -> tuple[Placement, ...]:
    """The DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that dim ``d``'s entry names, ``Replicate()`` on the rest.  A
    tuple of names shards one dim over several mesh dims, major to minor,
    which DTensor lays out in mesh-dim order; names the mesh lacks and mesh
    dims of size 1 stay ``Replicate()``."""
    dims = list(mesh.mesh_dim_names)
    sizes = axis_sizes(mesh)
    out: list[Placement] = [Replicate()] * len(dims)
    for d, entry in enumerate(spec):
        pos = [dims.index(n) for n in _names(entry) if n in dims]
        if pos != sorted(pos):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's order {dims}")
        for p in pos:
            if sizes[dims[p]] > 1:  # a mesh dim of one rank holds everything
                out[p] = Shard(d)
    return tuple(out)


def spec_of(placements_: Sequence[Placement], mesh, ndim: int) -> Spec:
    """The spec of DTensor placements (inverse of :func:`placements`)."""
    entries: list[list[str]] = [[] for _ in range(ndim)]
    for name, p in zip(mesh.mesh_dim_names, placements_):
        if isinstance(p, Shard):
            entries[p.dim].append(name)
    return tuple(None if not e else (e[0] if len(e) == 1 else tuple(e)) for e in entries)


def shard_offsets(shape: Sequence[int], mesh, placements_: Sequence[Placement]
                  ) -> tuple[list[int], list[int]]:
    """This rank's (local shape, global offset) of a tensor of ``shape``
    laid out by ``placements_`` on ``mesh``: each ``Shard(d)`` splits dim
    ``d`` into ``ceil``-sized chunks as ``torch.chunk`` (DTensor's rule; the
    last chunks short or empty where the mesh size does not divide it),
    mesh dims in order (the first the major split)."""
    local, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements_):
        if isinstance(p, Shard):
            size = local[p.dim]
            chunk = -(-size // mesh.size(i))
            start = min(coord[i] * chunk, size)
            local[p.dim] = min(chunk, size - start)
            offset[p.dim] += start
    return local, offset


def distribute_local(t, mesh, spec: Sequence) -> DTensor:
    """``t`` (the same full tensor on every rank) as a DTensor laid out by
    ``spec``: each rank keeps its own slice, without communication."""
    pl = placements(spec, mesh)
    local, offset = shard_offsets(t.shape, mesh, pl)
    part = t
    for d, (n, o) in enumerate(zip(local, offset)):
        if n != t.shape[d]:
            part = part.narrow(d, o, n)
    return from_local(part, mesh, pl, t.shape)


def as_dtensor(x, mesh) -> DTensor:
    """``x`` as a DTensor on ``mesh``: a plain tensor (the same on every
    rank) counts as replicated."""
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def from_local(local, mesh, placements_: Sequence[Placement], shape: Sequence[int]) -> DTensor:
    """The DTensor of global ``shape`` whose local part on this rank is
    ``local``, made contiguous (the global strides are contiguous)."""
    shape = tuple(shape)
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(local.contiguous(), mesh, placements_, run_check=False,
                              shape=shape, stride=tuple(stride))


def local_apply(fn, args: Sequence, arg_dims: Sequence[dict], out_dims: Sequence[dict],
                out_shapes: Sequence[Sequence[int]]):
    """``fn`` on each rank's shards of ``args``, along dims the computation
    keeps apart (a batch, heads), with no gather of those dims.

    ``arg_dims[i]`` names dims of ``args[i]`` (``{0: "batch", 2: "heads"}``).
    A mesh dim that shards ``args[0]`` along a named dim shards every arg
    along its dim of that name; an arg without the name is whole there, and
    its gradient ``Partial`` (a rank met only its part of the other args).
    Every other mesh dim holds every arg whole.  Plain tensors count as
    replicated; None passes through.  ``fn`` gets the local tensors and
    returns one tensor or a tuple, laid out by ``out_dims`` with global
    shapes ``out_shapes``.  Autograd runs through (``to_local`` /
    ``from_local``).  This is how a kernel, or an op DTensor cannot shard
    (an einsum that merges a sharded head dim with the batch), runs on its
    rank's part.
    """
    mesh = args[0].device_mesh
    plan = [arg_dims[0].get(p.dim) if isinstance(p, Shard) else None for p in args[0].placements]

    def layout(dims: dict) -> list:
        named = {name: d for d, name in dims.items()}
        return [Shard(named[name]) if name in named else Replicate() for name in plan]

    local = []
    for a, dims in zip(args, arg_dims):
        if a is None:
            local.append(None)
            continue
        pl = layout(dims)
        grad = [Partial() if name is not None and not isinstance(p, Shard) else p
                for name, p in zip(plan, pl)]
        local.append(as_dtensor(a, mesh).redistribute(mesh, pl).to_local(grad_placements=grad))
    outs = fn(*local)
    single = not isinstance(outs, tuple)
    outs = tuple(from_local(o, mesh, layout(dims), shape)
                 for o, dims, shape in zip((outs,) if single else outs, out_dims, out_shapes))
    return outs[0] if single else outs


def set_mesh(mesh) -> None:
    _MESH.set(mesh)


def get_mesh():
    return _MESH.get()


def set_act_rules(rules: dict[str, Any] | None) -> None:
    _RULES.set(rules)


@contextlib.contextmanager
def act_rules(rules: dict[str, Any] | None = None):
    """The activation rules ``rules`` over :data:`ACT_RULES` while active,
    without a mesh (layout rules read on a mesh's names and sizes alone)."""
    tok = _RULES.set({**ACT_RULES, **(rules or {})})
    try:
        yield
    finally:
        _RULES.reset(tok)


@contextlib.contextmanager
def use_mesh(mesh, rules: dict[str, Any] | None = None):
    tok_m = _MESH.set(mesh)
    tok_r = _RULES.set({**ACT_RULES, **(rules or {})})
    try:
        with implicit_replication():
            yield
    finally:
        _MESH.reset(tok_m)
        _RULES.reset(tok_r)


def logical(*axes: str | None) -> Spec:
    """Logical axis names → a spec of mesh-axis names."""
    rules = _RULES.get() or ACT_RULES
    return tuple(None if a is None else rules.get(a, None) for a in axes)


def _constrain(x, spec: Sequence):
    """``x`` laid out as ``spec`` (a DTensor), or ``x`` when it is not one."""
    if not isinstance(x, DTensor):
        return x
    want = placements(spec, x.device_mesh)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def replicate(x):
    """Force full replication (tiny decode queries whose propagated head
    sharding would otherwise conflict with a sequence-sharded KV cache)."""
    if _MESH.get() is None:
        return x
    return _constrain(x, (None,) * x.ndim)


def _model_axis(mesh) -> tuple[str, int]:
    rules = _RULES.get() or ACT_RULES
    ax = rules.get("heads", "model") or "model"
    if isinstance(ax, tuple):
        ax = ax[0]
    return ax, axis_sizes(mesh).get(ax, 1)


def _batch_axis(mesh, dim: int):
    rules = _RULES.get() or ACT_RULES
    ax = rules.get("batch", "data")
    if ax is None:
        return None
    sizes = axis_sizes(mesh)
    if dim % math.prod(sizes.get(n, 1) for n in _names(ax)) == 0:
        return ax
    if dim % sizes.get("data", 1) == 0:
        return "data"
    return None


def cache_kv_spec(shape: Sequence[int], mesh) -> Spec | None:
    """The decode KV cache's (B, T, KVH, hd) spec: batch→data axes; heads→
    model when they divide, else sequence→model (flash-decode); None when
    nothing is sharded.  The one source that the dry run's cache layouts
    mirror."""
    m_ax, msz = _model_axis(mesh)
    spec = [_batch_axis(mesh, shape[0]), None, None, None]
    if msz > 1 and shape[2] % msz == 0:
        spec[2] = m_ax
    elif msz > 1 and shape[1] % msz == 0:
        spec[1] = m_ax
    return None if all(s is None for s in spec) else tuple(spec)


def cache_latent_spec(shape: Sequence[int], mesh) -> Spec | None:
    """The MLA latent cache's (B, T, C) spec: batch→data; seq→model when it
    divides."""
    m_ax, msz = _model_axis(mesh)
    spec = [_batch_axis(mesh, shape[0]), None, None]
    if msz > 1 and shape[1] % msz == 0:
        spec[1] = m_ax
    return None if all(s is None for s in spec) else tuple(spec)


def decode_logits_spec(shape: Sequence[int], mesh, heads_dim: int, seq_dim: int,
                       prefer_seq: bool = False) -> Spec | None:
    """Decode attention logits: heads over model when they divide, else the
    KV-sequence dim (``prefer_seq`` flips the priority, for MLA)."""
    m_ax, msz = _model_axis(mesh)
    spec: list = [None] * len(shape)
    spec[0] = _batch_axis(mesh, shape[0])
    for d in ([seq_dim, heads_dim] if prefer_seq else [heads_dim, seq_dim]):
        if msz > 1 and shape[d] % msz == 0:
            spec[d] = m_ax
            break
    return None if all(s is None for s in spec) else tuple(spec)


def shard_spec(shape: Sequence[int], axes: Sequence[str | None], mesh) -> Spec | None:
    """The spec :func:`shard` constrains to, or None for a no-op: axes whose
    mesh size does not divide the dim (or is 1) are dropped, a mesh axis is
    used once (first dim wins), and all-None never forces replication."""
    spec = logical(*axes)
    sizes = axis_sizes(mesh)
    fixed = []
    for dim, s in zip(shape, spec + (None,) * (len(shape) - len(spec))):
        if s is None:
            fixed.append(None)
            continue
        total = math.prod(sizes.get(n, 1) for n in _names(s))
        fixed.append(s if dim % total == 0 and total > 1 else None)
    used: set = set()
    for i, f in enumerate(fixed):
        names = _names(f)
        if any(n in used for n in names):
            fixed[i] = None
            continue
        used.update(names)
    return None if all(f is None for f in fixed) else tuple(fixed)


def _hint(x, spec_fn, *args):
    mesh = _MESH.get()
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = spec_fn(tuple(x.shape), mesh, *args)
    return x if spec is None else _constrain(x, spec)


def shard_cache_kv(x):
    return _hint(x, cache_kv_spec)


def shard_cache_latent(x):
    return _hint(x, cache_latent_spec)


def shard_decode_logits(x, heads_dim: int, seq_dim: int, prefer_seq: bool = False):
    return _hint(x, decode_logits_spec, heads_dim, seq_dim, prefer_seq)


def shard(x, *axes: str | None):
    """Constrain ``x``'s layout by logical axes (:func:`shard_spec`);
    ``x`` itself without a mesh or when it is not a DTensor."""
    return _hint(x, lambda shape, mesh: shard_spec(shape, axes, mesh))
