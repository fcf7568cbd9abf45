"""Per-device counts of one step, from the ops a rank runs (the port's
counterpart of XLA's ``compiled.cost_analysis()`` and
``compiled.memory_analysis()``, which the reference's dry run reads).

:func:`count_step` runs a step function under :class:`CountMode`, a
``TorchDispatchMode`` that sees every ATen op this rank runs on its own
tensors, on the local shards under DTensor, and counts:

* flops, by ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention; elementwise ops count none, as there);
* bytes: every op that touches storage reads each tensor argument once and
  writes each output once; view and metadata ops move none.  The kernel
  custom ops are charged what ``chip_smoke.py``'s bounds charge them, from
  the shapes alone: ``ordered_rows_add`` reads the index, every source row
  (all kept) and reads and writes ``min(n, E)`` target rows (every row its
  own target, as far as there are targets); ``wkv6`` reads r, k, v, w, u
  and the state and writes o and the final state, with two flops an FMA
  of the chunked algebra;
* collectives: every ``c10d_functional`` op, as a
  :class:`.collectives.Collective` (kind, result bytes, group size);
* the peak of live local storage: the arguments' storages from the start,
  then every storage an op allocates, until it dies.

A DTensor op is left to DTensor (the mode returns ``NotImplemented``), which
runs the local op, and any redistribution, on plain tensors the mode then
counts.  DTensor's sharding propagation also runs the op on fake tensors of
the *global* shapes, to infer the output's; those ops are not the rank's
work and are not counted.  Counts read shapes only, so a step on fake
tensors (``FakeTensorMode``) counts what the same step on real tensors
does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import weakref
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from .collectives import Collective, CollectiveStats, collective_stats

_aten = torch.ops.aten

# ops that read metadata only
_METADATA = {
    _aten.is_contiguous.default, _aten.is_contiguous.memory_format,
    _aten.is_strides_like_format.default, _aten.is_non_overlapping_and_dense.default,
    _aten.size.default, _aten.sym_size.default, _aten.sym_size.int, _aten.stride.default,
    _aten.sym_stride.default, _aten.sym_stride.int, _aten.storage_offset.default,
    _aten.sym_storage_offset.default, _aten.numel.default, _aten.sym_numel.default,
    _aten.dim.default, torch.ops.prim.layout.default, torch.ops.prim.device.default,
}
# ops that allocate without touching the memory
_ALLOCATE = {_aten.empty.memory_format, _aten.empty_strided.default, _aten.new_empty.default,
             _aten.new_empty_strided.default, _aten.empty_like.default}
# views whose schemas do not say so
_VIEWS = {_aten._unsafe_view.default, _aten.lift_fresh.default,
          torch.ops._c10d_functional.wait_tensor.default}
_COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce", "all_reduce_coalesced_": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_out": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional")


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_view(func) -> bool:
    if func in _VIEWS:
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None and not r.alias_info.is_write
                              for r in rets)


def rows_add_cost(out: torch.Tensor, index: torch.Tensor) -> tuple[int, int]:
    """(bytes, flops) charged to one ``ordered_rows_add``: the index read,
    the E source rows read, ``min(n, E)`` target rows read and written; an
    add a source element."""
    n, e = out.shape[0], index.shape[0]
    row = math.prod(out.shape[1:]) * out.element_size()
    return _nbytes(index) + (e + 2 * min(n, e)) * row, e * math.prod(out.shape[1:])


def wkv6_cost(r, k, v, w, u, state, chunk: int) -> tuple[int, int]:
    """(bytes, flops) charged to one ``wkv6``: r, k, v, w, u and the state
    read, o and the final state written in float32; two flops an FMA of the
    chunked algebra (``chip_smoke.wkv6_bound``'s count)."""
    *lead, t, h, kd = r.shape
    b = math.prod(lead)
    vd = v.shape[-1]
    L = min(chunk, t)
    n_chunks = -(-t // L)
    read = sum(_nbytes(x) for x in (r, k, v, w, u)) + (0 if state is None else _nbytes(state))
    write = 4 * b * t * h * vd + 4 * b * h * kd * vd
    fmas = b * h * n_chunks * (2 * L * kd * vd + L * (L - 1) // 2 * (kd + vd) + L * vd)
    return read + write, 2 * fmas


_CUSTOM_COSTS = {
    "repro_torch::ordered_rows_add": lambda out, index, source, plain: rows_add_cost(out, index),
    "repro_torch::wkv6": lambda r, k, v, w, u, state, chunk, plain: wkv6_cost(
        r, k, v, w, u, state, chunk),
}


@dataclasses.dataclass
class StepCount:
    """A rank's counts of one step (see the module docstring)."""

    flops: float = 0.0
    bytes: float = 0.0
    collectives: list = dataclasses.field(default_factory=list)
    ops: int = 0
    argument_bytes: dict = dataclasses.field(default_factory=dict)  # by top-level argument
    output_bytes: int = 0  # outputs' storages that are not arguments'
    peak_bytes: int = 0  # live local storage, arguments included
    flops_by_op: dict = dataclasses.field(default_factory=dict)

    @property
    def stats(self) -> CollectiveStats:
        return collective_stats(self.collectives)

    @property
    def temp_bytes(self) -> int:
        return self.peak_bytes - sum(self.argument_bytes.values())

    def totals(self) -> dict:
        """What two counts of the same step must agree on."""
        st = self.stats
        return {"flops": self.flops, "bytes": self.bytes, "ops": self.ops,
                "collectives": dict(sorted(st.count_by_kind.items())),
                "collective_bytes": dict(sorted(st.bytes_by_kind.items())),
                "wire_bytes": st.wire_bytes}


class _Propagation(threading.local):
    depth = 0


_PROPAGATION = _Propagation()


@contextlib.contextmanager
def _propagation_uncounted():
    """While active, DTensor's sharding propagation marks the ops it runs
    to infer global output shapes, so :class:`CountMode` leaves them out."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator

    names = [n for n in ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")
             if n in vars(ShardingPropagator)]
    if not names:
        raise RuntimeError("this torch's ShardingPropagator has no tensor-meta propagation "
                           "to leave out of the count")
    name = names[0]
    inner = vars(ShardingPropagator)[name]

    def marked(self, *args, **kwargs):
        _PROPAGATION.depth += 1
        try:
            return inner(self, *args, **kwargs)
        finally:
            _PROPAGATION.depth -= 1

    setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, inner)


class CountMode(TorchDispatchMode):
    """Counts the ops this rank runs into ``self.count`` (a
    :class:`StepCount`); ``group_sizes`` maps a process group's name to its
    size, for collectives whose arguments do not say it.  ``trace``, a
    list, gets a line an op counted: its name, flops and bytes."""

    def __init__(self, group_sizes: dict[str, int] | None = None, trace: list | None = None):
        super().__init__()
        self.count = StepCount()
        self.trace = trace
        self.group_sizes = dict(group_sizes or {})
        self._live: dict[int, int] = {}  # id(storage) → bytes
        self._live_bytes = 0
        self._open = True

    # -- live storage ------------------------------------------------------
    def track(self, t: torch.Tensor) -> bool:
        """Count ``t``'s storage as live until it dies; False if it already is."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._live:
            return False
        size = st.nbytes()
        self._live[key] = size
        self._live_bytes += size
        self.count.peak_bytes = max(self.count.peak_bytes, self._live_bytes)
        weakref.finalize(st, self._free, key)
        return True

    def _free(self, key: int) -> None:
        if self._open and key in self._live:
            self._live_bytes -= self._live.pop(key)

    def close(self) -> None:
        self._open = False

    # -- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _PROPAGATION.depth:  # global shape inference: not this rank's work
            return func(*args, **kwargs)
        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if func in _METADATA:
            return out
        self.count.ops += 1
        outs = _tensors(out)
        for t in outs:
            self.track(t)
        name = func._schema.name
        if name in _CUSTOM_COSTS:
            nbytes, flops = _CUSTOM_COSTS[name](*args, **kwargs)
        elif func in _ALLOCATE or _is_view(func):
            nbytes, flops = 0, 0
        else:
            packet = func._overloadpacket
            flops = (flop_registry[packet](*args, **kwargs, out_val=out)
                     if packet in flop_registry else 0)
            nbytes = sum(_nbytes(t) for t in _tensors((args, kwargs))) + \
                sum(_nbytes(t) for t in outs)
            if func.namespace in _COLLECTIVE_NAMESPACES:
                self._collective(func, args, outs)
        self.count.bytes += nbytes
        if flops:
            self.count.flops += flops
            label = str(func._overloadpacket)
            self.count.flops_by_op[label] = self.count.flops_by_op.get(label, 0) + flops
        if self.trace is not None:
            shapes = " ".join("x".join(map(str, t.shape)) or "()"
                              for t in _tensors((args, kwargs)))
            self.trace.append(f"{func} flops={flops} bytes={nbytes} in={shapes}")
        return out

    def _collective(self, func, args, outs) -> None:
        op = func._schema.name.split("::")[-1]
        kind = _COLLECTIVE_KINDS.get(op)
        if kind is None:
            raise NotImplementedError(f"the count has no kind for collective {func}")
        group = next((a for a in reversed(args) if isinstance(a, str)), None)
        size = next((a for a in args if isinstance(a, int) and not isinstance(a, bool)), None)
        if size is None:
            size = self.group_sizes.get(group) or _group_size(group)
        for t in outs:
            self.count.collectives.append(Collective(kind, _nbytes(t), int(size)))


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor

    return issubclass(t, DTensor)


def _group_size(name: str | None) -> int:
    import torch.distributed.distributed_c10d as c10d

    return c10d._resolve_process_group(name).size()


def mesh_group_sizes(mesh) -> dict[str, int]:
    """{process group name: size} of each dim of a ``DeviceMesh``."""
    if mesh is None or not hasattr(mesh, "get_group"):
        return {}
    out = {}
    for i in range(mesh.ndim):
        try:
            out[mesh.get_group(i).group_name] = mesh.size(i)
        except RuntimeError:  # a mesh without process groups
            pass
    return out


def _local(t):
    from torch.distributed.tensor import DTensor

    return t.to_local() if isinstance(t, DTensor) else t


def count_step(fn: Callable[..., Any], named_args: dict[str, Any], mesh=None,
               trace: list | None = None) -> tuple[Any, StepCount]:
    """``fn(**named_args)`` run once under :class:`CountMode`: its result and
    this rank's counts.  ``named_args`` are trees of tensors (DTensors count
    by their local shards); ``argument_bytes`` holds each one's bytes."""
    mode = CountMode(mesh_group_sizes(mesh), trace)
    seen: set[int] = set()
    for key, tree in named_args.items():
        total = 0
        for t in _tensors(tree):
            t = _local(t)
            if mode.track(t):
                total += t.untyped_storage().nbytes()
            seen.add(id(t.untyped_storage()))
        mode.count.argument_bytes[key] = total
    with _propagation_uncounted(), mode:
        out = fn(**named_args)
    mode.close()
    done: set[int] = set()
    for t in _tensors(out):
        st = _local(t).untyped_storage()
        if id(st) not in seen and id(st) not in done:
            done.add(id(st))
            mode.count.output_bytes += st.nbytes()
    return out, mode.count
