"""Shape stand-ins and layouts for every dry-run input (the port of
``repro.launch.specs``).

Nothing here allocates device memory: parameters, optimizer state, batches
and KV caches are fake tensors (``torch._subclasses.fake_tensor``) of their
global shapes on the mesh's device type, so a 671B-parameter cell is built
on one host.  Layouts are the port's specs, tuples of mesh-axis names a
dim, in :class:`..sharding.specs.NamedSharding`; the mesh is read for its
axis names and sizes only (a ``DeviceMesh`` or ``launch.mesh.AbstractMesh``).
:func:`materialize` lays a cell's stand-ins out on a ``DeviceMesh`` as
DTensors whose local shards are fake tensors of their own.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..configs.shapes import ShapeSpec
from ..models import ModelConfig, get_api
from ..models.params import map_decls, tree_map, validated_pspec_tree
from ..sharding.specs import (NamedSharding, Spec, act_rules, axis_sizes, cache_kv_spec,
                              cache_latent_spec, from_local, placements, shard_offsets)
from .mesh import axis_size, data_axes


def _dp(mesh) -> tuple:
    """The composite batch-sharding axes, e.g. ("pod", "data") multi-pod."""
    return data_axes(mesh)


def _device(mesh) -> torch.device:
    return torch.device(getattr(mesh, "device_type", "cpu"))


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode()


def input_specs(cfg: ModelConfig, shape: ShapeSpec, device="cpu") -> dict:
    """Stand-ins of the model inputs of this (arch × shape) cell; call under
    a ``FakeTensorMode`` (or get real zeros)."""
    B, S = shape.global_batch, shape.seq_len

    def ids(*dims):
        return torch.zeros(dims, dtype=torch.int32, device=device)

    def acts(*dims):
        return torch.empty(dims, dtype=cfg.adt(), device=device)

    if shape.kind == "decode":
        # one new token; the seq_len lives in the KV cache, for every family
        return {"tokens": ids(B, 1)}
    if cfg.family == "audio":
        specs = {"frames": acts(B, cfg.encdec.num_frames, cfg.d_model), "tokens": ids(B, S)}
        if shape.kind == "train":
            specs["labels"] = ids(B, S)
        return specs
    text = S - cfg.vlm_patches if cfg.vlm_patches else S
    specs = {"tokens": ids(B, text)}
    if shape.kind == "train":
        specs["labels"] = ids(B, text)
    if cfg.vlm_patches:
        specs["image_embeds"] = acts(B, cfg.vlm_patches, cfg.d_model)
    return specs


def _canonical(spec) -> tuple:
    """``spec`` with each one-name tuple as the name, as ``PartitionSpec``
    reads it."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _batch_entry(mesh, dim: int):
    """The data axes when they divide ``dim``, else "data" alone, else None."""
    dp = _dp(mesh)
    if dim % axis_size(mesh, *dp) == 0:
        return dp
    if dim % axis_size(mesh, "data") == 0:
        return "data"
    return None  # e.g. long_500k's global_batch=1


def batch_shardings(cfg: ModelConfig, shape: ShapeSpec, mesh) -> dict:
    with _fake_mode():
        specs = input_specs(cfg, shape)
    return {k: NamedSharding(mesh, _canonical((_batch_entry(mesh, v.shape[0]),)
                                             + (None,) * (v.ndim - 1)))
            for k, v in specs.items()}


def cache_shardings(cfg: ModelConfig, abstract_cache, mesh):
    """KV/state cache layouts by leaf name and divisibility.

    k/v: ``sharding.specs.cache_kv_spec`` (batch → data axes; kv heads →
    model when they divide, else the sequence → model, flash-decode style);
    MLA latents: ``cache_latent_spec`` (the sequence → model); recurrent
    states: their batch → data axes and their width → model when it divides.
    """
    dp = _dp(mesh)
    m = axis_size(mesh, "model")

    def leaf_spec(name, leaf) -> NamedSharding:
        shp = tuple(leaf.shape)
        if name in ("k", "v"):  # (L?, B, S, KVH, hd)
            spec = [None] * (len(shp) - 4) + list(
                cache_kv_spec(shp[-4:], mesh) or (None,) * 4)
        elif name in ("ckv", "krope"):  # (L, B, S, lat)
            spec = [None] * (len(shp) - 3) + list(
                cache_latent_spec(shp[-3:], mesh) or (None,) * 3)
        elif name == "wkv":  # (L, B, H, K, V)
            spec = [None, dp, "model" if shp[-3] % m == 0 else None, None, None]
        elif name in ("tm_shift", "cm_shift"):  # (L, B, D)
            spec = [None, dp, "model" if shp[-1] % m == 0 else None]
        elif name == "lru":  # (..., B, W)
            spec = [None] * (len(shp) - 2) + [dp, "model" if shp[-1] % m == 0 else None]
        elif name == "conv":  # (..., B, K-1, W)
            spec = [None] * (len(shp) - 3) + [dp, None, "model" if shp[-1] % m == 0 else None]
        else:
            spec = [dp] + [None] * (len(shp) - 1)
        # final divisibility guard on the batch axes
        for i, s in enumerate(spec):
            if s == dp:
                spec[i] = _batch_entry(mesh, shp[i])
        return NamedSharding(mesh, _canonical(spec))

    def walk(tree, name=None):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(walk(v, name) for v in tree)
        return leaf_spec(name, tree)

    with act_rules({"batch": dp}):  # the rules cache_kv_spec reads
        return walk(abstract_cache)


@dataclasses.dataclass
class CellSpecs:
    """Everything needed to run one (arch × shape × mesh) cell."""

    params_abs: dict
    params_sh: dict
    batch_abs: dict
    batch_sh: dict
    extra_abs: tuple  # opt state / cache / idx
    extra_sh: tuple


def _fixed(spec: Spec, shape, sizes: dict) -> tuple:
    """``spec`` cut to ``shape``'s rank, entries that no longer divide dropped."""
    fixed = []
    for dim, s in zip(shape, list(spec) + [None] * len(shape)):
        if s is None:
            fixed.append(None)
            continue
        names = s if isinstance(s, tuple) else (s,)
        fixed.append(s if dim % math.prod(sizes.get(n, 1) for n in names) == 0 else None)
    return tuple(fixed)


def opt_sh_tree(opt_abs: dict, z1, mesh) -> dict:
    """Optimizer-state layouts: AdamW's m/v and Adafactor's vr/vc/v take
    the ZeRO-1 spec of their parameter (``z1``), cut to their rank with the
    entries that no longer divide dropped (factored moments); ``step`` is
    replicated."""
    sizes = axis_sizes(mesh)

    def per(leaf, sub):
        if isinstance(sub, tuple):
            return NamedSharding(mesh, _fixed(sub[: leaf.ndim], leaf.shape, sizes))
        return NamedSharding(mesh, ())

    def walk(node, sub):
        if isinstance(node, dict):
            out = {}
            for k, v in node.items():
                if isinstance(sub, dict) and k in sub:
                    out[k] = walk(v, sub[k])
                elif k in ("vr", "vc", "v"):  # a factored moment of the parameter at sub
                    out[k] = walk(v, sub)
                else:
                    out[k] = walk(v, None)
            return out
        if isinstance(node, list):
            return [walk(v, sub[i] if isinstance(sub, list) else None)
                    for i, v in enumerate(node)]
        return per(node, sub)

    return {k: NamedSharding(mesh, ()) if k == "step" else walk(v, z1) for k, v in opt_abs.items()}


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh, optimizer=None,
               param_dtype: torch.dtype = torch.bfloat16, fake_mode=None) -> CellSpecs:
    """The cell's stand-ins (fake tensors of ``fake_mode``, a new one when
    None, on the mesh's device type) and layouts."""
    from ..train.optimizer import zero1_state_specs

    api = get_api(cfg)
    decls = api.decls(cfg)
    dev = _device(mesh)
    fake_mode = fake_mode or _fake_mode()
    # Weight layout by step kind:
    #   train   — FSDP: d_model over data on top of Megatron TP;
    #   prefill/decode — weights resident: attention and router weights
    #             replicate across data, experts stay fully sharded.
    if shape.kind in ("decode", "prefill"):
        rules = {"embed": None, "expert_embed": None, "expert_ff": "data"}
    else:
        rules = {"embed": "data", "expert_embed": "data", "expert_ff": None}
    pspecs = validated_pspec_tree(decls, mesh, rules)
    params_sh = tree_map(lambda _, s: NamedSharding(mesh, s), decls, pspecs)
    batch_sh = batch_shardings(cfg, shape, mesh)
    with fake_mode:
        params_abs = map_decls(lambda d: torch.empty(d.shape, dtype=param_dtype, device=dev),
                               decls)
        batch_abs = input_specs(cfg, shape, dev)
        if shape.kind == "train":
            assert optimizer is not None
            opt_abs = optimizer.init(params_abs)
        elif shape.kind == "decode":
            cache_abs = api.init_cache(cfg, shape.global_batch, shape.seq_len, device=dev)
            idx_abs = torch.zeros((), dtype=torch.int32, device=dev)

    if shape.kind == "train":
        z1 = zero1_state_specs(pspecs, params_abs, mesh, data_axes=_dp(mesh))
        return CellSpecs(params_abs, params_sh, batch_abs, batch_sh, (opt_abs,),
                         (opt_sh_tree(opt_abs, z1, mesh),))
    if shape.kind == "decode":
        return CellSpecs(params_abs, params_sh, batch_abs, batch_sh,
                         (cache_abs, idx_abs),
                         (cache_shardings(cfg, cache_abs, mesh), NamedSharding(mesh, ())))
    return CellSpecs(params_abs, params_sh, batch_abs, batch_sh, (), ())


def materialize(abstract, shardings, mesh):
    """``abstract`` (a tree of fake stand-ins) laid out by ``shardings`` on
    the ``DeviceMesh``: each leaf a DTensor whose local shard is a fake
    tensor of the local shape, with a storage of its own; call under the
    stand-ins' fake mode.  A mesh of one rank keeps the stand-ins, as
    ``models.params.shard_params`` keeps plain tensors there."""
    if mesh.size() == 1:
        return abstract

    def lay(t, sh):
        pl = placements(sh.spec, mesh)
        local, _ = shard_offsets(t.shape, mesh, pl)
        return from_local(torch.empty(local, dtype=t.dtype, device=t.device), mesh, pl, t.shape)

    def walk(node, sh):
        if isinstance(node, dict):
            return {k: walk(v, sh[k]) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, s) for v, s in zip(node, sh))
        return lay(node, sh)

    return walk(abstract, shardings)
