"""Optimizers from scratch: AdamW, Adafactor (the port of
``repro.train.optimizer``).

Functional, over the reference's trees: ``init(params) -> state`` and
``update(grads, state, params) -> (params, state, metrics)``, with the
reference's state layout (AdamW: ``{"m", "v", "step"}``; Adafactor:
``{"v", "step"}``, each ``v`` leaf ``{"vr", "vc"}`` or ``{"v"}``), so an
optimizer state checkpointed by either package restores in the other.
Moments are float32 whatever the parameters' dtype.  ``update`` writes the
parameters and the state in place, under ``torch.no_grad()``, and returns
them: the reference's jitted step donates these buffers, so no caller
reads the old values.  On DTensor parameters the moments take the
parameters' placements, as the reference's jitted step lays them out.

ZeRO-1: :func:`zero1_spec` extends a parameter's spec by sharding its
largest still-unsharded dim over the data axes, for optimizer moments;
:func:`zero1_state_specs` applies it to a tree.  They are layout rules for
the dry run; the trainer does not use them, as the reference's does not.
"""
from __future__ import annotations

import dataclasses
import math

import torch
from torch.distributed.tensor import DTensor

from ..models.params import tree_leaves, tree_map
from ..sharding.specs import Spec, axis_sizes


def _zeros_like(p: torch.Tensor, shape=None) -> torch.Tensor:
    if isinstance(p, DTensor) and shape is None:  # the parameter's placements
        return torch.zeros_like(p, dtype=torch.float32)
    return torch.zeros(p.shape if shape is None else shape, dtype=torch.float32,
                       device=p.device)


def _step0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    max_grad_norm: float | None = 1.0

    def init(self, params):
        return {
            "m": tree_map(_zeros_like, params),
            "v": tree_map(_zeros_like, params),
            "step": _step0(params),
        }

    @torch.no_grad()
    def update(self, grads, state, params):
        step = state["step"] + 1
        gf = [g.float() for g in tree_leaves(grads)]
        gnorm = global_norm(gf)
        if self.max_grad_norm is not None:  # clip by the global norm
            scale = torch.clamp(self.max_grad_norm / (gnorm + 1e-9), max=1.0)
            gf = [g * scale for g in gf]
        b1t = 1.0 - self.b1 ** step.float()
        b2t = 1.0 - self.b2 ** step.float()
        for p, g, m, v in zip(tree_leaves(params), gf, tree_leaves(state["m"]),
                              tree_leaves(state["v"])):
            m.mul_(self.b1).add_((1 - self.b1) * g)
            v.mul_(self.b2).add_((1 - self.b2) * g * g)
            delta = (m / b1t) / (torch.sqrt(v / b2t) + self.eps) + self.weight_decay * p.float()
            p.copy_((p.float() - self.lr * delta).to(p.dtype))
        state["step"] = step
        return params, state, {"grad_norm": gnorm}


@dataclasses.dataclass(frozen=True)
class Adafactor:
    """Factored second moments: O(n + m) state for an (n, m) matrix."""

    lr: float = 1e-3
    decay: float = 0.8
    eps: float = 1e-30
    clip_threshold: float = 1.0
    weight_decay: float = 0.0

    def init(self, params):
        def z(p):
            if p.ndim >= 2:
                return {"vr": _zeros_like(p, p.shape[:-1]),
                        "vc": _zeros_like(p, p.shape[:-2] + p.shape[-1:])}
            return {"v": _zeros_like(p)}

        return {"v": tree_map(z, params), "step": _step0(params)}

    @torch.no_grad()
    def update(self, grads, state, params):
        step = state["step"] + 1
        beta = 1.0 - step.float() ** (-self.decay)

        def upd(p, g, s):
            g = g.float()
            g2 = g * g + self.eps
            if p.ndim >= 2:
                s["vr"].mul_(beta).add_((1 - beta) * g2.mean(dim=-1))
                s["vc"].mul_(beta).add_((1 - beta) * g2.mean(dim=-2))
                vr, vc = s["vr"], s["vc"]
                row = torch.clamp(vr.mean(dim=-1, keepdim=True), min=self.eps)
                denom = (vr[..., None] / row[..., None]) * vc[..., None, :]
                u = g * torch.rsqrt(torch.clamp(denom, min=self.eps))
            else:
                s["v"].mul_(beta).add_((1 - beta) * g2)
                u = g * torch.rsqrt(torch.clamp(s["v"], min=self.eps))
            rms = torch.sqrt(torch.mean(u * u))
            u = u / torch.clamp(rms / self.clip_threshold, min=1.0)
            pf = p.float()
            p.copy_((pf - self.lr * (u + self.weight_decay * pf)).to(p.dtype))

        tree_map(upd, params, grads, state["v"])
        state["step"] = step
        return params, state, {"grad_norm": global_norm(grads)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float())) for leaf in tree_leaves(tree)))


def zero1_spec(spec: Spec, shape: tuple[int, ...], data_axes, sizes: dict) -> Spec:
    """``spec`` with the largest unsharded dim that the data axes divide
    sharded over them (ZeRO-1 for optimizer moments); unchanged when a data
    axis already shards it."""
    names = data_axes if isinstance(data_axes, tuple) else (data_axes,)
    total = math.prod(sizes[n] for n in names)
    entries = list(spec) + [None] * (len(shape) - len(spec))
    used = {n for e in entries for n in (e if isinstance(e, tuple) else (e,))}
    if used & set(names):
        return tuple(entries)
    best, best_dim = -1, -1
    for i, (dim, s) in enumerate(zip(shape, entries)):
        if s is None and dim % total == 0 and dim > best:
            best, best_dim = dim, i
    if best_dim >= 0:
        entries[best_dim] = names if len(names) > 1 else names[0]
    return tuple(entries)


def zero1_state_specs(param_specs, params_shapes, mesh, data_axes=("data",)):
    """:func:`zero1_spec` of every leaf; ``params_shapes`` a tree of tensors
    (``models.params.abstract_params``), ``mesh`` read for its axis sizes."""
    sizes = axis_sizes(mesh)
    return tree_map(lambda p, spec: zero1_spec(spec, tuple(p.shape), data_axes, sizes),
                    params_shapes, param_specs)
