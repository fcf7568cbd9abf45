"""Gradient compression: int8 quantization with error feedback, and a
compressed all-reduce (the port of ``repro.train.grad_compress``).

1. ``apply_error_feedback(grads, ef)``: each gradient leaf is quantized to
   int8 (symmetric, one scale a leaf) after adding the carried residual;
   the new residual is carried forward.
2. ``compressed_psum(x, group)``: an all-reduce with int8 on the wire over
   a ``torch.distributed`` group: a ``MAX`` all-reduce of |x| sets a shared
   scale, the int8 payload is summed as int32, and the sum is rescaled.
   With no process group (or one rank) it is the quantization round trip.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..models.params import tree_map


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-20) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def apply_error_feedback(grads, ef):
    """(compressed grads, new residuals), both float32 trees."""

    def per_leaf(g, e):
        gf = g.float() + e
        q, scale = _quantize(gf)
        dq = q.float() * scale
        return dq, gf - dq

    pairs = tree_map(per_leaf, grads, ef)
    return tree_map(lambda _, pr: pr[0], grads, pairs), tree_map(lambda _, pr: pr[1], grads, pairs)


def compressed_psum(x: torch.Tensor, group=None) -> torch.Tensor:
    """int8-on-the-wire sum of ``x`` over ``group`` (default: the WORLD
    group when ``torch.distributed`` is initialised)."""
    xf = x.float()
    peak = torch.max(torch.abs(xf))
    wired = dist.is_available() and dist.is_initialized()
    if group is not None and not wired:
        raise ValueError("compressed_psum: a group was given, but torch.distributed "
                         "is not initialised")
    if wired:
        dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
    shared_scale = torch.clamp(peak / 127.0, min=1e-20)
    total = torch.clamp(torch.round(xf / shared_scale), -127, 127).to(torch.int8).to(torch.int32)
    if wired:
        dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total.float() * shared_scale
