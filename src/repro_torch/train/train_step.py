"""Train-step factory: loss → grads → optimizer, with microbatch
accumulation (the port of ``repro.train.train_step``).

    step(params, opt_state, batch) -> (params, opt_state, metrics)

* gradients come from ``torch.autograd`` on detached aliases of the
  parameters, so the caller's tensors never carry ``requires_grad``;
* ``grad_accum > 1`` splits the batch into microbatches, in order, folds
  their gradients into float32 accumulators and divides by ``grad_accum``;
  the loss is the mean of the microbatches' losses;
* ``compress``: int8 + error feedback between the gradients and the
  optimizer (``train/grad_compress.py``).

The metrics are the reference's: ``loss``, the loss function's (``xent``,
``moe_aux``; not with ``grad_accum > 1``, as in the reference) and the
optimizer's (``grad_norm``), plain tensors.  The optimizer updates in
place.  On DTensor parameters (under ``sharding.use_mesh``) each gradient
is redistributed to its parameter's placements (a ``Partial`` gradient of
a replicated parameter is all-reduced), and the optimizer's moments hold
those placements too.
"""
from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor

from ..models import ModelConfig, get_api
from ..models.params import tree_leaves, tree_map
from .grad_compress import apply_error_feedback, init_error_feedback


def make_train_step(
    cfg: ModelConfig,
    optimizer,
    grad_accum: int = 1,
    compress: bool = False,
) -> Callable:
    api = get_api(cfg)

    def value_and_grad(params, batch):
        leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
        it = iter(leaves)
        live = tree_map(lambda _: next(it), params)
        loss, metrics = api.loss(live, batch, cfg)
        # on DTensor parameters each gradient takes its parameter's layout
        grads = [g.redistribute(p.device_mesh, p.placements) if isinstance(g, DTensor) else g
                 for g, p in zip(torch.autograd.grad(loss, leaves), leaves)]
        it = iter(grads)
        return _whole(loss.detach()), {k: _whole(v.detach()) for k, v in metrics.items()}, \
            tree_map(lambda _: next(it), params)

    def train_step(params, opt_state, batch):
        if grad_accum == 1:
            loss, metrics, grads = value_and_grad(params, batch)
        else:
            if any(v.shape[0] % grad_accum for v in batch.values()):
                raise ValueError(f"batch does not split into {grad_accum} equal microbatches")
            micro = {k: torch.chunk(v, grad_accum, dim=0) for k, v in batch.items()}
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
            losses = []
            for i in range(grad_accum):
                mb_loss, _, g = value_and_grad(params, {k: parts[i] for k, parts in micro.items()})
                tree_map(lambda a, gi: a.add_(gi.float()), grads, g)
                losses.append(mb_loss)
            grads = tree_map(lambda g: g / grad_accum, grads)
            loss = torch.mean(torch.stack(losses))
            metrics = {}

        if compress:
            grads, ef = apply_error_feedback(grads, opt_state["ef"])
        new_params, new_opt, om = optimizer.update(grads, opt_state["opt"], params)
        om = {k: _whole(v) for k, v in om.items()}
        new_state = {"opt": new_opt}
        if compress:
            new_state["ef"] = ef
        return new_params, new_state, {"loss": loss, **metrics, **om}

    return train_step


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A metric as a plain tensor (a DTensor's full value)."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def batch_to_device(batch: dict, cfg: ModelConfig, device) -> dict:
    """A pipeline's numpy batch as tensors on ``device``: float arrays
    (audio ``frames``, vlm ``image_embeds``) cast to ``cfg.adt()``, integer
    arrays (tokens, labels) as they are."""
    return {k: (t.to(device=device, dtype=cfg.adt()) if t.is_floating_point() else t.to(device))
            for k, t in ((k, torch.from_numpy(v)) for k, v in batch.items())}


def init_train_state(cfg: ModelConfig, optimizer, params, compress: bool = False):
    state: dict[str, Any] = {"opt": optimizer.init(params)}
    if compress:
        state["ef"] = init_error_feedback(params)
    return state
