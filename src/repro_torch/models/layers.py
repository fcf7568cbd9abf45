"""Shared building blocks: matmul with the reference's dtype policy, RMSNorm,
RoPE, GLU MLPs, embeddings, the LM head and the loss (the port of
``repro.models.layers``).

The reference's ``jnp.einsum(x, w, preferred_element_type=float32)`` with a
bfloat16 ``x`` and float32 ``w`` promotes to a float32 product, then casts to
``x.dtype``; :func:`matmul` does the same.  A bfloat16 GEMM would be another
model.  On the card the float32 product must be full float32, not TF32:
PyTorch's default, which ``launch/serve.py``, ``launch/train.py`` and
``chip_smoke.py`` set explicitly (``torch.backends.cuda.matmul.allow_tf32 =
False``) where they build the model.  Norms, RoPE and the softmax run in
float32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import ops
from .params import ParamDecl


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., d) @ w (d, e)`` in float32, cast back to ``x.dtype``."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of shape ``positions.shape + (dim // 2,)``, float32.  The
    inverse frequencies are computed in float32 on ``positions``' device (no
    host copy, so a decode step can be captured in a CUDA graph)."""
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    inv = 1.0 / torch.pow(theta, exps)
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D) rotated by split halves (not interleaved pairs);
    cos/sin: (..., S, D/2), broadcast over heads."""
    xf = x.float()
    x1, x2 = torch.chunk(xf, 2, dim=-1)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# -- GLU MLP -----------------------------------------------------------------


def glu_decls(d_model: int, d_ff: int, act: str = "silu") -> dict:
    d = {
        "wg": ParamDecl((d_model, d_ff), ("embed", "ff")),
        "wd": ParamDecl((d_ff, d_model), ("ff", "embed")),
    }
    if act != "relu2":  # gated variants need the second up-projection
        d["wu"] = ParamDecl((d_model, d_ff), ("embed", "ff"))
    return d


def glu(x: torch.Tensor, p: dict, act: str = "silu") -> torch.Tensor:
    g = matmul(x, p["wg"])
    if act == "relu2":  # nemotron/minitron: squared ReLU, non-gated
        h = torch.square(torch.relu(g.float())).to(x.dtype)
    elif act == "silu":
        h = F.silu(g.float()).to(x.dtype) * matmul(x, p["wu"])
    elif act == "gelu":  # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(g.float(), approximate="tanh").to(x.dtype) * matmul(x, p["wu"])
    else:
        raise ValueError(act)
    return matmul(h, p["wd"])


# -- embeddings / head / loss -------------------------------------------------


def embed_decls(vocab: int, d_model: int) -> ParamDecl:
    return ParamDecl((vocab, d_model), ("vocab", "embed"), init="embed", scale=0.02)


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``, whose gradient adds the rows of repeated tokens in
    operand order (:func:`..kernels.ops.ordered_gather`), as XLA's scatter
    does: the backward of ``table[tokens]`` on CUDA adds with atomics, in an
    order that changes from run to run."""
    return ops.ordered_gather(table, tokens)


def lm_logits(x: torch.Tensor, wout: torch.Tensor) -> torch.Tensor:
    return matmul(x, wout)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss: float = 1e-4) -> torch.Tensor:
    """Mean token cross-entropy (float32) with the z-loss stabiliser
    ``z_loss · lse²``.

    The reference sums ``logits · one_hot(labels)``; this gathers the label's
    logit instead, the same number for finite logits, without the one-hot
    (1.24 GB at qwen3-1.7b's vocabulary of 151,936 and a batch of 4 × 512).
    """
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    true_logit = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    nll = lse - true_logit
    if z_loss:
        nll = nll + z_loss * lse**2
    return torch.mean(nll)
