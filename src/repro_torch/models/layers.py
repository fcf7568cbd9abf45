"""Shared building blocks: matmul with the reference's dtype policy, RMSNorm,
embedding lookup and the LM head (the port of ``repro.models.layers``; the
GLU, RoPE and loss wait for the families and the training that use them).

The reference's ``jnp.einsum(x, w, preferred_element_type=float32)`` with a
bfloat16 ``x`` and float32 ``w`` promotes to a float32 product, then casts to
``x.dtype``; :func:`matmul` does the same.  A bfloat16 GEMM would be another
model.  On the card the float32 product must be full float32, not TF32:
PyTorch's default, which ``launch/serve.py`` and ``chip_smoke.py`` set
explicitly (``torch.backends.cuda.matmul.allow_tf32 = False``) where they
build the model.
"""
from __future__ import annotations

import torch


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., d) @ w (d, e)`` in float32, cast back to ``x.dtype``."""
    return torch.matmul(x.float(), w.float()).to(x.dtype)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def lm_logits(x: torch.Tensor, wout: torch.Tensor) -> torch.Tensor:
    return matmul(x, wout)
