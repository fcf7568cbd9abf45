"""The reference's weights in the port's layout.

``repro.models`` keeps its parameters as a pytree of arrays, per-layer leaves
stacked on a leading layer axis; the port keeps the same tree as nested
dicts of tensors.  :func:`params_from_reference` takes the reference's tree
as numpy arrays (``jax.tree_util.tree_map(np.asarray, params)``) and returns
the port's parameters with identical values, so both packages can run the
same model.  It is how the tests hand both the same weights.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.types import as_device


def params_from_reference(tree: Any, device: str | torch.device = "cuda") -> Any:
    """``tree`` (nested dicts and lists of numpy arrays) as tensors on
    ``device``, leaf for leaf, values and dtypes unchanged."""
    dev = as_device(device)

    def convert(node: Any) -> Any:
        if isinstance(node, dict):
            return {key: convert(val) for key, val in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(convert(val) for val in node)
        a = np.array(node, copy=True)
        if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: widening is exact
            return torch.from_numpy(a.astype(np.float32)).to(dev, torch.bfloat16)
        return torch.from_numpy(a).to(dev)

    return convert(tree)
