"""Float arithmetic of the plain reference, written from the market's stated
numerics and nothing of the program.

The market settles in float32 with every fold in a fixed order, so a
second implementation of the same arithmetic gives the same bits:

* a bundle's cost is ``v0*p0`` followed by one fused multiply-add a
  further term, each correctly rounded once (:func:`fma`);
* a demand column is reduced in windows of 32 values, each window a left
  fold from +0, the window sums reduced the same way, level by level, each
  level's input padded in front by half its shortfall to a whole window
  (:func:`window_fold`);
* the blocks' partial demands are added left to right (:func:`chain_sum`).

``dtype`` is float32 for the reference and bfloat16 for the control, the
nearest precision below the one the deployment states.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools

import numpy as np
import torch

WINDOW = 32


def fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``a*b + c`` rounded once to the operands' float type.

    float32: the product is exact in float64; the float64 sum is rounded to
    odd (TwoSum gives its exact error), and a round-to-odd value with two
    spare bits rounds to float32 correctly.  bfloat16 (the control) rounds
    the float32 fused result once more, as a bfloat16 unit would not; that
    is below the control's own rounding.
    """
    if a.dtype == torch.bfloat16:
        return fma(a.float(), b.float(), c.float()).to(torch.bfloat16)
    a64, b64, c64 = a.double(), b.double(), c.double()
    p = a64 * b64
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, float("inf"), float("-inf")).to(s.dtype)
    s = torch.where(fix, torch.nextafter(s, toward), s)
    return s.to(a.dtype)


def bundle_costs(val: torch.Tensor, gathered: torch.Tensor) -> torch.Tensor:
    """``sum_k val_k * price_k`` over the last axis: the first product, then
    one fused multiply-add a term, in k order."""
    acc = val[..., 0] * gathered[..., 0]
    for k in range(1, val.shape[-1]):
        acc = fma(val[..., k], gathered[..., k], acc)
    return acc


def left_fold(x: torch.Tensor) -> torch.Tensor:
    """``((0 + x0) + x1) + ...`` over the last axis."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def window_levels(n: int) -> list[tuple[int, int]]:
    """``(values in, zeros in front)`` of each windowed level of a reduce of
    ``n`` values; the last level's window sums (at most 32) fold whole."""
    levels = []
    while n > WINDOW:
        nw = -(-n // WINDOW)
        levels.append((n, (nw * WINDOW - n) // 2))
        n = nw
    return levels


def window_fold(x: torch.Tensor) -> torch.Tensor:
    """The windowed reduce of the last axis (see the module docstring)."""
    for n, lo in window_levels(x.shape[-1]):
        nw = -(-n // WINDOW)
        xp = torch.zeros(x.shape[:-1] + (nw * WINDOW,), dtype=x.dtype, device=x.device)
        xp[..., lo:lo + n] = x
        x = left_fold(xp.reshape(x.shape[:-1] + (nw, WINDOW)))
    return left_fold(x)


def chain_sum(partials: torch.Tensor) -> torch.Tensor:
    """``((q0 + q1) + q2) + ...`` over the leading axis."""
    z = partials[0]
    for i in range(1, partials.shape[0]):
        z = z + partials[i]
    return z


@functools.lru_cache(maxsize=1)
def _libm_powf():
    fn = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").powf
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    return fn


def powf(x, y) -> np.ndarray:
    """Elementwise float32 ``x ** y`` by the C library's ``powf``, the
    function the deployment's reserve curve is stated in."""
    x, y = np.broadcast_arrays(np.asarray(x, np.float32), np.asarray(y, np.float32))
    pw = _libm_powf()
    out = [pw(float(a), float(b)) for a, b in zip(x.reshape(-1), y.reshape(-1))]
    return np.asarray(out, np.float32).reshape(x.shape)


def exp_reserve(psi: np.ndarray, base_cost: np.ndarray, k: float, target: float,
                gamma: float) -> np.ndarray:
    """Congestion-weighted reserve (paper eq. 4) with the exponential curve
    ``phi(psi) = k ** (psi**gamma - target**gamma)``, float32:
    ``reserve = phi(psi) * base_cost``."""
    psi = np.clip(np.asarray(psi, np.float32), np.float32(0.0), np.float32(1.0))
    expo = powf(psi, gamma) - np.float32(target ** gamma)
    return np.asarray(powf(np.float32(k), expo), np.float32) * np.asarray(base_cost, np.float32)
