"""Congestion-weighted reserve pricing (paper §IV), on the host.

Reserve price for one unit of pool r:  ``p̃_r = φ_r(ψ(r)) · c(r)``  (eq. 4),
with ψ(r) the pre-auction utilization and c(r) the base cost.  Every curve
satisfies the paper's five §IV.A properties: φ rises with ψ, φ > 1 above the
target utilization and ≤ 1 below it, congested levels are spread far wider
than idle ones, and φ(1) = k·φ(0).

The curve is evaluated in float32 on the host for a few dozen pools per
epoch, as the reference does.  The reference evaluates it eagerly through
XLA's CPU backend, whose float32 ``pow`` is the C library's ``powf`` and
whose float32 ``exp`` is its own Cephes polynomial (:func:`_expf`), so the
reserve curve comes out bit for bit.  (``numpy`` and ``torch`` round both
differently in the last place.)
"""
from __future__ import annotations

import ctypes
import ctypes.util
import dataclasses
import functools
from typing import Callable, Sequence

import numpy as np

from .types import ResourcePool

WeightingFn = Callable[[np.ndarray], np.ndarray]


@functools.lru_cache(maxsize=1)
def _libm_powf():
    fn = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6").powf
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_float, ctypes.c_float]
    return fn


def _powf(x, y) -> np.ndarray:
    """Elementwise float32 ``x ** y`` through the C library's ``powf``."""
    x, y = np.broadcast_arrays(np.asarray(x, np.float32), np.asarray(y, np.float32))
    pw = _libm_powf()
    out = [pw(float(a), float(b)) for a, b in zip(x.reshape(-1), y.reshape(-1))]
    return np.asarray(out, np.float32).reshape(x.shape)


def _fmaf(a, b, c) -> np.ndarray:
    """Correctly rounded float32 ``a*b + c`` (round-to-odd in float64, then
    one rounding; see ``repro_torch.kernels.ref.fma``)."""
    a, b, c = (np.asarray(v, np.float64) for v in (a, b, c))
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    fix = (err != 0) & ((s.view(np.int64) & 1) == 0) & np.isfinite(s)
    s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def _expf(x) -> np.ndarray:
    """Elementwise float32 ``exp`` as XLA's CPU backend computes it.

    ``e^x = e^a · 2^n`` with ``n = floor(x·log2(e) + ½)`` and a degree-6
    Cephes polynomial for ``e^a``, every multiply-add contracted to one FMA
    and results below the smallest normal flushed to 0.  Matches the
    reference's ``jnp.exp`` on every float32 input checked (a sweep of
    1.7·10⁸ values over ±90), where the C library's ``expf`` differs in the
    last place on about 10% of them.
    """
    f = np.float32
    x = np.clip(np.asarray(x, f), f(-87.8), f(88.8))
    n = np.clip(np.floor(_fmaf(x, f(1.44269504088896341), f(0.5))), f(-127), f(127))
    a = _fmaf(-f(0.693359375), n, x)
    a = _fmaf(-f(-2.12194440e-4), n, a)
    z = _fmaf(a, f(1.9875691500e-4), f(1.3981999507e-3))
    for coef in (8.3334519073e-3, 4.1665795894e-2, 1.6666665459e-1, 5.0000001201e-1):
        z = _fmaf(z, a, f(coef))
    z = f(1.0) + _fmaf(z, a * a, a)
    with np.errstate(over="ignore"):  # x near 88.8 rounds to inf, as XLA's does
        out = (z * np.ldexp(f(1.0), n.astype(np.int32))).astype(f)
    return np.where(out < np.finfo(f).tiny, f(0.0), out)


def _clip_psi(psi) -> np.ndarray:
    return np.clip(np.asarray(psi, np.float32), np.float32(0.0), np.float32(1.0))


@dataclasses.dataclass(frozen=True)
class ExpWeighting:
    """φ(ψ) = k^(ψ^γ − target^γ): flat among idle pools, steep among
    congested ones; φ(target) = 1 and φ(1)/φ(0) = k."""

    k: float = 8.0  # φ(100%) / φ(0%)
    target: float = 0.6  # utilization at which φ crosses 1.0
    gamma: float = 3.0  # convexity

    def __call__(self, psi):
        psi = _clip_psi(psi)
        expo = _powf(psi, self.gamma) - np.float32(self.target**self.gamma)
        return _powf(np.float32(self.k), expo)


@dataclasses.dataclass(frozen=True)
class LogisticWeighting:
    """log φ follows a normalized sigmoid centred at ``target``:
    ŝ(ψ) = (σ(s(ψ−t)) − σ(−st)) / (σ(s(1−t)) − σ(−st)),  φ(ψ) = k^(ŝ(ψ) − ŝ(t))."""

    k: float = 8.0
    target: float = 0.85
    steepness: float = 10.0

    def _shat(self, psi):
        # constants fold in double precision and round once, as the
        # reference's Python-float arithmetic does
        s, t = self.steepness, self.target
        one = np.float32(1.0)
        sig = lambda x: one / (one + _expf(-np.asarray(x, np.float32)))
        lo, hi = sig(-s * t), sig(s * (1.0 - t))
        return (sig(np.float32(s) * (psi - np.float32(t))) - lo) / (hi - lo)

    def __call__(self, psi):
        psi = _clip_psi(psi)
        t = np.asarray(self.target, np.float32)
        return _powf(np.float32(self.k), self._shat(psi) - self._shat(t))


@dataclasses.dataclass(frozen=True)
class PiecewisePowerWeighting:
    """Linear rise to 1 below the target, power-law blow-up to k·φ0 above it."""

    k: float = 8.0
    target: float = 0.6
    gamma: float = 3.0
    phi0: float = 0.5  # φ(0)

    def __call__(self, psi):
        psi = _clip_psi(psi)
        t, g, p0 = self.target, self.gamma, self.phi0
        f = np.float32  # constants fold in double precision, then round once
        below = f(p0) + f(1.0 - p0) * (psi / f(t))
        above = f(1.0) + f(self.k * p0 - 1.0) * _powf(
            np.maximum(psi - f(t), f(0.0)) / f(1.0 - t), g
        )
        return np.where(psi <= f(t), below, above).astype(np.float32)


DEFAULT_WEIGHTING = ExpWeighting()

CURVE_FAMILIES: dict[str, WeightingFn] = {
    "exp": ExpWeighting(),
    "logistic": LogisticWeighting(),
    "piecewise": PiecewisePowerWeighting(),
}


def reserve_prices(
    pools: Sequence[ResourcePool],
    weighting: WeightingFn | None = None,
) -> np.ndarray:
    """p̃_r = φ_r(ψ(r)) · c(r) for every pool (eq. 4), float32."""
    weighting = weighting or DEFAULT_WEIGHTING
    psi = np.asarray([p.utilization for p in pools], dtype=np.float32)
    cost = np.asarray([p.base_cost for p in pools], dtype=np.float32)
    return np.asarray(weighting(psi), np.float32) * cost


# per-epoch EMA weight of the newest delivered-capacity observation in a
# pool's reliability score
RELIABILITY_EMA = 0.5


def reliability_discounted_psi(
    psi: np.ndarray, reliability: np.ndarray, discount: float = 1.0
) -> np.ndarray:
    """Utilization after discounting capacity by reliability: a pool that
    delivers ``reliability`` of its capacity effectively has
    ``1 − discount·(1 − reliability)`` of it.  All-ones reliability is the
    identity."""
    psi = np.asarray(psi, dtype=np.float32)
    rel = np.clip(np.asarray(reliability, dtype=np.float32), 0.0, 1.0)
    eff = np.maximum(1.0 - np.float32(discount) * (1.0 - rel), np.float32(1e-6))
    return np.clip(psi / eff, 0.0, 1.0)


def reputation_weighted_reserve(
    pools: Sequence[ResourcePool],
    weighting: WeightingFn | None = None,
    reliability: np.ndarray | None = None,
    discount: float = 1.0,
) -> np.ndarray:
    """p̃_r = φ_r(ψ_eff(r)) · c(r): unreliable pools see a higher effective
    utilization and so a higher reserve.  ``reliability=None`` reads each
    pool's own field; all ones reproduces :func:`reserve_prices`."""
    weighting = weighting or DEFAULT_WEIGHTING
    psi = np.asarray([p.utilization for p in pools], dtype=np.float32)
    cost = np.asarray([p.base_cost for p in pools], dtype=np.float32)
    if reliability is None:
        reliability = np.asarray([p.reliability for p in pools], dtype=np.float32)
    psi_eff = reliability_discounted_psi(psi, reliability, discount)
    return np.asarray(weighting(psi_eff), np.float32) * cost
