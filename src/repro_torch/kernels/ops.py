"""Wrappers for the port's CUDA kernels, and demand-fn adapters over them.

A wrapper given CPU tensors runs the kernel's plain PyTorch version
(:mod:`.ref`); given CUDA tensors it launches the kernel or raises.  There is
no fallback from one to the other.  ``plain=True`` forces the plain version
on CUDA tensors too: it exists so a run on the card can hold the kernels
against their plain versions, and nothing on the main path passes it.

Each kernel entry point (``sparse_bid_eval_z``, ``sparse_bid_eval_partials``,
``sparse_bid_eval_csr_z``) counts its launches (:func:`launch_counts`,
:func:`reset_launch_counts`), so a run can show that its main path went
through the kernels.  Kernels run on PyTorch's current
stream and do not synchronise; outputs and scratch are allocated here.
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    ("sparse_bid_eval", "sparse_bid_eval_z"): (
        _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P,
    ),
    ("sparse_bid_eval", "sparse_bid_eval_partials"): (
        _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P,
    ),
    ("sparse_bid_eval_csr", "sparse_bid_eval_csr_z"): (
        _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P,
    ),
}


_LAUNCHES = {fn: 0 for _, fn in _SIGNATURES}


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def _launch(lib: str, fn: str, *args) -> None:
    """Launch kernel entry ``fn`` of library ``lib``, check the cudaError it
    returns, and count the launch."""
    f = getattr(build.library(lib), fn)
    if f.argtypes is None:
        f.restype = ctypes.c_int
        f.argtypes = _SIGNATURES[(lib, fn)]
    err = f(*args)
    if err != 0:
        raise RuntimeError(f"{fn}: CUDA launch failed with cudaError {err}")
    _LAUNCHES[fn] += 1


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _check_book(idx, val, mask, pi, prices, num_resources):
    u, b, k = idx.shape
    dev = idx.device
    _check("idx", idx, torch.int32, (u, b, k), dev)
    _check("val", val, torch.float32, (u, b, k), dev)
    _check("mask", mask, torch.bool, (u, b), dev)
    _check("pi", pi, torch.float32, (u,) if pi.ndim == 1 else (u, b), dev)
    _check("prices", prices, torch.float32, (num_resources,), dev)


def sparse_bid_eval(
    idx: torch.Tensor,
    val: torch.Tensor,
    mask: torch.Tensor,
    pi: torch.Tensor,
    prices: torch.Tensor,
    num_resources: int,
    num_blocks: int | None = None,
    *,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One clock round over the K-padded book → ``(z or partials, chosen)``.

    ``num_blocks=None``: z (R,) through float atomics (float-close).  An int:
    the deterministic (num_blocks, R) block partials, bit-identical to
    :func:`.ref.block_partials`.  See :func:`.ref.sparse_bid_eval`.
    """
    if idx.device.type == "cpu" or plain:
        return ref.sparse_bid_eval(idx, val, mask, pi, prices, num_resources, num_blocks)
    if idx.device.type != "cuda":
        raise ValueError(f"sparse_bid_eval runs on CPU or CUDA tensors, got {idx.device}")
    _check_book(idx, val, mask, pi, prices, num_resources)
    u, b, k = idx.shape
    dev = idx.device
    chosen = torch.empty(u, dtype=torch.int32, device=dev)
    pi_vector = int(pi.ndim == 2)
    if num_blocks is None:
        z = torch.zeros(num_resources, dtype=torch.float32, device=dev)
        _launch(
            "sparse_bid_eval", "sparse_bid_eval_z",
            idx.data_ptr(), val.data_ptr(), mask.data_ptr(), pi.data_ptr(), pi_vector,
            prices.data_ptr(), u, b, k, num_resources, chosen.data_ptr(), z.data_ptr(),
            _stream(dev),
        )
        return z, chosen
    m = -(-u // num_blocks)
    u_pad = m * num_blocks
    sel_idx = torch.empty((u_pad, k), dtype=torch.int32, device=dev)
    sel_val = torch.empty((u_pad, k), dtype=torch.float32, device=dev)
    n_scratch = sum(-(-n // ref.FOLD_WINDOW) for n, _ in ref.fold_plan(m))
    scratch = torch.empty(max(n_scratch, 1) * num_blocks * num_resources,
                          dtype=torch.float32, device=dev)
    partials = torch.empty((num_blocks, num_resources), dtype=torch.float32, device=dev)
    vectorized = int(u_pad == u and num_resources <= ref.ONEHOT_ROWS_MAX_R)
    _launch(
        "sparse_bid_eval", "sparse_bid_eval_partials",
        idx.data_ptr(), val.data_ptr(), mask.data_ptr(), pi.data_ptr(), pi_vector,
        prices.data_ptr(), u, b, k, num_resources, num_blocks, vectorized, chosen.data_ptr(),
        sel_idx.data_ptr(), sel_val.data_ptr(), scratch.data_ptr(), partials.data_ptr(),
        _stream(dev),
    )
    return partials, chosen


def sparse_bid_eval_csr(
    idx: torch.Tensor,
    val: torch.Tensor,
    offsets: torch.Tensor,
    mask: torch.Tensor,
    pi: torch.Tensor,
    prices: torch.Tensor,
    num_resources: int,
    k_bound: int,
    *,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One clock round over flat CSR streams → ``(z (R,), chosen (U,))``;
    z through float atomics (float-close).  See :func:`.ref.sparse_bid_eval_csr`."""
    if idx.device.type == "cpu" or plain:
        return ref.sparse_bid_eval_csr(
            idx, val, offsets, mask, pi, prices, num_resources, k_bound
        )
    if idx.device.type != "cuda":
        raise ValueError(f"sparse_bid_eval_csr runs on CPU or CUDA tensors, got {idx.device}")
    u, b = mask.shape
    nnz = idx.shape[0]
    dev = idx.device
    _check("idx", idx, torch.int32, (nnz,), dev)
    _check("val", val, torch.float32, (nnz,), dev)
    _check("offsets", offsets, torch.int32, (u * b + 1,), dev)
    _check("mask", mask, torch.bool, (u, b), dev)
    _check("pi", pi, torch.float32, (u,) if pi.ndim == 1 else (u, b), dev)
    _check("prices", prices, torch.float32, (num_resources,), dev)
    chosen = torch.empty(u, dtype=torch.int32, device=dev)
    z = torch.zeros(num_resources, dtype=torch.float32, device=dev)
    _launch(
        "sparse_bid_eval_csr", "sparse_bid_eval_csr_z",
        idx.data_ptr(), val.data_ptr(), offsets.data_ptr(), mask.data_ptr(), pi.data_ptr(),
        int(pi.ndim == 2), prices.data_ptr(), u, b, k_bound, num_resources,
        chosen.data_ptr(), z.data_ptr(), _stream(dev),
    )
    return z, chosen


def launch_counts() -> dict[str, int]:
    """Launches of each kernel entry point since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for fn in _LAUNCHES:
        _LAUNCHES[fn] = 0


# ---------------------------------------------------------------------------
# demand-fn adapters (the auction's DemandFn signatures)
# ---------------------------------------------------------------------------


def csr_bid_demand_fn(plain: bool = False):
    """CSR demand fn ``demand(problem, prices, aux=None) -> (z, chosen, active)``."""

    def demand(problem, prices, aux=None):
        z, chosen = sparse_bid_eval_csr(
            problem.idx, problem.val, problem.offsets, problem.bundle_mask, problem.pi,
            prices, problem.num_resources, problem.k_bound, plain=plain,
        )
        return z, chosen, chosen >= 0

    demand.csr_signature = True  # type: ignore[attr-defined]
    return demand


def sparse_bid_demand_fn(plain: bool = False):
    """Padded demand fn ``demand(idx, val, mask, pi, prices, R) -> (z, chosen,
    active)`` with the z-mode kernel: float-close z, the fast planet-scale
    path."""

    def demand(idx, val, mask, pi, prices, num_resources):
        z, chosen = sparse_bid_eval(idx, val, mask, pi, prices, num_resources, plain=plain)
        return z, chosen, chosen >= 0

    demand.sparse_signature = True  # type: ignore[attr-defined]
    return demand


def blocked_bid_demand_fn(num_blocks: int = 8, plain: bool = False):
    """Settlement demand fn: the partials-mode kernel plus the fixed left fold
    over blocks — the kernel-backed twin of
    :func:`repro_torch.core.auction.sparse_proxy_demand_blocked`, bit for bit."""

    def demand(idx, val, mask, pi, prices, num_resources):
        partials, chosen = sparse_bid_eval(
            idx, val, mask, pi, prices, num_resources, num_blocks, plain=plain
        )
        return ref.chain_sum(partials), chosen, chosen >= 0

    demand.sparse_signature = True  # type: ignore[attr-defined]
    demand.exact_settlement = True  # type: ignore[attr-defined]
    demand.num_blocks = num_blocks  # type: ignore[attr-defined]
    return demand
