"""Wrappers for the port's CUDA kernels, and demand-fn adapters over them.

A wrapper given CPU tensors runs the kernel's plain PyTorch version
(:mod:`.ref`); given CUDA tensors it launches the kernel or raises.  There is
no fallback from one to the other.  ``plain=True`` forces the plain version
on CUDA tensors too: it exists so a run on the card can hold the kernels
against their plain versions, and nothing on the main path passes it.

Each kernel entry point (``bid_eval``, ``sparse_bid_eval_z``,
``sparse_bid_eval_partials``, ``sparse_bid_eval_csr_z``, ``wkv6``) counts its launches
(:func:`launch_counts`, :func:`reset_launch_counts`), so a run can show that
its main path went through the kernels.  Kernels run on PyTorch's current
stream and do not synchronise; outputs and scratch are allocated here.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    ("clock_bid_eval", "bid_eval"): (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    ("sparse_bid_eval", "sparse_bid_eval_z"): (
        _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P,
    ),
    ("sparse_bid_eval", "sparse_bid_eval_partials"): (
        _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
    ),
    ("sparse_bid_eval_csr", "sparse_bid_eval_csr_z"): (
        _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _P, _P,
    ),
    ("wkv6", "wkv6"): (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
}


_LAUNCHES = {fn: 0 for _, fn in _SIGNATURES}
# the partials kernel's user blocks are one grid dimension
MAX_BLOCKS = 65535
# wkv6 works in one tile a chunk: at most 32 tokens by 64 keys
WKV6_MAX_CHUNK, WKV6_MAX_K = 32, 64


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


@functools.lru_cache(maxsize=None)
def _fold_windows(n: int) -> int:
    """Window sums over all levels of the block fold of ``n`` rows (at least
    1): the partials kernel's scratch, in units of num_blocks · R floats."""
    return max(sum(-(-n_in // ref.FOLD_WINDOW) for n_in, _ in ref.fold_plan(n)), 1)


def _stream(device: torch.device) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device is visible to launch a kernel on {device}")
    return torch.cuda.current_stream(device).cuda_stream


def _check_book(idx, val, mask, pi, prices, num_resources):
    u, b, k = idx.shape
    dev = idx.device
    _check("idx", idx, torch.int32, (u, b, k), dev)
    _check("val", val, torch.float32, (u, b, k), dev)
    _check("mask", mask, torch.bool, (u, b), dev)
    _check("pi", pi, torch.float32, (u,) if pi.ndim == 1 else (u, b), dev)
    _check("prices", prices, torch.float32, (num_resources,), dev)


def bid_eval(
    bundles: torch.Tensor,
    mask: torch.Tensor,
    pi: torch.Tensor,
    prices: torch.Tensor,
    *,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One dense clock round, scalar π → ``(z (R,), chosen (U,) int32)``;
    chosen exact and z bit-identical to :func:`.ref.bid_eval`."""
    if bundles.device.type == "cpu" or plain:
        return ref.bid_eval(bundles, mask, pi, prices)
    if bundles.device.type != "cuda":
        raise ValueError(f"bid_eval runs on CPU or CUDA tensors, got {bundles.device}")
    if bundles.ndim != 3 or pi.ndim != 1:
        raise ValueError(f"bid_eval takes (U, B, R) bundles and scalar (U,) pi, got "
                         f"{tuple(bundles.shape)} and {tuple(pi.shape)}")
    u, b, r = bundles.shape
    dev = bundles.device
    _check("bundles", bundles, torch.float32, (u, b, r), dev)
    _check("mask", mask, torch.bool, (u, b), dev)
    _check("pi", pi, torch.float32, (u,), dev)
    _check("prices", prices, torch.float32, (r,), dev)
    chosen = torch.empty(u, dtype=torch.int32, device=dev)
    z = torch.empty(r, dtype=torch.float32, device=dev)
    n_scratch = sum(-(-n // ref.FOLD_WINDOW) for n, _ in ref.fold_plan(u))
    scratch = torch.empty(max(n_scratch, 1) * r, dtype=torch.float32, device=dev)
    _launch(
        "clock_bid_eval", "bid_eval",
        bundles.data_ptr(), mask.data_ptr(), pi.data_ptr(), prices.data_ptr(), u, b, r,
        chosen.data_ptr(), scratch.data_ptr(), z.data_ptr(), _stream(dev),
    )
    return z, chosen


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
    if not 1 <= num_blocks <= MAX_BLOCKS:
        raise ValueError(f"sparse_bid_eval: num_blocks {num_blocks} outside 1..{MAX_BLOCKS}")
    m = -(-u // num_blocks)
    scratch = torch.empty(_fold_windows(m) * num_blocks * num_resources,
                          dtype=torch.float32, device=dev)
    partials = torch.empty((num_blocks, num_resources), dtype=torch.float32, device=dev)
    vectorized = int(m * num_blocks == u and num_resources <= ref.ONEHOT_ROWS_MAX_R)
    _launch(
        "sparse_bid_eval", "sparse_bid_eval_partials",
        idx.data_ptr(), val.data_ptr(), mask.data_ptr(), pi.data_ptr(), pi_vector,
        prices.data_ptr(), u, b, k, num_resources, num_blocks, vectorized, chosen.data_ptr(),
        scratch.data_ptr(), partials.data_ptr(), _stream(dev),
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


def wkv6(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    state: torch.Tensor | None = None,
    chunk: int = 32,
    *,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The chunked RWKV-6 recurrence over a batch → ``(o (B, T, H, V),
    final state (B, H, K, V))``, both float32.

    r, k ``(B, T, H, K)`` and v ``(B, T, H, V)`` in float32 or bfloat16 (one
    dtype), w ``(B, T, H, K)`` and u ``(H, K)`` float32, state ``(B, H, K,
    V)`` float32 or None for zeros; chunks of ``min(chunk, T)`` tokens.
    Float-close to :func:`.ref.wkv6_chunked`, which CPU tensors run.  The
    kernel takes chunks of at most 32 tokens and K ≤ 64 (one tile), any V.
    """
    if r.device.type == "cpu" or plain:
        return ref.wkv6_chunked(r, k, v, w, u, state, chunk)
    if r.device.type != "cuda":
        raise ValueError(f"wkv6 runs on CPU or CUDA tensors, got {r.device}")
    if r.ndim != 4 or v.ndim != 4:
        raise ValueError(f"wkv6 takes (B, T, H, K) r and (B, T, H, V) v, got "
                         f"{tuple(r.shape)} and {tuple(v.shape)}")
    if r.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"wkv6: r, k, v in float32 or bfloat16, got {r.dtype}")
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    dev = r.device
    _check("r", r, r.dtype, (b, t, h, kd), dev)
    _check("k", k, r.dtype, (b, t, h, kd), dev)
    _check("v", v, r.dtype, (b, t, h, vd), dev)
    _check("w", w, torch.float32, (b, t, h, kd), dev)
    _check("u", u, torch.float32, (h, kd), dev)
    if state is not None:
        _check("state", state, torch.float32, (b, h, kd, vd), dev)
    if t == 0 or chunk < 1:
        raise ValueError(f"wkv6: T = {t} tokens in chunks of {chunk}")
    if min(chunk, t) > WKV6_MAX_CHUNK or kd > WKV6_MAX_K:
        raise ValueError(f"wkv6: the kernel takes chunks of at most {WKV6_MAX_CHUNK} tokens "
                         f"and K <= {WKV6_MAX_K}, got {min(chunk, t)} and K = {kd}")
    stream = _stream(dev)
    o = torch.empty((b, t, h, vd), dtype=torch.float32, device=dev)
    s_out = torch.empty((b, h, kd, vd), dtype=torch.float32, device=dev)
    _launch(
        "wkv6", "wkv6",
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if state is None else state.data_ptr(), b, t, h, kd, vd, min(chunk, t),
        int(r.dtype == torch.bfloat16), o.data_ptr(), s_out.data_ptr(), stream,
    )
    return o, s_out


def launch_counts() -> dict[str, int]:
    """Launches of each kernel entry point since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for fn in _LAUNCHES:
        _LAUNCHES[fn] = 0


# ---------------------------------------------------------------------------
# demand-fn adapters (the auction's DemandFn signatures)
# ---------------------------------------------------------------------------


def bid_demand_fn(plain: bool = False):
    """Dense demand fn ``demand(bundles, mask, pi, prices) -> (z, chosen,
    active)``.  Scalar π runs :func:`bid_eval`.  Vector π runs the
    ``sparse_bid_eval`` kernel on the exact (idx, val) form of the book
    (:func:`.ref.dense_to_sparse`, K = R), since the dense kernel has only
    the scalar rule, and z folds the chosen rows as the reference's clock
    does (:func:`.ref.dense_fold`)."""

    def demand(bundles, mask, pi, prices):
        if pi.ndim == 1:
            z, chosen = bid_eval(bundles, mask, pi, prices, plain=plain)
            return z, chosen, chosen >= 0
        idx, val = ref.dense_to_sparse(bundles)
        _, chosen = sparse_bid_eval(idx, val, mask, pi, prices, bundles.shape[-1], plain=plain)
        return ref.dense_fold(ref.selected_rows(bundles, chosen).T), chosen, chosen >= 0

    demand.dense_signature = True  # type: ignore[attr-defined]
    return demand


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
