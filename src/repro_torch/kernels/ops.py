"""Wrappers for the port's CUDA kernels, and demand-fn adapters over them.

A wrapper given CPU tensors runs the kernel's plain PyTorch version
(:mod:`.ref`); given CUDA tensors it launches the kernel or raises.  There is
no fallback from one to the other.  ``plain=True`` forces the plain version
on CUDA tensors too: it exists so a run on the card can hold the kernels
against their plain versions, and nothing on the main path passes it.

Each kernel entry point (``bid_eval``, ``sparse_bid_eval_z``,
``sparse_bid_eval_partials``, ``sparse_bid_eval_csr_z``, ``wkv6``,
``ordered_scatter_add``, ``ordered_rows_add``) counts its launches (:func:`launch_counts`,
:func:`reset_launch_counts`), so a run can show that its main path went
through the kernels.  A launch recorded into a CUDA graph
(:class:`CountedGraph`) is counted on every replay of the graph, not at the
capture.  Kernels run on PyTorch's current stream and do not synchronise;
outputs and scratch are allocated here.
"""
from __future__ import annotations

import ctypes
import functools
import math
import sys
import time
from typing import NamedTuple

import torch

from . import build, ref

_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    ("clock_bid_eval", "bid_eval"): (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P),
    ("sparse_bid_eval", "sparse_bid_eval_z"): (
        _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P,
    ),
    ("sparse_bid_eval", "sparse_bid_eval_partials"): (
        _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P,
    ),
    ("sparse_bid_eval_csr", "sparse_bid_eval_csr_z"): (
        _P, _P, _P, _P, _P, _I, _P, _I, _I, _I, _I, _P, _I, _P, _P, _P,
    ),
    ("wkv6", "wkv6"): (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    ("ordered_scatter", "ordered_scatter_add"): (
        _P, _I, _P, _I, ctypes.c_longlong, _I, _I, _I, _P, _P, _P, _I, _I, _I, _P,
    ),
    ("ordered_rows", "ordered_rows_add"): (
        _P, _I, _P, _P, _I, ctypes.c_longlong, _I, ctypes.c_longlong, _I, _I, _I, _I, _I, _I, _I,
        _P, _P,
    ),
}


_LAUNCHES = {fn: 0 for _, fn in _SIGNATURES}
_CAPTURES = {"graphs": 0, "seconds": 0.0}  # CUDA graphs captured, and the host time it took
# the partials kernel's user blocks are one grid dimension
MAX_BLOCKS = 65535
# wkv6 works in one tile a chunk: at most 32 tokens by 64 keys
WKV6_MAX_CHUNK, WKV6_MAX_K = 32, 64

# ---------------------------------------------------------------------------
# z mode: the span plans.  A z-mode CTA owns one contiguous span of users,
# stages that span of the book into shared memory and adds its chosen terms
# into z once.  The plans below fix the span and the shared-memory carve-up
# (in 4-byte words, each region 16-byte aligned) on the host; the kernels
# take them as they are (csrc/sparse_bid_eval.cu, csrc/sparse_bid_eval_csr.cu).
# ---------------------------------------------------------------------------

# The limits below were chosen with tools/z_split.py on an NVIDIA H100 80GB
# HBM3 at 700 W: at most 512 users in 64 KB a CTA (three CTAs an SM) beat
# 1,024 users in ~100 KB at the economy (R = 24) and CSR books and tie at
# the planet book.
Z_THREADS = 512  # threads of a z-mode CTA, at most: the kernels' __launch_bounds__
Z_MAX_SPAN = 512  # users a z-mode CTA owns, at most
Z_SMEM_BUDGET = 64 * 1024  # bytes of shared memory a CTA
Z_STAGE_MAX_R = 4096  # prices and the z tile live in shared memory up to this R
Z_WARP_TILE_MAX_R = 128  # z summed in one shared tile a warp, without atomics, up to this R
CSR_SLACK = 1.25  # room for a CSR span's elements over the book's mean


class ZPlan(NamedTuple):
    """One padded-book z-mode CTA: ``span`` users on ``threads`` threads;
    the book staged (``stage_book``) or read from device memory; prices
    staged; z summed through global atomics (``z_mode`` 0), one shared tile
    (1) or one shared tile a warp (2); idx/val rows ``ik`` words apart, pi
    rows ``pv`` (:func:`_row_stride`); word offsets of each region,
    ``words`` in all."""

    span: int
    threads: int
    stage_book: int
    stage_prices: int
    z_mode: int
    ik: int
    pv: int
    idx: int
    val: int
    pi: int
    mask: int
    prices: int
    sel: int
    z: int
    words: int


class CsrZPlan(NamedTuple):
    """One CSR z-mode CTA: ``span`` users on ``threads`` threads; its
    ``span·B + 1`` offsets and, when they fit in ``cap`` elements from the
    16-byte boundary at or below their start, its stretch of the idx/val
    streams staged (else read from device memory); the rest as
    :class:`ZPlan`."""

    span: int
    threads: int
    stage_prices: int
    z_mode: int
    pv: int
    cap: int
    off: int
    idx: int
    val: int
    pi: int
    mask: int
    prices: int
    sel: int
    z: int
    words: int


def _carve(**sizes: int) -> tuple[dict[str, int], int]:
    """Word offsets of consecutive regions, each rounded up to 4 words."""
    at, offsets = 0, {}
    for name, words in sizes.items():
        offsets[name] = at
        at += -(-words // 4) * 4
    return offsets, at


def _row_stride(n: int) -> int:
    """Words from one staged row of n words to the next: n itself where rows
    back to back meet at most two-way bank conflicts (n odd, or 2 mod 4;
    copied by 16 bytes), else the next odd n (copied by 4 bytes)."""
    return n if n % 4 == 2 else n | 1


def _z_common(num_bundles: int, num_resources: int, pi_vector: bool) -> tuple[int, int, int]:
    """(pv, stage_prices, z_mode) of both books."""
    stage_prices = int(num_resources <= Z_STAGE_MAX_R)
    z_mode = 0 if not stage_prices else 2 if num_resources <= Z_WARP_TILE_MAX_R else 1
    return _row_stride(num_bundles) if pi_vector else 1, stage_prices, z_mode


def _z_words(z_mode: int, threads: int, num_resources: int) -> int:
    """Words of the z tiles: none, one (R,) tile, or one a warp."""
    return (0, num_resources, threads // 32 * num_resources)[z_mode]


@functools.lru_cache(maxsize=None)
def z_plan(num_bundles: int, k: int, num_resources: int, pi_vector: bool,
           max_span: int = Z_MAX_SPAN) -> ZPlan:
    """The padded book's span plan: the most users (a multiple of 32, at
    most ``max_span``) whose staged rows fit in :data:`Z_SMEM_BUDGET`; with
    fewer than 32 the book is read from device memory instead."""
    if num_bundles < 1 or k < 1 or max_span < 32 or max_span % 32:
        raise ValueError(f"z mode: B = {num_bundles}, K = {k}, span {max_span}")
    ik = _row_stride(num_bundles * k)
    pv, stage_prices, z_mode = _z_common(num_bundles, num_resources, pi_vector)
    r_words = num_resources if stage_prices else 0  # the staged prices

    def plan(span: int, stage_book: int) -> ZPlan:
        s, threads = (span if stage_book else 0), min(Z_THREADS, span)
        at, words = _carve(
            idx=s * ik, val=s * ik, pi=s * pv,
            mask=(s * num_bundles + 3) // 4 + 1 if stage_book else 0,  # whole words + a shift
            prices=r_words, sel=span, z=_z_words(z_mode, threads, num_resources))
        return ZPlan(span, threads, stage_book, stage_prices, z_mode, ik, pv, **at, words=words)

    for span in range(max_span, 31, -32):
        if 4 * plan(span, 1).words <= Z_SMEM_BUDGET:
            return plan(span, 1)
    return plan(max_span, 0)


@functools.lru_cache(maxsize=256)
def csr_z_plan(num_users: int, num_bundles: int, nnz: int, num_resources: int,
               pi_vector: bool, max_span: int = Z_MAX_SPAN) -> CsrZPlan:
    """The CSR book's span plan: the most users (a multiple of 32, at most
    ``max_span``) whose offsets, pi, mask and ``CSR_SLACK`` × the book's mean
    elements a user fit in :data:`Z_SMEM_BUDGET`; ``cap``, the elements a
    CTA's stretch may hold, takes what the budget leaves.  A CTA whose
    stretch is longer reads it from device memory."""
    if num_bundles < 1 or max_span < 32 or max_span % 32:
        raise ValueError(f"csr z mode: B = {num_bundles}, span {max_span}")
    pv, stage_prices, z_mode = _z_common(num_bundles, num_resources, pi_vector)
    r_words = num_resources if stage_prices else 0  # the staged prices
    mean = nnz / max(num_users, 1)

    def plan(span: int, cap: int) -> CsrZPlan:
        threads = min(Z_THREADS, span)
        at, words = _carve(
            off=span * num_bundles + 1, idx=cap, val=cap, pi=span * pv,
            mask=(span * num_bundles + 3) // 4 + 1, prices=r_words, sel=span,
            z=_z_words(z_mode, threads, num_resources))
        return CsrZPlan(span, threads, stage_prices, z_mode, pv, cap, **at, words=words)

    def fits(span: int) -> bool:
        need = -(-int(span * mean * CSR_SLACK) // 4) * 4
        return 4 * plan(span, need).words <= Z_SMEM_BUDGET

    span = next((s for s in range(max_span, 31, -32) if fits(s)), 32)
    cap = (Z_SMEM_BUDGET // 4 - plan(span, 0).words) // 8 * 4  # words left, halved, whole 16 B
    if cap < 0:
        raise ValueError(f"csr z mode: {num_bundles} bundles a user do not fit a "
                         f"{span}-user span in {Z_SMEM_BUDGET} bytes")
    return plan(span, cap)


@functools.lru_cache(maxsize=256)
def _plan_ints(plan: tuple) -> ctypes.Array:
    """The plan as the C array the kernel's entry point reads."""
    return (ctypes.c_int * len(plan))(*plan)


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
    standalone_fold: bool = False,
    plain: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One clock round over the K-padded book → ``(z or partials, chosen)``.

    ``num_blocks=None``: z (R,) through float atomics (float-close).  An int:
    the deterministic (num_blocks, R) block partials, bit-identical to
    :func:`.ref.block_partials`; ``standalone_fold`` fixes the fold form of
    a block reduce that stands alone (the fused epoch's), which is otherwise
    inferred from the book's shape.  See :func:`.ref.sparse_bid_eval`.
    """
    if idx.device.type == "cpu" or plain:
        return ref.sparse_bid_eval(idx, val, mask, pi, prices, num_resources, num_blocks,
                                   standalone_fold)
    if idx.device.type != "cuda":
        raise ValueError(f"sparse_bid_eval runs on CPU or CUDA tensors, got {idx.device}")
    _check_book(idx, val, mask, pi, prices, num_resources)
    u, b, k = idx.shape
    dev = idx.device
    chosen = torch.empty(u, dtype=torch.int32, device=dev)
    pi_vector = int(pi.ndim == 2)
    if num_blocks is None:
        plan = _plan_ints(z_plan(b, k, num_resources, bool(pi_vector)))
        z = torch.empty(num_resources, dtype=torch.float32, device=dev)
        _launch(
            "sparse_bid_eval", "sparse_bid_eval_z",
            idx.data_ptr(), val.data_ptr(), mask.data_ptr(), pi.data_ptr(), pi_vector,
            prices.data_ptr(), u, b, k, num_resources, plan, len(plan), chosen.data_ptr(),
            z.data_ptr(), _stream(dev),
        )
        return z, chosen
    if not 1 <= num_blocks <= MAX_BLOCKS:
        raise ValueError(f"sparse_bid_eval: num_blocks {num_blocks} outside 1..{MAX_BLOCKS}")
    m = -(-u // num_blocks)
    scratch = torch.empty(_fold_windows(m) * num_blocks * num_resources,
                          dtype=torch.float32, device=dev)
    partials = torch.empty((num_blocks, num_resources), dtype=torch.float32, device=dev)
    vectorized = -1 if standalone_fold else int(
        m * num_blocks == u and num_resources <= ref.ONEHOT_ROWS_MAX_R)
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
    plan = _plan_ints(csr_z_plan(u, b, nnz, num_resources, pi.ndim == 2))
    chosen = torch.empty(u, dtype=torch.int32, device=dev)
    z = torch.empty(num_resources, dtype=torch.float32, device=dev)
    _launch(
        "sparse_bid_eval_csr", "sparse_bid_eval_csr_z",
        idx.data_ptr(), val.data_ptr(), offsets.data_ptr(), mask.data_ptr(), pi.data_ptr(),
        int(pi.ndim == 2), prices.data_ptr(), u, b, k_bound, num_resources, plan, len(plan),
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
    DTensor inputs run :func:`_sharded_wkv6` on each rank's heads.

    The call is the custom op ``repro_torch::wkv6``: its fake version gives
    the output shapes alone, so a step runs on fake tensors (the dry run),
    and its gradient is the plain version's, recomputed (the kernel has no
    backward, as the reference's Pallas kernel has none).
    """
    if is_dtensor(r):
        return _sharded_wkv6(r, k, v, w, u, state, chunk, plain)
    if r.device.type != "cpu" and not plain:
        _wkv6_check(r, k, v, w, u, state, chunk)
    return _wkv6_op(r, k, v, w, u, state, chunk, plain)


def _wkv6_check(r, k, v, w, u, state, chunk) -> None:
    """Raise unless the kernel takes these inputs and a GPU is visible."""
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
    _stream(dev)


@torch.library.custom_op("repro_torch::wkv6", mutates_args=())
def _wkv6_op(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
             u: torch.Tensor, state: torch.Tensor | None, chunk: int, plain: bool
             ) -> tuple[torch.Tensor, torch.Tensor]:
    if r.device.type == "cpu" or plain:
        return ref.wkv6_chunked(r, k, v, w, u, state, chunk)
    _wkv6_check(r, k, v, w, u, state, chunk)
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    dev = r.device
    o = torch.empty((b, t, h, vd), dtype=torch.float32, device=dev)
    s_out = torch.empty((b, h, kd, vd), dtype=torch.float32, device=dev)
    _launch(
        "wkv6", "wkv6",
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if state is None else state.data_ptr(), b, t, h, kd, vd, min(chunk, t),
        int(r.dtype == torch.bfloat16), o.data_ptr(), s_out.data_ptr(), _stream(dev),
    )
    return o, s_out


@_wkv6_op.register_fake
def _wkv6_fake(r, k, v, w, u, state, chunk, plain):
    *lead, h, kd = r.shape  # (B, T) or (T,)
    vd = v.shape[-1]
    o = r.new_empty((*lead, h, vd), dtype=torch.float32)
    return o, r.new_empty((*lead[:-1], h, kd, vd), dtype=torch.float32)


def _wkv6_setup(ctx, inputs, output):
    r, k, v, w, u, state, chunk, _ = inputs
    ctx.save_for_backward(r, k, v, w, u, state)
    ctx.chunk = chunk
    ctx.set_materialize_grads(False)


def _wkv6_backward(ctx, grad_o, grad_state):
    """The plain version's gradient, through autograd over a recompute."""
    leaves = [None if t is None else t.detach().requires_grad_(need)
              for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    wanted = [t for t in leaves if t is not None and t.requires_grad]
    with torch.enable_grad():
        outs = ref.wkv6_chunked(*leaves, ctx.chunk)
    pairs = [(o, g) for o, g in zip(outs, (grad_o, grad_state)) if g is not None]
    grads = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                     allow_unused=True) if pairs and wanted else ())
    return (*(next(grads, None) if t is not None and t.requires_grad else None
              for t in leaves), None, None)


_wkv6_op.register_autograd(_wkv6_backward, setup_context=_wkv6_setup)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor.  None is before something imported
    ``torch.distributed.tensor`` (the market paths never do), so the
    wrappers do not import it themselves."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _sharded_wkv6(r, k, v, w, u, state, chunk, plain):
    """:func:`wkv6` on DTensors, on each rank's batch rows and heads
    (``sharding.specs.local_apply``): the recurrence is independent per
    (row, head), so the kernel runs on the local shards and the outputs keep
    their layout.  ``r``'s placements pick the layout (a shard of T or K is
    made whole first: the recurrence needs both); ``u`` and the state follow.
    """
    from ..sharding.specs import local_apply

    bh = {0: "batch", 2: "heads"}
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    return local_apply(
        lambda *a: wkv6(*a, chunk=chunk, plain=plain), [r, k, v, w, u, state],
        [bh, bh, bh, bh, {0: "heads"}, {0: "batch", 1: "heads"}],
        [bh, {0: "batch", 1: "heads"}], [(b, t, h, vd), (b, h, kd, vd)])


# ---------------------------------------------------------------------------
# ordered_scatter_add: the partition plan.  A count / place block of the
# kernel owns one chunk of rows, each of its warps one contiguous sub-chunk,
# and keeps one counter a target a warp in shared memory; one block scans
# the n · chunks (target, chunk) counts (csrc/ordered_scatter.cu).
# ---------------------------------------------------------------------------

SCATTER_MAX_WARPS = 8  # warps of a count / place block
SCATTER_COUNTERS = 12_288  # target counters of a block, all its warps': 48 KB
SCATTER_STEP = 256  # rows of a warp whose indices load at once (8 steps of 32)
SCATTER_CHUNKS = 8 * 132  # chunks wanted: 8 blocks of 8 warps on each of 132 SMs
SCATTER_STARTS = 16 * 1_024  # (target, chunk) counts, at most: two rounds of the scan


class ScatterPlan(NamedTuple):
    """The partition of ``E`` rows: ``chunks`` blocks of ``warps`` warps,
    each warp ``sub`` rows in a row (the last chunk ragged)."""

    warps: int
    sub: int
    chunks: int


def scatter_plan(e: int, n: int) -> ScatterPlan:
    """The plan for ``e`` rows into ``n`` targets: enough chunks to fill the
    card, few enough that the scan takes two rounds, whole steps a warp."""
    if not 1 <= n <= SCATTER_COUNTERS:
        raise ValueError(f"ordered_scatter_add: 1 to {SCATTER_COUNTERS} targets, got {n}")
    warps = min(SCATTER_MAX_WARPS, SCATTER_COUNTERS // n)
    sub = max(-(-e // (warps * SCATTER_CHUNKS)), -(-e * n // (warps * SCATTER_STARTS)), 1)
    sub = -(-sub // SCATTER_STEP) * SCATTER_STEP
    return ScatterPlan(warps, sub, -(-e // (warps * sub)))


def scatter_args(out: torch.Tensor, index: torch.Tensor, source: torch.Tensor):
    """``(args, buffers)``: the C arguments of ``ordered_scatter_add`` (and
    of its halves, ``ordered_scatter_partition`` / ``_fold``) on the card,
    and the tensors they point into, to be kept alive until the launch; or
    None when no row can land (no rows or no targets)."""
    if out.device.type != "cuda":
        raise ValueError(f"ordered_scatter_add runs on CPU or CUDA tensors, got {out.device}")
    if out.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"ordered_scatter_add: out in float32 or float64, got {out.dtype}")
    if index.dtype.is_floating_point or index.dtype.is_complex or index.dtype == torch.bool:
        raise TypeError(f"ordered_scatter_add: an integer index, got {index.dtype}")
    n, e = out.shape[0], index.shape[0]
    width = math.prod(out.shape[1:])
    dev = out.device
    _check("out", out, out.dtype, tuple(out.shape), dev)
    _check("index", index, index.dtype, (e,), dev)
    if source.shape[0] != e or source.numel() != e * width or source.device != dev:
        raise ValueError(f"ordered_scatter_add: source {tuple(source.shape)} for {e} rows of "
                         f"{width} on {dev}, got {source.device}")
    if not 1 <= width <= 8:
        raise ValueError(f"ordered_scatter_add: 1 to 8 columns a target row, got {width}")
    if e >= 2**31:
        raise ValueError(f"ordered_scatter_add: fewer than 2**31 rows, got {e}")
    if e == 0 or n == 0:
        return None
    if index.dtype not in (torch.int32, torch.int64):
        index = index.long()
    if source.dtype not in (torch.float32, torch.float64):
        source = source.to(out.dtype)
    source = source.contiguous()
    plan = scatter_plan(e, n)
    # the fold copies 16-byte windows: room for one past the last row
    part = torch.empty(e * width + 16 // out.element_size(), dtype=out.dtype, device=dev)
    # counts, warp prefixes, offsets, kept rows a warp, the compacted rows and targets
    warps = plan.chunks * plan.warps
    scratch = torch.empty(n * plan.chunks + warps * n + n + 1 + warps + 2 * warps * plan.sub,
                          dtype=torch.int32, device=dev)
    args = (index.data_ptr(), int(index.dtype == torch.int64), source.data_ptr(),
            int(source.dtype == torch.float64), e, n, width, int(out.dtype == torch.float64),
            out.data_ptr(), part.data_ptr(), scratch.data_ptr(), *plan, _stream(dev))
    return args, (index, source, part, scratch)


def ordered_scatter_add(
    out: torch.Tensor, index: torch.Tensor, source: torch.Tensor, *, plain: bool = False
) -> torch.Tensor:
    """``out[index[e]] += source[e]`` row by row in operand order, in place
    (np.add.at's order); rows whose index lies outside ``0 .. len(out) - 1``
    are dropped.  float32 or float64 ``out`` of at most 8 columns a row; on
    the card at most :data:`SCATTER_COUNTERS` target rows.  Bit-identical to
    :func:`.ref.ordered_scatter_add`.

    On the card the kernel partitions the rows stably by target (counts,
    scan, placement: the index read in place, each kept row converted to
    ``out``'s type) and folds each target's rows in order from ``out``'s
    value.  Nothing here synchronises, so a call records into a CUDA graph.
    """
    if out.device.type == "cpu" or plain:
        return ref.ordered_scatter_add(out, index, source)
    call = scatter_args(out, index, source)
    if call is not None:
        _launch("ordered_scatter", "ordered_scatter_add", *call[0])
    return out


# ---------------------------------------------------------------------------
# ordered_rows_add: operand-order scatter-adds of wide rows, and the
# autograd functions built on it (the embedding lookup's backward, the MoE
# dispatch and combine)
# ---------------------------------------------------------------------------

# The wrapper picks one of three routes from the shapes (rows_plan), as
# csrc/ordered_rows.cu describes them; the constants below are the
# kernel's (k-names there) or the plan's own.  Change them with the replay
# in tests/test_torch_ordered_rows.py.
ROWS_FOLD_THREADS = 256  # kFoldThreads: a fold or scan CTA's threads, at most
ROWS_FOLD_CTAS = 6  # kFoldCtas: fold CTAs an SM holds at once (its launch bounds)
ROWS_SCAN_ITEMS = 4  # kScanItems: index rows a scan thread reads a round
ROWS_AHEAD = 4  # kAhead: rows of a chain in flight a thread (kAhead + 1 ring slots)
ROWS_SMEM_MAX = 16_384  # kMaxRows: the rows the one-CTA partition takes
ROWS_DIGIT_BITS = 9  # kDigitBits: key bits a partition pass, at most
ROWS_PART_WARPS = 32  # kPartWarps: the partition CTA's warps
# the scan route: each of its n · tiles CTAs reads the whole index, so it
# is taken only while that is little (a decode step's combine: 16 CTAs of
# 8 KB), for few rows (a CTA scans them in rounds) and few CTAs
ROWS_SCAN_MAX_ROWS = 4_096
ROWS_SCAN_MAX_CTAS = 1_024
ROWS_SCAN_BYTES = 2 * 2**20
H100_SMS = 132
_ROWS_DTYPES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


class RowsPlan(NamedTuple):
    """How ``ordered_rows_add`` runs a call: ``route`` "scan" (one launch,
    a CTA a (target, column tile), no partition), "smem" (the one-CTA
    partition, then the fold) or "sort" (``torch.sort``, then the fold);
    ``vec`` columns a thread; a CTA's ``threads``; ``tiles`` column tiles a
    row; ``grid`` the scan's or the fold's CTAs; the smem partition's
    ``passes`` of ``bits`` key bits and its dynamic shared memory
    ``smem_bytes``."""

    route: str
    vec: int
    threads: int
    tiles: int
    grid: int
    passes: int
    bits: int
    smem_bytes: int


def rows_plan(e: int, n: int, width: int, dtype: torch.dtype, index_dtype: torch.dtype,
              aligned: int, sms: int = H100_SMS) -> RowsPlan:
    """The plan of ``e`` rows of ``width`` ``dtype`` into ``n`` targets,
    with an int32 or int64 index, ``out`` and ``source`` both aligned to
    ``aligned`` bytes (a power of two), on a card of ``sms`` SMs: from the
    shapes alone.  A thread takes the widest vector of at most 16 bytes that
    divides the width and the alignment; a CTA at most ROWS_FOLD_THREADS
    threads, as few tiles a row as that allows and the threads spread evenly
    over them, in whole warps."""
    size = dtype.itemsize
    vec = 16 // size
    while vec > 1 and (width % vec or aligned % (vec * size)):
        vec //= 2
    vectors = width // vec
    tiles = -(-vectors // ROWS_FOLD_THREADS)
    threads = -(-vectors // tiles)
    threads = -(-threads // 32) * 32
    if (e <= ROWS_SCAN_MAX_ROWS and n * tiles <= ROWS_SCAN_MAX_CTAS
            and n * tiles * e * index_dtype.itemsize <= ROWS_SCAN_BYTES):
        return RowsPlan("scan", vec, threads, tiles, n * tiles, 0, 0, 0)
    grid = min(min(n, e) * tiles, sms * ROWS_FOLD_CTAS)
    if e > ROWS_SMEM_MAX:
        return RowsPlan("sort", vec, threads, tiles, grid, 0, 0, 0)
    key_bits = (n - 1).bit_length()
    passes = max(1, -(-key_bits // ROWS_DIGIT_BITS))
    bits = -(-key_bits // passes)
    smem = 4 * e + 4 * ROWS_PART_WARPS * ((1 << bits) + 1) + 4 * (e + e % 2)
    return RowsPlan("smem", vec, threads, tiles, grid, passes, bits, smem)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def rows_args(out: torch.Tensor, index: torch.Tensor, source: torch.Tensor):
    """``(plan, args, buffers)``: the plan of an ``ordered_rows_add`` call on
    the card, the C arguments of the kernel entry points (``args[-1]`` the
    stream current now), and the tensors they point into, to be kept alive
    until the launch; or None when no row can land (no rows, targets or
    columns)."""
    if out.device.type != "cuda" or index.device != out.device or source.device != out.device:
        raise ValueError(f"ordered_rows_add runs on CPU or CUDA tensors, got out on "
                         f"{out.device}, index on {index.device}, source on {source.device}")
    if not out.is_contiguous():
        raise ValueError("ordered_rows_add: out not contiguous")
    n, e = out.shape[0], index.shape[0]
    if e >= 2**31 or n >= 2**31 - 1:
        raise ValueError(f"ordered_rows_add: fewer than 2**31 rows and targets, got {e} and {n}")
    width = math.prod(out.shape[1:])
    if n == 0 or e == 0 or width == 0:
        return None
    if index.dtype not in (torch.int32, torch.int64):
        index = index.long()
    index = index.contiguous()
    source = source.contiguous()
    aligned = math.gcd(out.data_ptr(), source.data_ptr(), 16)
    plan = rows_plan(e, n, width, out.dtype, index.dtype, aligned,
                     _sms(out.device.index if out.device.index is not None
                          else torch.cuda.current_device()))
    scratch = None
    if plan.route != "scan":  # perm, run starts, run targets, the run count
        scratch = torch.empty(e + 2 * (min(n, e) + 1) + 1, dtype=torch.int32, device=out.device)
    args = (index.data_ptr(), int(index.dtype == torch.int64), source.data_ptr(),
            out.data_ptr(), _ROWS_DTYPES[out.dtype], e, n, width, plan.vec,
            ("scan", "smem", "sort").index(plan.route), plan.threads, plan.tiles, plan.grid,
            plan.passes, plan.bits, None if scratch is None else scratch.data_ptr(),
            _stream(out.device))
    return plan, args, (index, source, scratch)


def rows_sort_partition(index: torch.Tensor, n: int, scratch: torch.Tensor) -> None:
    """The sort route's partition, into ``scratch`` as the kernel's own
    writes it: the kept rows stably sorted by target (``torch.sort``), the
    starts and targets of the runs of equal targets, the run count.  Rows
    out of range are keyed ``n`` and sort last; the first of them starts one
    more run, so that run starts[count] is the kept rows' count.  Nothing
    synchronises."""
    e = index.shape[0]
    cap = min(n, e)
    key = torch.where((index >= 0) & (index < n), index, n).to(torch.int32)
    keys, perm = torch.sort(key, stable=True)
    head = torch.ones(e, dtype=torch.bool, device=index.device)
    head[1:] = keys[1:] != keys[:-1]
    starts = torch.searchsorted(torch.cumsum(head, 0, dtype=torch.int32),
                                torch.arange(1, cap + 2, dtype=torch.int32, device=index.device),
                                out_int32=True)
    scratch[:e] = perm
    scratch[e:e + cap + 1] = starts
    scratch[e + cap + 1:e + 2 * cap + 2] = keys[starts.clamp(max=e - 1)]
    scratch[-1:] = (head & (keys < n)).sum(dtype=torch.int32)


def ordered_rows_add(
    out: torch.Tensor, index: torch.Tensor, source: torch.Tensor, *, plain: bool = False
) -> torch.Tensor:
    """``out[index[e]] += source[e]`` row by row in operand order, in place,
    rows of any width (``out`` (n, ...), ``source`` (E, ...) of the same
    trailing shape and dtype: float32, float64 or bfloat16, each bfloat16
    add rounded); rows whose index lies outside ``0 .. n - 1`` are dropped.
    Bit-identical to :func:`.ref.ordered_rows_add`.

    On the card ``csrc/ordered_rows.cu`` reads the index in place by the
    route :func:`rows_plan` picks from the shapes: "scan" (one launch that
    scans the index once a (target, column tile)), "smem" (a one-CTA stable
    partition in shared memory, then the fold) or "sort" (past
    ROWS_SMEM_MAX rows: :func:`rows_sort_partition`, then the fold).
    Nothing synchronises, so a call records into a CUDA graph.  The call is
    the custom op ``repro_torch::ordered_rows_add``, which mutates ``out``;
    its fake version does nothing, so a step runs on fake tensors (the dry
    run).
    """
    if out.dtype not in _ROWS_DTYPES or source.dtype != out.dtype:
        raise TypeError(f"ordered_rows_add: out and source of one dtype in float32, float64 or "
                        f"bfloat16, got {out.dtype} and {source.dtype}")
    if index.dtype.is_floating_point or index.dtype.is_complex or index.dtype == torch.bool:
        raise TypeError(f"ordered_rows_add: an integer index, got {index.dtype}")
    e = index.shape[0]
    if index.ndim != 1 or tuple(source.shape) != (e,) + tuple(out.shape[1:]):
        raise ValueError(f"ordered_rows_add: index (E,) and source (E, ...) rows of out's "
                         f"{tuple(out.shape[1:])}, got {tuple(index.shape)} and "
                         f"{tuple(source.shape)}")
    _ordered_rows_add_op(out, index, source, plain)
    return out


@torch.library.custom_op("repro_torch::ordered_rows_add", mutates_args=("out",))
def _ordered_rows_add_op(out: torch.Tensor, index: torch.Tensor, source: torch.Tensor,
                         plain: bool) -> None:
    if out.device.type == "cpu" or plain:
        ref.ordered_rows_add(out, index, source)
        return
    call = rows_args(out, index, source)
    if call is None:
        return
    plan, args, (index, _, scratch) = call
    if plan.route == "sort":
        rows_sort_partition(index, out.shape[0], scratch)
    _launch("ordered_rows", "ordered_rows_add", *args)


@_ordered_rows_add_op.register_fake
def _ordered_rows_add_fake(out, index, source, plain):
    return None


class _OrderedGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, index):
        n = table.shape[0]
        keep = (index >= 0) & (index < n)
        rows = table[torch.where(keep, index, 0)]
        ctx.save_for_backward(index)
        ctx.n = n
        return torch.where(keep.reshape(keep.shape + (1,) * (table.ndim - 1)), rows, 0)

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        rows = grad.reshape((index.numel(),) + tuple(grad.shape[index.ndim:]))
        out = torch.zeros((ctx.n,) + tuple(rows.shape[1:]), dtype=grad.dtype, device=grad.device)
        return ordered_rows_add(out, index.reshape(-1), rows.contiguous()), None


class _OrderedScatterRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, n, index, source):
        ctx.save_for_backward(index)
        ctx.n = n
        out = torch.zeros((n,) + tuple(source.shape[1:]), dtype=source.dtype,
                          device=source.device)
        return ordered_rows_add(out, index, source.contiguous())

    @staticmethod
    def backward(ctx, grad):
        (index,) = ctx.saved_tensors
        keep = (index >= 0) & (index < ctx.n)
        rows = grad[torch.where(keep, index, 0)]
        return None, None, torch.where(keep.reshape((-1,) + (1,) * (grad.ndim - 1)), rows, 0)


def ordered_gather(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]`` (shape ``index.shape + table.shape[1:]``); an index
    outside ``0 .. len(table) - 1`` gathers zeros.  Its gradient adds the
    incoming rows into zeros with :func:`ordered_rows_add`, in operand order
    (rows out of range dropped), where CUDA's backward of ``table[index]``
    adds with atomics in any order.  A DTensor ``table`` or ``index`` runs
    :func:`_sharded_gather` on the local shards."""
    if is_dtensor(table) or is_dtensor(index):
        return _sharded_gather(table, index)
    return _OrderedGather.apply(table, index)


def _sharded_gather(table, index):
    """:func:`ordered_gather` on each rank's shards, with no gather of the
    table.  Mesh dim by mesh dim: where the table's rows are sharded (a
    vocab-parallel lookup) each rank gathers the indices in its own row
    range, zeros for the rest, and the result is ``Partial``, summed where
    a later op needs it; where its columns are sharded the result is
    sharded on the last dim; where the table is replicated the result
    takes the index's placement (and the table's gradient is ``Partial``
    there).  The index is replicated on the mesh dims that shard the
    table.  The backward adds the gradient rows into the
    local shard with :func:`ordered_rows_add`, in operand order, over this
    rank's indices: deterministic for a given world."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..sharding.specs import as_dtensor, from_local, shard_offsets

    mesh = (table if is_dtensor(table) else index).device_mesh
    table = as_dtensor(table, mesh)
    tp = [Replicate() if p.is_partial() else p for p in table.placements]
    table = table.redistribute(mesh, tp)
    index = as_dtensor(index, mesh)
    ip, out_pl = [], []
    for t_p, i_p in zip(tp, index.placements):
        if isinstance(t_p, Shard):  # the index is whole on this mesh dim
            ip.append(Replicate())
            out_pl.append(Partial() if t_p.dim == 0 else Shard(index.ndim + t_p.dim - 1))
        else:
            ip.append(Replicate() if i_p.is_partial() else i_p)
            out_pl.append(ip[-1])
    index = index.redistribute(mesh, ip)
    _, offset = shard_offsets(table.shape, mesh, tp)
    local_index = index.to_local()
    if offset[0]:
        local_index = local_index - offset[0]
    # a rank that gathers only its own indices holds part of the gradient
    grad_pl = [Partial() if isinstance(i_p, Shard) and not isinstance(t_p, Shard) else t_p
               for t_p, i_p in zip(tp, ip)]
    rows = _OrderedGather.apply(table.to_local(grad_placements=grad_pl), local_index)
    return from_local(rows, mesh, out_pl, tuple(index.shape) + tuple(table.shape[1:]))


def ordered_scatter_rows(n: int, index: torch.Tensor, source: torch.Tensor) -> torch.Tensor:
    """``n`` rows of zeros, ``source[e]`` added into row ``index[e]`` in
    operand order (:func:`ordered_rows_add`; rows out of range dropped).
    Its gradient gathers the incoming rows (zeros for the dropped ones)."""
    return _OrderedScatterRows.apply(n, index, source)


class CountedGraph:
    """A CUDA graph of ``fn()``, whose kernel launches count on every replay.

    ``fn`` runs once on a side stream first when ``warmup`` (its launches
    count: they run), then is captured on a side stream; the capture
    launches nothing, so the launch counts are put back as they were and
    the graph's own tally is added on each :meth:`replay`.  ``out`` holds
    what ``fn`` returned during the capture: tensors every replay rewrites
    in place.  The capture calls ``capture_begin``/``capture_end`` itself,
    because the ``torch.cuda.graph`` context also runs the garbage collector
    and empties the allocator's cache, which cost up to 0.75 s a capture on
    an NVIDIA H100 80GB HBM3 at 700 W.  A capture or a replay that fails
    raises.
    """

    def __init__(self, fn, warmup: bool = True):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        if warmup:
            with torch.cuda.stream(side):
                fn()
        before = dict(_LAUNCHES)
        t0 = time.perf_counter()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            self.graph.capture_begin()
            try:
                self.out = fn()
            finally:
                self.graph.capture_end()
        torch.cuda.current_stream().wait_stream(side)
        _CAPTURES["graphs"] += 1
        _CAPTURES["seconds"] += time.perf_counter() - t0
        self.tally = {k: _LAUNCHES[k] - before[k] for k in _LAUNCHES}
        _LAUNCHES.update(before)

    def replay(self):
        self.graph.replay()
        for k, n in self.tally.items():
            _LAUNCHES[k] += n
        return self.out


def launch_counts() -> dict[str, int]:
    """Launches of each kernel entry point since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    """Set every launch count, and the capture tally, to 0."""
    for fn in _LAUNCHES:
        _LAUNCHES[fn] = 0
    _CAPTURES.update(graphs=0, seconds=0.0)


def capture_stats() -> dict:
    """CUDA graphs captured since the last reset, and the host seconds the
    captures took (warm-up calls excluded)."""
    return dict(_CAPTURES)


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
    :func:`repro_torch.core.auction.sparse_proxy_demand_blocked`, bit for bit.
    Its ``partials_fn`` is the kernel's partials alone, at a given block
    count: a rank of the sharded clock calls it on its own blocks."""

    def partials(idx, val, mask, pi, prices, num_resources, blocks):
        parts, chosen = sparse_bid_eval(
            idx, val, mask, pi, prices, num_resources, blocks, plain=plain
        )
        return parts, chosen, chosen >= 0

    def demand(idx, val, mask, pi, prices, num_resources):
        parts, chosen, active = partials(idx, val, mask, pi, prices, num_resources, num_blocks)
        return ref.chain_sum(parts), chosen, active

    demand.sparse_signature = True  # type: ignore[attr-defined]
    demand.exact_settlement = True  # type: ignore[attr-defined]
    demand.partials_fn = partials  # type: ignore[attr-defined]
    demand.num_blocks = num_blocks  # type: ignore[attr-defined]
    return demand


def settlement_demand_fn(exact: bool = True, num_blocks: int = 8, plain: bool = False):
    """Demand fn for clock settlement (the reference's ``settlement_demand_fn``).

    ``exact=True``: the partials-mode kernel and the fixed left fold over
    ``num_blocks`` blocks (:func:`blocked_bid_demand_fn`), bit-identical to
    the reference's blocked proxy — what ``Economy.run_epoch`` settles with.
    ``exact=False``: the z-mode kernel (:func:`sparse_bid_demand_fn`), the
    fast planet-scale path, float-close only.
    """
    if exact:
        return blocked_bid_demand_fn(num_blocks, plain=plain)
    return sparse_bid_demand_fn(plain=plain)


def fused_epoch_z_fn(backend: str | None, num_resources: int, plain: bool = False):
    """In-loop excess demand for the fused epoch (the reference's
    ``fused_epoch_z_fn``).

    ``None`` returns None: the fused program keeps its exact blocked fold,
    which its bit parity rests on.  ``"z"`` returns ``z_fn(idx, val, mask,
    pi, prices) -> z`` through the z-mode kernel for the price loop only:
    selection, settlement and the convergence check stay exact, but the
    price trajectory is only float-close.  The reference's TPU backends
    (``"pallas"``, ``"interpret"``) have no meaning here.
    """
    if backend is None:
        return None
    if backend != "z":
        raise ValueError(f"fused_backend {backend!r}: the port's only kernel backend for the "
                         "fused epoch's in-loop z is 'z' (None keeps the exact blocked fold)")

    def z_fn(idx, val, mask, pi, prices):
        return sparse_bid_eval(idx, val, mask, pi, prices, num_resources, plain=plain)[0]

    return z_fn
