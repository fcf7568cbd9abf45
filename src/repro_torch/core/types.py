"""Core datatypes of the port: resource pools and the three bid books.

Counterpart of ``repro.core.types`` (the service's ``MarketBook`` is not
ported yet).  A *pool* is a (cluster, resource type) pair; a *user* submits
an XOR set of bundles over the R pools (positive = buy, negative = sell)
with willingness-to-pay π.

* ``AuctionProblem``: dense ``bundles (U, B, R) float32``, the paper's §III
  encoding (``pack_bids``);
* ``SparseAuctionProblem``: per-bundle (idx, val) nonzeros padded to K —
  ``idx (U, B, K) int32`` / ``val (U, B, K) float32``, padded slots
  ``(0, 0.0)``, nonzeros in ascending pool order;
* ``CSRAuctionProblem``: the same nonzeros flat (``idx/val (nnz,)``) with
  per-bundle ``offsets``, no K padding.

Packers are numpy and produce byte-identical arrays to the reference's; the
arrays become tensors only at the device boundary, on the ``device`` the
caller names (``"cuda"`` unless asked otherwise).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


def as_device(device: str | torch.device) -> torch.device:
    """``device`` as a torch.device; CUDA without a visible GPU raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is visible; pass device='cpu' to run on the CPU"
        )
    return dev


def _tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.require(a, requirements=("C", "W"))).to(device)


@dataclasses.dataclass(frozen=True)
class ResourcePool:
    """One sellable pool: a (cluster, resource-type) pair."""

    cluster: str
    rtype: str
    base_cost: float  # c(r): $ per unit per epoch
    utilization: float  # ψ(r) in [0, 1], pre-auction
    supply: float = 0.0  # operator-sellable units this epoch
    reliability: float = 1.0  # delivered-vs-promised capacity EMA

    @property
    def name(self) -> str:
        return f"{self.cluster}/{self.rtype}"


def _premium(won: torch.Tensor, payments: torch.Tensor, pi: torch.Tensor) -> torch.Tensor:
    """Paper eq. (5): γ_u = |π_u − x_uᵀp| / |x_uᵀp| for winners, NaN otherwise."""
    absp = payments.abs()
    gamma = (pi - payments).abs() / torch.where(absp > 0, absp, 1.0)
    return torch.where(won & (absp > 0), gamma, float("nan"))


@dataclasses.dataclass(frozen=True)
class AuctionProblem:
    """Dense bid book (tensors on one device).

    bundles (U, B, R) float32, row (u, b) the b-th XOR alternative of user u
    (padded rows 0); bundle_mask (U, B) bool; pi (U,) scalar or (U, B)
    vector willingness-to-pay; base_cost and supply_scale (R,) float32.
    """

    bundles: torch.Tensor
    bundle_mask: torch.Tensor
    pi: torch.Tensor
    base_cost: torch.Tensor
    supply_scale: torch.Tensor

    @property
    def num_users(self) -> int:
        return self.bundles.shape[0]

    @property
    def num_bundles(self) -> int:
        return self.bundles.shape[1]

    @property
    def num_resources(self) -> int:
        return self.bundles.shape[2]


@dataclasses.dataclass(frozen=True)
class AuctionResult:
    """One clock auction settled on an AuctionProblem."""

    prices: torch.Tensor  # (R,) settled unit prices
    allocations: torch.Tensor  # (U, R) awarded bundle (0 if lost)
    chosen_bundle: torch.Tensor  # (U,) int32, −1 if lost
    won: torch.Tensor  # (U,) bool
    payments: torch.Tensor  # (U,) x_uᵀp* (negative = revenue to a seller)
    excess_demand: torch.Tensor  # (R,) z at the settled prices
    rounds: torch.Tensor  # () int32 clock rounds run
    converged: torch.Tensor  # () bool

    def premium(self, pi: torch.Tensor) -> torch.Tensor:
        """Paper eq. (5): γ_u = |π_u − x_uᵀp| / |x_uᵀp| for winners."""
        return _premium(self.won, self.payments, pi)


@dataclasses.dataclass(frozen=True)
class SparseAuctionProblem:
    """K-padded sparse bid book (tensors on one device).

    idx/val (U, B, K); bundle_mask (U, B) bool; pi (U,) scalar or (U, B)
    vector willingness-to-pay; base_cost and supply_scale (R,) float32.
    """

    idx: torch.Tensor
    val: torch.Tensor
    bundle_mask: torch.Tensor
    pi: torch.Tensor
    base_cost: torch.Tensor
    supply_scale: torch.Tensor
    num_resources: int

    @property
    def num_users(self) -> int:
        return self.idx.shape[0]

    @property
    def num_bundles(self) -> int:
        return self.idx.shape[1]

    @property
    def k_max(self) -> int:
        return self.idx.shape[2]


@dataclasses.dataclass(frozen=True)
class SparseAuctionResult:
    """One settled clock auction; the awarded bundle stays in (idx, val) form."""

    prices: torch.Tensor  # (R,) settled unit prices
    alloc_idx: torch.Tensor  # (U, K) pool indices of the awarded bundle
    alloc_val: torch.Tensor  # (U, K) awarded quantities (0 if lost)
    chosen_bundle: torch.Tensor  # (U,) int32, −1 if lost
    won: torch.Tensor  # (U,) bool
    payments: torch.Tensor  # (U,) x_uᵀp* (negative = revenue to a seller)
    excess_demand: torch.Tensor  # (R,) z at the settled prices
    rounds: torch.Tensor  # () int32 clock rounds run
    converged: torch.Tensor  # () bool

    def premium(self, pi: torch.Tensor) -> torch.Tensor:
        """Paper eq. (5): γ_u = |π_u − x_uᵀp| / |x_uᵀp| for winners."""
        return _premium(self.won, self.payments, pi)

    def allocations_dense(self, num_resources: int) -> torch.Tensor:
        """(U, R) dense allocation matrix (duplicate pool indices add up)."""
        u, k = self.alloc_idx.shape
        rows = torch.arange(u, device=self.alloc_idx.device).repeat_interleave(k)
        out = torch.zeros((u, num_resources), dtype=torch.float32, device=self.alloc_idx.device)
        return out.index_put_(
            (rows, self.alloc_idx.reshape(-1).long()), self.alloc_val.reshape(-1).float(),
            accumulate=True,
        )


@dataclasses.dataclass(frozen=True)
class CSRAuctionProblem:
    """Flat CSR bid book: bundle (u, b) owns ``offsets[u·B+b] : offsets[u·B+b+1]``
    of idx/val (nnz,); ``rows`` is each element's flat bundle id; ``k_bound``
    is the longest bundle (the K of its padded twin)."""

    idx: torch.Tensor
    val: torch.Tensor
    rows: torch.Tensor
    offsets: torch.Tensor
    bundle_mask: torch.Tensor
    pi: torch.Tensor
    base_cost: torch.Tensor
    supply_scale: torch.Tensor
    num_resources: int
    k_bound: int

    @property
    def num_users(self) -> int:
        return self.bundle_mask.shape[0]

    @property
    def num_bundles(self) -> int:
        return self.bundle_mask.shape[1]

    @property
    def nnz(self) -> int:
        return self.idx.shape[0]


def csr_padded_views(problem: CSRAuctionProblem) -> tuple[torch.Tensor, torch.Tensor]:
    """(U, B, k_bound) idx/val views of a CSR book — exactly the padded layout
    the same book packs to: live slots in ascending k, dead slots (0, 0.0)."""
    u, b = problem.bundle_mask.shape
    k = problem.k_bound
    dev = problem.idx.device
    if problem.nnz == 0:
        return (
            torch.zeros((u, b, k), dtype=torch.int32, device=dev),
            torch.zeros((u, b, k), dtype=torch.float32, device=dev),
        )
    offsets = problem.offsets.long()
    start = offsets[:-1].reshape(u, b)
    count = (offsets[1:] - offsets[:-1]).reshape(u, b)
    kk = torch.arange(k, device=dev)
    live = kk[None, None, :] < count[:, :, None]
    pos = (start[:, :, None] + kk[None, None, :]).clamp(0, problem.nnz - 1)
    idx = torch.where(live, problem.idx[pos], 0).to(torch.int32)
    val = torch.where(live, problem.val[pos], 0.0)
    return idx, val


def padded_from_csr(problem: CSRAuctionProblem) -> SparseAuctionProblem:
    """CSR → K-padded conversion (exact; tensors stay on their device)."""
    idx, val = csr_padded_views(problem)
    return SparseAuctionProblem(
        idx=idx, val=val, bundle_mask=problem.bundle_mask, pi=problem.pi,
        base_cost=problem.base_cost, supply_scale=problem.supply_scale,
        num_resources=problem.num_resources,
    )


def csr_from_padded(problem: SparseAuctionProblem) -> CSRAuctionProblem:
    """K-padded → CSR conversion (on the host, vectorized).

    A slot is live up to the bundle's last ``(idx, val) != (0, 0)`` entry;
    trailing padding is dropped, which is exact (it added 0.0).
    """
    dev = problem.idx.device
    idx = problem.idx.cpu().numpy()
    val = problem.val.cpu().numpy()
    u, b, k = idx.shape
    live = (idx != 0) | (val != 0)
    any_live = live.any(axis=-1)
    counts = np.where(any_live, k - np.argmax(live[..., ::-1], axis=-1), 0).reshape(-1)
    offsets = np.zeros(u * b + 1, np.int32)
    offsets[1:] = np.cumsum(counts)
    nnz = int(offsets[-1])
    flat_idx = np.zeros(nnz, np.int32)
    flat_val = np.zeros(nnz, np.float32)
    kk = np.arange(k)
    take = kk[None, :] < counts[:, None]
    wpos = (offsets[:-1][:, None] + kk[None, :])[take]
    flat_idx[wpos] = idx.reshape(u * b, k)[take]
    flat_val[wpos] = val.reshape(u * b, k)[take]
    rows = np.repeat(np.arange(u * b, dtype=np.int32), counts)
    return CSRAuctionProblem(
        idx=_tensor(flat_idx, dev), val=_tensor(flat_val, dev), rows=_tensor(rows, dev),
        offsets=_tensor(offsets, dev), bundle_mask=problem.bundle_mask, pi=problem.pi,
        base_cost=problem.base_cost, supply_scale=problem.supply_scale,
        num_resources=problem.num_resources, k_bound=max(k, 1),
    )


def csr_problem_from_arrays(
    idx: np.ndarray,
    val: np.ndarray,
    offsets: np.ndarray,
    bundle_mask: np.ndarray,
    pi: np.ndarray,
    base_cost: np.ndarray,
    supply_scale: np.ndarray | None = None,
    k_bound: int | None = None,
    device: str | torch.device = "cuda",
) -> CSRAuctionProblem:
    """Wrap flat CSR host arrays into a CSRAuctionProblem on ``device``.

    Checks the cheap invariants (index range, monotone offsets, shapes).  The
    default supply scale folds |val| per pool in stream order in float32 —
    the padded packer's fold minus its exact +0.0 terms.
    """
    dev = as_device(device)
    idx = np.asarray(idx, np.int32)
    val = np.asarray(val, np.float32)
    offsets = np.asarray(offsets, np.int32)
    bundle_mask = np.asarray(bundle_mask, bool)
    num_res = int(np.asarray(base_cost).shape[0])
    if idx.shape != val.shape or idx.ndim != 1:
        raise ValueError(f"idx {idx.shape} / val {val.shape} must be flat (nnz,)")
    u, b = bundle_mask.shape
    if offsets.shape != (u * b + 1,):
        raise ValueError(f"offsets {offsets.shape} != ({u * b + 1},)")
    counts = offsets[1:].astype(np.int64) - offsets[:-1].astype(np.int64)
    if offsets[0] != 0 or offsets[-1] != idx.shape[0] or (counts < 0).any():
        raise ValueError("offsets must grow monotonically from 0 to nnz")
    if idx.size and (idx.min() < 0 or idx.max() >= num_res):
        raise ValueError(
            f"bundle pool indices must be in [0, {num_res}), got [{idx.min()}, {idx.max()}]"
        )
    if k_bound is None:
        k_bound = int(counts.max()) if counts.size else 1
    elif counts.size and k_bound < counts.max():
        raise ValueError(f"k_bound={k_bound} < densest bundle nnz={counts.max()}")
    if supply_scale is None:
        acc = np.zeros((num_res,), np.float32)
        np.add.at(acc, idx, np.abs(val))
        supply_scale = np.maximum(acc, 1.0)
    rows = np.repeat(np.arange(u * b, dtype=np.int32), counts)
    return CSRAuctionProblem(
        idx=_tensor(idx, dev),
        val=_tensor(val, dev),
        rows=_tensor(rows, dev),
        offsets=_tensor(offsets, dev),
        bundle_mask=_tensor(bundle_mask, dev),
        pi=_tensor(np.asarray(pi, np.float32), dev),
        base_cost=_tensor(np.asarray(base_cost, np.float32), dev),
        supply_scale=_tensor(np.asarray(supply_scale, np.float32), dev),
        num_resources=num_res,
        k_bound=max(int(k_bound), 1),
    )


def sparse_supply_scale(idx: np.ndarray, val: np.ndarray, num_res: int) -> np.ndarray:
    """|q| volume per pool from (idx, val) pairs, folded in (u, b, k) order in
    float32 and floored at 1."""
    acc = np.zeros((num_res,), np.float32)
    np.add.at(acc, idx.reshape(-1), np.abs(val.astype(np.float32)).reshape(-1))
    return np.maximum(acc, 1.0)


def bundle_cluster_costs(req: np.ndarray, prices_flat: np.ndarray) -> np.ndarray:
    """(N, C) $ cost of each agent's bundle in each cluster:
    ``Σ_t req[n, t] · prices_flat[c·T + t]`` accumulated in t order (float64)."""
    req = np.asarray(req, np.float64)
    p = np.asarray(prices_flat, np.float64).reshape(-1, req.shape[1])  # (C, T)
    out = np.zeros((req.shape[0], p.shape[0]), np.float64)
    for t in range(req.shape[1]):
        out += req[:, t, None] * p[None, :, t]
    return out


def _bundle_pairs(q, num_res: int) -> tuple[np.ndarray, np.ndarray]:
    """One bundle as ascending (int32 idx, float32 val) pairs."""
    if isinstance(q, tuple):
        ii, vv = q
        ii = np.asarray(ii, np.int32)
        if ii.size and (ii.min() < 0 or ii.max() >= num_res):
            raise ValueError(
                f"bundle pool indices must be in [0, {num_res}), got [{ii.min()}, {ii.max()}]"
            )
        order = np.argsort(ii, kind="stable")
        return ii[order], np.asarray(vv, np.float32)[order]
    q = np.asarray(q)
    ii = np.flatnonzero(q).astype(np.int32)
    return ii, q[ii].astype(np.float32)


def pack_bids_sparse(
    bundle_lists: Sequence[Sequence],
    pis: Sequence[float] | np.ndarray,
    base_cost: np.ndarray,
    supply_scale: np.ndarray | None = None,
    k_max: int | None = None,
    device: str | torch.device = "cuda",
) -> SparseAuctionProblem:
    """Pack per-user XOR bundle lists into a SparseAuctionProblem.

    A bundle is a dense (R,) vector (its nonzeros are taken) or an
    ``(idx, val)`` pair of 1-D arrays (stored in ascending index order).
    """
    num_res = int(np.asarray(base_cost).shape[0])
    rows = [[_bundle_pairs(q, num_res) for q in bl] for bl in bundle_lists]
    nnz_max = max([1] + [len(ii) for row in rows for ii, _ in row])
    max_b = max([1] + [len(row) for row in rows])
    if k_max is None:
        k_max = nnz_max
    elif k_max < nnz_max:
        raise ValueError(f"k_max={k_max} < densest bundle nnz={nnz_max}")
    idx = np.zeros((len(rows), max_b, k_max), np.int32)
    val = np.zeros((len(rows), max_b, k_max), np.float32)
    mask = np.zeros((len(rows), max_b), bool)
    for u, row in enumerate(rows):
        for b, (ii, vv) in enumerate(row):
            idx[u, b, : len(ii)] = ii
            val[u, b, : len(ii)] = vv
            mask[u, b] = True
    return sparse_problem_from_arrays(
        idx, val, mask, np.asarray(pis, np.float32), base_cost, supply_scale, device=device
    )


def sparse_problem_from_arrays(
    idx: np.ndarray,
    val: np.ndarray,
    bundle_mask: np.ndarray,
    pi: np.ndarray,
    base_cost: np.ndarray,
    supply_scale: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> SparseAuctionProblem:
    """Wrap (U, B, K) host arrays in ``pack_bids_sparse``'s layout into a
    SparseAuctionProblem on ``device`` (checks index range and shapes)."""
    dev = as_device(device)
    idx = np.asarray(idx, np.int32)
    val = np.asarray(val, np.float32)
    bundle_mask = np.asarray(bundle_mask, bool)
    num_res = int(np.asarray(base_cost).shape[0])
    if idx.shape != val.shape or idx.ndim != 3:
        raise ValueError(f"idx {idx.shape} / val {val.shape} must be (U, B, K)")
    if bundle_mask.shape != idx.shape[:2]:
        raise ValueError(f"bundle_mask {bundle_mask.shape} != {idx.shape[:2]}")
    if idx.size and (idx.min() < 0 or idx.max() >= num_res):
        raise ValueError(
            f"bundle pool indices must be in [0, {num_res}), got [{idx.min()}, {idx.max()}]"
        )
    if supply_scale is None:
        supply_scale = sparse_supply_scale(idx, val, num_res)
    return SparseAuctionProblem(
        idx=_tensor(idx, dev),
        val=_tensor(val, dev),
        bundle_mask=_tensor(bundle_mask, dev),
        pi=_tensor(np.asarray(pi, np.float32), dev),
        base_cost=_tensor(np.asarray(base_cost, np.float32), dev),
        supply_scale=_tensor(np.asarray(supply_scale, np.float32), dev),
        num_resources=num_res,
    )


def pack_bids(
    bundle_lists: Sequence[Sequence[np.ndarray]],
    pis: Sequence[float],
    base_cost: np.ndarray,
    supply_scale: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> AuctionProblem:
    """Pack per-user XOR bundle lists (dense (R,) vectors) into an
    AuctionProblem on ``device``; the host arrays are the reference's, byte
    for byte."""
    dev = as_device(device)
    num_users = len(bundle_lists)
    num_res = int(np.asarray(base_cost).shape[0])
    max_b = max((len(bl) for bl in bundle_lists), default=1) or 1
    bundles = np.zeros((num_users, max_b, num_res), dtype=np.float32)
    mask = np.zeros((num_users, max_b), dtype=bool)
    for u, bl in enumerate(bundle_lists):
        for b, q in enumerate(bl):
            bundles[u, b] = np.asarray(q, dtype=np.float32)
            mask[u, b] = True
    if supply_scale is None:
        # total offered + demanded volume per pool, floored at 1
        supply_scale = np.maximum(np.abs(bundles).sum(axis=(0, 1)), 1.0)
    return AuctionProblem(
        bundles=_tensor(bundles, dev),
        bundle_mask=_tensor(mask, dev),
        pi=_tensor(np.asarray(pis, dtype=np.float32), dev),
        base_cost=_tensor(np.asarray(base_cost, dtype=np.float32), dev),
        supply_scale=_tensor(np.asarray(supply_scale, dtype=np.float32), dev),
    )


def sparsify(problem: AuctionProblem, k_max: int | None = None) -> SparseAuctionProblem:
    """Dense → K-padded conversion on the host; nonzeros keep ascending pool
    order.  ``k_max`` below the densest bundle's nnz raises."""
    dev = problem.bundles.device
    bundles = problem.bundles.cpu().numpy()
    r = bundles.shape[-1]
    nz = bundles != 0
    counts = nz.sum(axis=-1)
    nnz_max = max(int(counts.max()) if counts.size else 0, 1)
    if k_max is None:
        k_max = nnz_max
    elif k_max < nnz_max:
        raise ValueError(f"k_max={k_max} < densest bundle nnz={nnz_max}")
    # a stable sort moves the nonzero positions to the front, ascending
    order = np.argsort(~nz, axis=-1, kind="stable")[..., :k_max]
    val = np.take_along_axis(bundles, order, axis=-1)
    live = np.arange(k_max)[None, None, :] < counts[..., None]
    return SparseAuctionProblem(
        idx=_tensor(np.where(live, order, 0).astype(np.int32), dev),
        val=_tensor(np.where(live, val, 0.0).astype(np.float32), dev),
        bundle_mask=problem.bundle_mask, pi=problem.pi, base_cost=problem.base_cost,
        supply_scale=problem.supply_scale, num_resources=r,
    )


def densify(problem: SparseAuctionProblem) -> AuctionProblem:
    """K-padded → dense conversion on the host (duplicate pool indices
    within a bundle add up)."""
    dev = problem.idx.device
    idx = problem.idx.cpu().numpy()
    val = problem.val.cpu().numpy()
    u, b, k = idx.shape
    bundles = np.zeros((u, b, problem.num_resources), np.float32)
    uu, bb = np.meshgrid(np.arange(u), np.arange(b), indexing="ij")
    np.add.at(
        bundles,
        (uu[..., None].repeat(k, -1).reshape(-1), bb[..., None].repeat(k, -1).reshape(-1),
         idx.reshape(-1)),
        val.reshape(-1),
    )
    return AuctionProblem(
        bundles=_tensor(bundles, dev), bundle_mask=problem.bundle_mask, pi=problem.pi,
        base_cost=problem.base_cost, supply_scale=problem.supply_scale,
    )


def operator_supply_bids(
    pools: Sequence[ResourcePool],
    reserve_prices: np.ndarray,
    lots: int = 1,
) -> tuple[list[list[np.ndarray]], list[float]]:
    """Operator supply as pure-seller users (paper §II): each pool's supply in
    ``lots`` equal sell bids, each asking at least the reserve per unit."""
    bundle_lists: list[list[np.ndarray]] = []
    pis: list[float] = []
    num_res = len(pools)
    for r, pool in enumerate(pools):
        if pool.supply <= 0:
            continue
        lot = pool.supply / lots
        for _ in range(lots):
            q = np.zeros((num_res,), dtype=np.float32)
            q[r] = -lot
            bundle_lists.append([q])
            pis.append(float(-lot * reserve_prices[r]))
    return bundle_lists, pis
