"""Core datatypes of the port: resource pools and the three bid books.

Counterpart of ``repro.core.types``.  A *pool* is a (cluster, resource type) pair; a *user* submits
an XOR set of bundles over the R pools (positive = buy, negative = sell)
with willingness-to-pay π.

* ``AuctionProblem``: dense ``bundles (U, B, R) float32``, the paper's §III
  encoding (``pack_bids``);
* ``SparseAuctionProblem``: per-bundle (idx, val) nonzeros padded to K —
  ``idx (U, B, K) int32`` / ``val (U, B, K) float32``, padded slots
  ``(0, 0.0)``, nonzeros in ascending pool order;
* ``CSRAuctionProblem``: the same nonzeros flat (``idx/val (nnz,)``) with
  per-bundle ``offsets``, no K padding;
* ``MarketBook``: the always-on service's persistent slotted book, host
  numpy master plus a device mirror synced in O(Δ) rows a tick.

Packers are numpy and produce byte-identical arrays to the reference's; the
arrays become tensors only at the device boundary, on the ``device`` the
caller names (``"cuda"`` unless asked otherwise).
"""
from __future__ import annotations

import dataclasses
import json
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


@dataclasses.dataclass(frozen=True)
class CSRDemandAux:
    """Pack-time layouts that make one CSR proxy round scatter-free (the
    reference's ``CSRDemandAux``, array for array).

    * bundle costs: bundles sorted by nnz, descending; pass ``k`` touches
      exactly the first ``m_k[k]`` sorted bundles, so the K-term cost fold
      is ``k_bound`` prefix-slice adds over the k-major element stream
      (``kmaj_idx``/``kmaj_val``), in k order;
    * excess demand z: elements sorted by pool, each pool's run padded to a
      multiple of ``chunk``; the selected values are gathered into that
      layout, summed a chunk at a time, and only the chunk sums are added
      into z.

    Both are data layout only: the costs, and so the selection, are the
    plain path's bit for bit; z reassociates within a pool (float-close).
    """

    kmaj_idx: torch.Tensor  # (nnz,) int32: k-major, count-sorted element stream
    kmaj_val: torch.Tensor  # (nnz,) float32
    inv_count_perm: torch.Tensor  # (U·B,) int32: sorted-bundle position of each bundle
    pool_pos: torch.Tensor  # (chunks·chunk,) int32: flat element position, pool-major
    pool_live: torch.Tensor  # (chunks·chunk,) bool: False on a pool run's padding
    chunk_pool: torch.Tensor  # (chunks,) int32: the pool of each chunk
    m_k: tuple  # bundles with nnz > k, for k in range(k_bound)
    chunk: int  # z chunk width


def csr_demand_aux(problem: CSRAuctionProblem, chunk: int = 128) -> CSRDemandAux:
    """The scatter-free demand layouts of a CSR book, built on the host in
    numpy (once a packed book, beside the packer) and put on the book's
    device."""
    dev = problem.idx.device
    idx = problem.idx.cpu().numpy()
    val = problem.val.cpu().numpy()
    offsets = problem.offsets.cpu().numpy().astype(np.int64)
    counts = offsets[1:] - offsets[:-1]  # (U·B,)
    ub = counts.shape[0]
    nnz = idx.shape[0]

    perm = np.argsort(-counts, kind="stable")  # bundles by nnz, descending
    inv_perm = np.empty_like(perm)
    inv_perm[perm] = np.arange(ub)
    sorted_counts = counts[perm]
    m_k = tuple(int((sorted_counts > k).sum()) for k in range(problem.k_bound))
    kmaj_idx = np.concatenate(
        [idx[offsets[:-1][perm[: m_k[k]]] + k] for k in range(problem.k_bound)]
        or [np.zeros(0, np.int32)]
    )
    kmaj_val = np.concatenate(
        [val[offsets[:-1][perm[: m_k[k]]] + k] for k in range(problem.k_bound)]
        or [np.zeros(0, np.float32)]
    )

    pool_order = np.argsort(idx, kind="stable")
    pool_counts = np.bincount(idx, minlength=problem.num_resources)
    pool_chunks = (pool_counts + chunk - 1) // chunk
    n_chunks = int(pool_chunks.sum())
    pool_pos = np.zeros(max(n_chunks, 1) * chunk, np.int32)
    pool_live = np.zeros(max(n_chunks, 1) * chunk, bool)
    chunk_pool = np.repeat(np.arange(problem.num_resources), pool_chunks).astype(np.int32)
    if nnz:
        sorted_pools = idx[pool_order]
        elem_off = np.zeros(problem.num_resources + 1, np.int64)
        elem_off[1:] = np.cumsum(pool_counts)
        write_off = np.zeros(problem.num_resources + 1, np.int64)
        write_off[1:] = np.cumsum(pool_chunks) * chunk
        rank = np.arange(nnz) - elem_off[sorted_pools]
        wpos = write_off[sorted_pools] + rank
        pool_pos[wpos] = pool_order.astype(np.int32)
        pool_live[wpos] = True
    return CSRDemandAux(
        kmaj_idx=_tensor(kmaj_idx.astype(np.int32), dev),
        kmaj_val=_tensor(kmaj_val.astype(np.float32), dev),
        inv_count_perm=_tensor(inv_perm.astype(np.int32), dev),
        pool_pos=_tensor(pool_pos, dev),
        pool_live=_tensor(pool_live, dev),
        chunk_pool=_tensor(chunk_pool, dev),
        m_k=m_k,
        chunk=chunk,
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


def pack_bids_csr(
    bundle_lists: Sequence[Sequence],
    pis: Sequence[float] | np.ndarray,
    base_cost: np.ndarray,
    supply_scale: np.ndarray | None = None,
    device: str | torch.device = "cuda",
) -> CSRAuctionProblem:
    """Pack per-user XOR bundle lists straight into a CSRAuctionProblem.

    The inputs of :func:`pack_bids_sparse` (dense ``(R,)`` vectors or
    ``(idx, val)`` pairs); the flat streams are assembled directly, O(nnz)
    host memory, never the ``(U, B, K_max)`` padded intermediate.  Each
    bundle is trimmed to its last live ``(idx, val) != (0, 0)`` entry (the
    rule of :func:`csr_from_padded`), while ``k_bound`` stays the densest
    bundle's untrimmed length, so :func:`csr_padded_views` gives back the
    padded pack of the same lists and the book settles bit-identically.
    """
    num_users = len(bundle_lists)
    num_res = int(np.asarray(base_cost).shape[0])
    parts_i: list[np.ndarray] = []
    parts_v: list[np.ndarray] = []
    entries: list[tuple[int, int, int]] = []  # (user, bundle, count)
    max_b = 1
    k_bound = 1
    for u, bl in enumerate(bundle_lists):
        max_b = max(max_b, len(bl))
        for b, q in enumerate(bl):
            if isinstance(q, tuple):
                ii, vv = q
                ii = np.asarray(ii, np.int32)
                if ii.size and (ii.min() < 0 or ii.max() >= num_res):
                    raise ValueError(
                        f"bundle pool indices must be in [0, {num_res}), got "
                        f"[{ii.min()}, {ii.max()}]"
                    )
                order = np.argsort(ii, kind="stable")
                ii = ii[order]
                vv = np.asarray(vv, np.float32)[order]
            else:
                q = np.asarray(q)
                ii = np.flatnonzero(q).astype(np.int32)
                vv = q[ii].astype(np.float32)
            k_bound = max(k_bound, len(ii))
            live = np.flatnonzero((ii != 0) | (vv != 0))
            n = int(live[-1]) + 1 if live.size else 0
            parts_i.append(ii[:n])
            parts_v.append(vv[:n])
            entries.append((u, b, n))
    counts = np.zeros((num_users, max_b), np.int64)
    mask = np.zeros((num_users, max_b), bool)
    for u, b, n in entries:
        counts[u, b] = n
        mask[u, b] = True
    offsets = np.zeros(num_users * max_b + 1, np.int32)
    offsets[1:] = np.cumsum(counts.reshape(-1))
    flat_idx = (np.concatenate(parts_i) if parts_i else np.zeros(0, np.int32)).astype(np.int32)
    flat_val = (np.concatenate(parts_v) if parts_v else np.zeros(0, np.float32)).astype(
        np.float32)
    return csr_problem_from_arrays(
        flat_idx, flat_val, offsets, mask, np.asarray(pis, np.float32), base_cost,
        supply_scale=supply_scale, k_bound=k_bound, device=device,
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


def pad_users(problem: SparseAuctionProblem, multiple: int) -> SparseAuctionProblem:
    """Zero-pad the user axis up to a multiple of ``multiple`` (on the
    problem's device).

    Padded rows carry ``bundle_mask=False``, so their proxies never activate
    and they add exact +0.0 everywhere: settlement of the first
    ``num_users`` rows is unchanged.  ``sharded_clock_auction`` evens out
    the user axis this way before splitting it over a process group.
    """
    pad = -problem.num_users % multiple
    if pad == 0:
        return problem

    def grow(t: torch.Tensor) -> torch.Tensor:
        return torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])

    return dataclasses.replace(
        problem, idx=grow(problem.idx), val=grow(problem.val),
        bundle_mask=grow(problem.bundle_mask), pi=grow(problem.pi),
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


# ---------------------------------------------------------------------------
# Incremental (always-on) bid book
# ---------------------------------------------------------------------------
def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A copy of host array ``a`` on ``device`` that never aliases it (on the
    CPU too): the book's mirror must not move when the host master does."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(device, copy=True)


def _json_key(key) -> bool:
    """Whether ``key`` can go into a durable record's JSON metadata."""
    if type(key) is str or type(key) is int:
        return True
    try:
        json.dumps(key)
    except TypeError:
        return False
    return True


class MarketBook:
    """Persistent slotted bid book with amortized-O(Δ) delta application.

    Counterpart of ``repro.core.types.MarketBook``, array for array.  The
    always-on twin of the per-epoch packers: instead of rebuilding the flat
    ``idx``/``val`` streams from scratch every auction, the book owns
    ``rows_cap`` fixed-width row slots (slot ``s`` holds one account's XOR
    bid in elements ``[s·B·K, (s+1)·B·K)``) and arrivals / departures / bid
    updates land as whole-row insert/delete/update writes.  Every bundle
    region is exactly ``K`` wide, zero-padded inside (explicit
    ``(idx=0, val=0)`` elements gather pool 0's price and contribute exact
    ``0.0``, the same bit-neutral padding contract every packer relies on),
    so the streams read as ``(rows_cap, B, K)`` are the K-padded book
    (:meth:`device_padded_problem`) that the reference's CSR view (offsets
    the static ``arange·K`` ladder) gathers back to.

    Host numpy arrays are the master copy (validation, oracle).  The device
    mirror is four tensors on the book's ``device`` (the card unless asked
    otherwise), allocated once a capacity; each sync writes only the rows
    written since the last one, in place (``index_copy_`` on the
    ``(rows_cap, B·K)`` view), so per-tick device work is O(Δ·B·K).

    Parity oracle: :meth:`rebuilt` re-packs every live account from its raw
    submission into the *same slot* of a fresh zeroed book — the full-repack
    twin of ``packer="loop"`` — and :meth:`parity_check` asserts the
    incremental arrays are bit-identical to it.  ``supply_scale`` is carried
    as an exact float64 per-pool |q| ledger (adds on insert, subtracts on
    delete); within the service's validated quantity range every ledger op is
    exact in float64, so the incremental ledger equals the oracle's
    from-scratch sum bit for bit.

    Each live account is kept once, as its durable encoding
    (:meth:`_encode_accounts`) in per-slot columns that every write
    maintains apart from the slot arrays: an export is a few gathers with
    no per-account work, and :meth:`rebuilt` re-packs each account from
    them (:meth:`_account`).
    """

    def __init__(
        self,
        base_cost: np.ndarray,
        num_bundles: int,
        k_bound: int,
        rows_cap: int = 64,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = as_device(device)
        if num_bundles < 1 or k_bound < 1:
            raise ValueError("num_bundles and k_bound must be >= 1")
        self.base_cost = np.asarray(base_cost, np.float32)
        self.num_resources = int(self.base_cost.shape[0])
        self.num_bundles = int(num_bundles)
        self.k_bound = int(k_bound)
        self.rows_cap = 1
        while self.rows_cap < max(int(rows_cap), 1):
            self.rows_cap *= 2
        self._alloc_arrays(self.rows_cap)
        self._key_slot: dict = {}
        self._slot_key: list = [None] * self.rows_cap
        self._next_slot = 0
        self._free: list[int] = []  # LIFO of freed slots below _next_slot
        self._ledger = np.zeros(self.num_resources, np.float64)
        # offered-supply twin of the |q| ledger: per-pool sum of |q| over the
        # *sell-side* elements only (q < 0) — real utilization telemetry for
        # the service (settled demand / offered supply) without an O(nnz) scan
        self._sell_ledger = np.zeros(self.num_resources, np.float64)
        self._generation = 0  # bumps on every growth (device full re-upload)
        self._dev: dict[str, torch.Tensor] | None = None
        self._dev_generation = -1
        self._dev_pending: list[int] = []  # slots written since last sync
        self.last_sync_rows = 0  # rows the last device sync wrote (telemetry)
        # slots written since the last checkpoint export — a separate set from
        # _dev_pending because the two clear at different times (device sync
        # per tick vs. durable commit)
        self._ckpt_dirty: set[int] = set()
        self.deltas_applied = 0  # lifetime upsert+remove count (telemetry)

    # -- storage ------------------------------------------------------------

    def _alloc_arrays(self, rows_cap: int) -> None:
        b, k = self.num_bundles, self.k_bound
        self.idx = np.zeros(rows_cap * b * k, np.int32)
        self.val = np.zeros(rows_cap * b * k, np.float32)
        self.mask = np.zeros((rows_cap, b), bool)
        self.pi = np.zeros((rows_cap, b), np.float32)
        # the encoding columns, one row a slot, read only where ``live``.
        # kind 0, a raw (bundles, pi) submission: ``mask`` its bundles (a
        # prefix), ``nnz`` each bundle's length, ``idx``/``val`` the bundles'
        # pairs flattened in submission order from the row's start, ``pi``
        # broadcast over the bundles.  kind 1, a pre-packed payload: ``idx``,
        # ``val``, ``mask``, ``pi`` as written.  Zero past what an account holds.
        self._cols = {
            "live": np.zeros(rows_cap, bool),
            "bad_key": np.zeros(rows_cap, bool),  # key not JSON-serializable
            "kind": np.zeros(rows_cap, np.int8),
            "idx": np.zeros((rows_cap, b * k), np.int32),
            "val": np.zeros((rows_cap, b * k), np.float32),
            "mask": np.zeros((rows_cap, b), bool),
            "nnz": np.zeros((rows_cap, b), np.int32),
            "pi": np.zeros((rows_cap, b), np.float32),
        }

    def _grow(self, new_cap: int) -> None:
        """Reallocate every per-slot array at ``new_cap`` rows, contents kept."""
        old = {name: getattr(self, name) for name in ("idx", "val", "mask", "pi")}
        old_cols = self._cols
        self._alloc_arrays(new_cap)
        for name, a in old.items():
            getattr(self, name)[: a.shape[0]] = a
        for name, a in old_cols.items():
            self._cols[name][: a.shape[0]] = a
        self._slot_key.extend([None] * (new_cap - self.rows_cap))
        self.rows_cap = new_cap

    def _ensure_rows(self, extra: int) -> None:
        need = self._next_slot - len(self._free) + extra
        if need <= self.rows_cap:
            return
        new_cap = self.rows_cap
        while new_cap < need:
            new_cap *= 2
        self._grow(new_cap)
        self._generation += 1  # stale device mirror: full re-upload
        self._dev = None
        self._dev_pending.clear()

    @property
    def num_rows(self) -> int:
        """Live account count."""
        return len(self._key_slot)

    @property
    def nnz_cap(self) -> int:
        return self.rows_cap * self.num_bundles * self.k_bound

    # -- row packing --------------------------------------------------------

    def _pack_row(self, bundles, pi):
        """One account's raw submission → (idx (B,K), val (B,K), mask (B,),
        pi (B,)) row payload.  Nonzeros are sorted ascending by pool (the
        fold-order contract every demand path shares) and zero-padded to K.
        """
        b_cap, k_cap = self.num_bundles, self.k_bound
        if len(bundles) == 0 or len(bundles) > b_cap:
            raise ValueError(f"bundle count must be in [1, {b_cap}], got {len(bundles)}")
        pi_arr = np.broadcast_to(np.asarray(pi, np.float32), (len(bundles),))
        idx_row = np.zeros((b_cap, k_cap), np.int32)
        val_row = np.zeros((b_cap, k_cap), np.float32)
        mask_row = np.zeros(b_cap, bool)
        pi_row = np.zeros(b_cap, np.float32)
        for b, q in enumerate(bundles):
            ii, vv = q
            ii = np.asarray(ii, np.int32)
            vv = np.asarray(vv, np.float32)
            if ii.shape != vv.shape or ii.ndim != 1:
                raise ValueError("each bundle must be a flat (idx, val) pair")
            if len(ii) > k_cap:
                raise ValueError(f"bundle nnz {len(ii)} > k_bound {k_cap}")
            if ii.size and (ii.min() < 0 or ii.max() >= self.num_resources):
                raise ValueError(
                    f"bundle pool indices must be in [0, {self.num_resources})"
                )
            if not np.isfinite(vv).all():
                raise ValueError("bundle quantities must be finite")
            order = np.argsort(ii, kind="stable")
            idx_row[b, : len(ii)] = ii[order]
            val_row[b, : len(ii)] = vv[order]
            mask_row[b] = True
            pi_row[b] = pi_arr[b]
        if not np.isfinite(pi_row).all():
            raise ValueError("pi must be finite")
        return idx_row, val_row, mask_row, pi_row

    # -- encoding columns ---------------------------------------------------

    def _raw_columns(self, accounts) -> dict:
        """The encoding columns of raw (bundles, pi) accounts, one row each:
        one pass over their bundles, then vectorized writes.  An account the
        columns cannot hold (over B bundles, a bundle that is not a flat
        (idx, val) pair of one length, or over K long) raises ValueError."""
        b_cap, k_cap = self.num_bundles, self.k_bound
        counts, pis, pairs = [], [], []
        for bundles, p in accounts:
            n = len(bundles)
            counts.append(n)
            p = np.asarray(p, np.float32)
            pis.append(p if p.shape == (n,) else np.broadcast_to(p, (n,)))
            pairs.extend(bundles)
        idx, val = zip(*pairs) if pairs else ((), ())
        nnz = np.fromiter(map(len, idx), np.int64, len(idx))
        if (np.array(counts, np.int64) > b_cap).any() or (nnz > k_cap).any():
            raise ValueError(f"an account holds at most {b_cap} bundles of {k_cap} pairs")
        if not np.array_equal(nnz, np.fromiter(map(len, val), np.int64, len(val))):
            raise ValueError("each bundle must be an (idx, val) pair of one length")

        def flat(chunks, dtype):
            out = np.concatenate([np.zeros(0, dtype), *chunks], dtype=dtype, casting="unsafe")
            if out.ndim != 1:
                raise ValueError("each bundle must be a flat (idx, val) pair")
            return out

        mask = np.arange(b_cap) < np.array(counts, np.int64)[:, None]
        nnz_rows = np.zeros(mask.shape, np.int32)
        nnz_rows[mask] = nnz
        return self._flat_columns(mask, nnz_rows, flat(idx, np.int32), flat(val, np.float32),
                                  flat(pis, np.float32))

    def _flat_columns(self, mask, nnz_rows, idx, val, pi) -> dict:
        """Raw accounts' columns from their flat encoding: each row's pairs
        and π laid from its start, in order."""
        d, bk = mask.shape[0], self.num_bundles * self.k_bound
        pairs = np.arange(bk) < nnz_rows.sum(axis=1)[:, None]
        cols = {"kind": 0, "mask": mask, "nnz": nnz_rows,
                "idx": np.zeros((d, bk), np.int32), "val": np.zeros((d, bk), np.float32),
                "pi": np.zeros(mask.shape, np.float32)}
        cols["idx"][pairs] = idx
        cols["val"][pairs] = val
        cols["pi"][mask] = pi
        return cols

    def _packed_columns(self, idx_rows, val_rows, mask_rows, pi_rows) -> dict:
        """Pre-packed payloads' columns, one row each."""
        d, bk = len(mask_rows), self.num_bundles * self.k_bound
        return {"kind": 1, "idx": np.asarray(idx_rows, np.int32).reshape(d, bk),
                "val": np.asarray(val_rows, np.float32).reshape(d, bk),
                "mask": np.asarray(mask_rows, bool), "nnz": 0,
                "pi": np.asarray(pi_rows, np.float32)}

    def _store_columns(self, slots, keys, cols: dict) -> None:
        """Write accounts' columns into their slots and mark them live."""
        self._cols["live"][slots] = True
        self._cols["bad_key"][slots] = [not _json_key(key) for key in keys]
        for name, v in cols.items():
            self._cols[name][slots] = v

    # -- delta application --------------------------------------------------

    def upsert(self, key, bundles, pi) -> None:
        """Insert or replace one account's bid.  Amortized O(B·K)."""
        row = self._pack_row(bundles, pi)
        self._write_rows([key], *(a[None] for a in row), raw=[(bundles, pi)])

    def upsert_rows(self, keys, idx_rows, val_rows, mask_rows, pi_rows, raw=None):
        """Vectorized multi-account upsert of pre-packed row payloads.

        ``raw`` optionally carries the original (bundles, pi) submissions so
        :meth:`rebuilt` can re-pack them; when omitted the payload itself is
        stored (already canonical)."""
        self._write_rows(keys, idx_rows, val_rows, mask_rows, pi_rows, raw)

    def _write_rows(self, keys, idx_rows, val_rows, mask_rows, pi_rows, raw=None) -> None:
        d = len(keys)
        if len(set(keys)) != d:
            # the ledger reads each slot's old contents once per batch, so a
            # key repeated within one batch would double-retire them
            raise ValueError("duplicate keys in one delta batch (dedupe first)")
        idx_rows = np.asarray(idx_rows, np.int32)
        val_rows = np.asarray(val_rows, np.float32)
        mask_rows = np.asarray(mask_rows, bool)
        pi_rows = np.asarray(pi_rows, np.float32)
        # built before any write, so an account the columns reject leaves
        # the book as it was
        cols = (self._packed_columns(idx_rows, val_rows, mask_rows, pi_rows)
                if raw is None else self._raw_columns(raw))
        new = [k for k in keys if k not in self._key_slot]
        self._ensure_rows(len(new))
        slots = np.empty(d, np.int64)
        for i, key in enumerate(keys):
            s = self._key_slot.get(key)
            if s is None:
                s = self._free.pop() if self._free else self._next_slot
                if s == self._next_slot:
                    self._next_slot += 1
                self._key_slot[key] = s
                self._slot_key[s] = key
            slots[i] = s
        b, k = self.num_bundles, self.k_bound
        el = (
            slots[:, None, None] * (b * k)
            + np.arange(b)[None, :, None] * k
            + np.arange(k)[None, None, :]
        ).reshape(d, -1)
        old_val = self.val[el]
        old_idx = self.idx[el]
        # exact f64 ledgers: retire the old elements' |q|, credit the new
        self._ledger -= np.bincount(
            old_idx.reshape(-1),
            weights=np.abs(old_val.reshape(-1), dtype=np.float64),
            minlength=self.num_resources,
        )
        self._ledger += np.bincount(
            idx_rows.reshape(-1).astype(np.int64),
            weights=np.abs(val_rows.reshape(-1), dtype=np.float64),
            minlength=self.num_resources,
        )
        self._sell_ledger -= np.bincount(
            old_idx.reshape(-1),
            weights=np.maximum(-old_val.reshape(-1).astype(np.float64), 0.0),
            minlength=self.num_resources,
        )
        self._sell_ledger += np.bincount(
            idx_rows.reshape(-1).astype(np.int64),
            weights=np.maximum(-val_rows.reshape(-1).astype(np.float64), 0.0),
            minlength=self.num_resources,
        )
        flat = el.reshape(-1)
        self.idx[flat] = idx_rows.reshape(-1)
        self.val[flat] = val_rows.reshape(-1)
        self.mask[slots] = mask_rows
        self.pi[slots] = pi_rows
        self._store_columns(slots, keys, cols)
        self._dev_pending.extend(int(s) for s in slots)
        self._ckpt_dirty.update(int(s) for s in slots)
        self.deltas_applied += d

    def remove(self, key) -> bool:
        """Withdraw one account's bid; frees its slot (LIFO reuse).  O(B·K)."""
        s = self._key_slot.pop(key, None)
        if s is None:
            return False
        b, k = self.num_bundles, self.k_bound
        lo, hi = s * b * k, (s + 1) * b * k
        self._ledger -= np.bincount(
            self.idx[lo:hi].astype(np.int64),
            weights=np.abs(self.val[lo:hi], dtype=np.float64),
            minlength=self.num_resources,
        )
        self._sell_ledger -= np.bincount(
            self.idx[lo:hi].astype(np.int64),
            weights=np.maximum(-self.val[lo:hi].astype(np.float64), 0.0),
            minlength=self.num_resources,
        )
        self.idx[lo:hi] = 0
        self.val[lo:hi] = 0.0
        self.mask[s] = False
        self.pi[s] = 0.0
        self._cols["live"][s] = False
        self._slot_key[s] = None
        self._free.append(s)
        self._dev_pending.append(s)
        self._ckpt_dirty.add(int(s))
        self.deltas_applied += 1
        return True

    def __contains__(self, key) -> bool:
        return key in self._key_slot

    def __len__(self) -> int:
        return self.num_rows

    # -- problem views ------------------------------------------------------

    def supply_scale(self) -> np.ndarray:
        return np.maximum(self._ledger.astype(np.float32), 1.0)

    def _sync_device(self) -> dict[str, torch.Tensor]:
        """The device mirror, brought up to date.

        On first use (and after every capacity doubling) the whole book is
        uploaded once; afterwards each call writes only the slots written
        since the last sync, sorted and unique, into the mirror in place.
        The reference pads each delta batch to a power-of-two bucket of
        duplicate slots to keep its compile cache small; the rows written
        are the same.
        """
        if self._dev is None or self._dev_generation != self._generation:
            self._dev = {
                name: _upload(getattr(self, name), self.device)
                for name in ("idx", "val", "mask", "pi")
            }
            self._dev_generation = self._generation
            self._dev_pending.clear()
            self.last_sync_rows = self.rows_cap
        elif self._dev_pending:
            slots = np.unique(np.asarray(self._dev_pending, np.int64))
            width = self.num_bundles * self.k_bound
            at = _upload(slots, self.device)
            for name in ("idx", "val"):
                rows = getattr(self, name).reshape(self.rows_cap, width)[slots]
                self._dev[name].view(self.rows_cap, width).index_copy_(
                    0, at, _upload(rows, self.device))
            for name in ("mask", "pi"):
                self._dev[name].index_copy_(0, at, _upload(getattr(self, name)[slots],
                                                           self.device))
            self._dev_pending.clear()
            self.last_sync_rows = len(slots)
        else:
            self.last_sync_rows = 0
        return self._dev

    def device_padded_problem(self) -> SparseAuctionProblem:
        """The same device mirror as a K-padded book: ``(rows_cap, B, K)``
        views of the flat streams, no copy.  Every bundle region is exactly
        K wide, so these are the numbers ``csr_padded_views`` gathers from
        the reference's CSR view of the same book, and the padded settlement
        path reads them in place."""
        dev = self._sync_device()
        shape = (self.rows_cap, self.num_bundles, self.k_bound)
        return SparseAuctionProblem(
            idx=dev["idx"].view(shape), val=dev["val"].view(shape), bundle_mask=dev["mask"],
            pi=dev["pi"], base_cost=_upload(self.base_cost, self.device),
            supply_scale=_upload(self.supply_scale(), self.device),
            num_resources=self.num_resources,
        )

    def _static_layout(self) -> tuple[np.ndarray, np.ndarray]:
        """(rows, offsets) of the fixed-K layout: bundle ``i`` owns elements
        ``[i·K, (i+1)·K)``."""
        ub, k = self.rows_cap * self.num_bundles, self.k_bound
        offsets = (np.arange(ub + 1, dtype=np.int64) * k).astype(np.int32)
        return np.repeat(np.arange(ub, dtype=np.int32), k), offsets

    def problem(self) -> CSRAuctionProblem:
        """A snapshot of the host arrays as a CSRAuctionProblem (a fresh
        upload to the book's device)."""
        rows, offsets = self._static_layout()
        return CSRAuctionProblem(
            idx=_upload(self.idx, self.device), val=_upload(self.val, self.device),
            rows=_upload(rows, self.device), offsets=_upload(offsets, self.device),
            bundle_mask=_upload(self.mask, self.device), pi=_upload(self.pi, self.device),
            base_cost=_upload(self.base_cost, self.device),
            supply_scale=_upload(self.supply_scale(), self.device),
            num_resources=self.num_resources, k_bound=self.k_bound,
        )

    def device_problem(self) -> CSRAuctionProblem:
        """The device mirror as a CSRAuctionProblem, synced by the rows
        written since the last sync (:meth:`_sync_device`); the streams are
        the mirror's own tensors, no copy."""
        dev = self._sync_device()
        rows, offsets = self._static_layout()
        return CSRAuctionProblem(
            idx=dev["idx"], val=dev["val"], rows=_upload(rows, self.device),
            offsets=_upload(offsets, self.device), bundle_mask=dev["mask"], pi=dev["pi"],
            base_cost=_upload(self.base_cost, self.device),
            supply_scale=_upload(self.supply_scale(), self.device),
            num_resources=self.num_resources, k_bound=self.k_bound,
        )

    # -- full-repack oracle -------------------------------------------------

    def _account(self, s: int):
        """Live slot ``s``'s account, read back from the encoding columns: a
        raw submission as ``(bundles, pi)``, its (idx, val) bundles in
        submission order and π over them; a pre-packed payload as its
        ``(idx (B,K), val (B,K), mask (B,), pi (B,))`` rows."""
        cols = self._cols
        if cols["kind"][s] == 1:
            shape = (self.num_bundles, self.k_bound)
            return (cols["idx"][s].reshape(shape).copy(), cols["val"][s].reshape(shape).copy(),
                    cols["mask"][s].copy(), cols["pi"][s].copy())
        bundles = cols["mask"][s]
        cuts = np.cumsum(cols["nnz"][s][bundles])
        idx, val = (np.split(cols[name][s].copy(), cuts)[:-1] for name in ("idx", "val"))
        return tuple(zip(idx, val)), cols["pi"][s][bundles]

    def rebuilt(self) -> "MarketBook":
        """From-scratch repack: every live account re-packed from its raw
        submission into the *same slot* of a fresh zeroed book — the
        ``packer="loop"`` analogue.  Dead slots stay zeroed, so any stale
        element an incremental delete left behind shows up as a mismatch."""
        fresh = MarketBook(
            self.base_cost, self.num_bundles, self.k_bound, self.rows_cap, self.device
        )
        raw: list = []  # (slot, key, account) of each kind
        packed: list = []
        for s in range(self._next_slot):
            key = self._slot_key[s]
            if key is None:
                continue
            acct = self._account(s)
            if len(acct) == 2:  # (bundles, pi) raw submission
                row = fresh._pack_row(*acct)
                raw.append((s, key, acct))
            else:  # pre-packed payload from upsert_rows
                row = acct
                packed.append((s, key, acct))
            fresh._key_slot[key] = s
            fresh._slot_key[s] = key
            b, k = fresh.num_bundles, fresh.k_bound
            lo = s * b * k
            fresh.idx[lo : lo + b * k] = np.asarray(row[0], np.int32).reshape(-1)
            fresh.val[lo : lo + b * k] = np.asarray(row[1], np.float32).reshape(-1)
            fresh.mask[s] = row[2]
            fresh.pi[s] = row[3]
            fresh._ledger += np.bincount(
                np.asarray(row[0], np.int64).reshape(-1),
                weights=np.abs(np.asarray(row[1], np.float64)).reshape(-1),
                minlength=fresh.num_resources,
            )
            fresh._sell_ledger += np.bincount(
                np.asarray(row[0], np.int64).reshape(-1),
                weights=np.maximum(
                    -np.asarray(row[1], np.float64).reshape(-1), 0.0
                ),
                minlength=fresh.num_resources,
            )
        fresh._next_slot = self._next_slot
        fresh._free = [s for s in range(self._next_slot) if self._slot_key[s] is None]
        if raw:
            slots, keys, accts = zip(*raw)
            fresh._store_columns(list(slots), keys, fresh._raw_columns(accts))
        if packed:
            slots, keys, accts = zip(*packed)
            fresh._store_columns(list(slots), keys, fresh._packed_columns(
                *(np.stack(a) for a in zip(*accts))))
        return fresh

    def parity_check(self) -> None:
        """Assert the incremental book is bit-identical to a full repack,
        its encoding columns at the live slots included."""
        oracle = self.rebuilt()
        live = self._cols["live"]
        pairs = {name: (getattr(self, name), getattr(oracle, name))
                 for name in ("idx", "val", "mask", "pi")}
        pairs["account live"] = (live, oracle._cols["live"])
        for name, a in self._cols.items():
            if name != "live":
                pairs[f"account {name}"] = (a[live], oracle._cols[name][live])
        for name, (a, b) in pairs.items():
            if not np.array_equal(a, b):
                where = np.flatnonzero((a != b).reshape(-1))[:8]
                raise AssertionError(
                    f"incremental book diverged from full repack in {name!r} "
                    f"at flat positions {where.tolist()}"
                )
        if not np.array_equal(self.supply_scale(), oracle.supply_scale()):
            raise AssertionError(
                "incremental supply_scale ledger diverged from full repack"
            )
        if not np.array_equal(self._sell_ledger, oracle._sell_ledger):
            raise AssertionError(
                "incremental offered-supply ledger diverged from full repack"
            )

    # -- crash-recoverable state ---------------------------------------------

    def offered_supply(self) -> np.ndarray:
        """Per-pool units offered for sale across all live rows (exact f64)."""
        return self._sell_ledger.copy()

    def _encode_accounts(
        self, live_slots: Sequence[int]
    ) -> tuple[list, dict[str, np.ndarray]]:
        """CSR-flatten the raw accounts behind ``live_slots`` (ascending
        slot order, every slot live) into O(1) npz-able arrays.  Shared by
        the full and dirty-row exporters so both spell the identical
        on-disk encoding.  Gathers from the encoding columns: raw accounts'
        bundles, pairs and π in slot order, pre-packed payloads stacked."""
        slots = np.asarray(live_slots, np.int64)
        cols = self._cols
        bad = cols["bad_key"][slots]
        if bad.any():
            key = self._slot_key[int(slots[np.argmax(bad)])]
            raise TypeError(
                f"book key {key!r} is not JSON-serializable — durable "
                "books require str/int keys"
            )
        slot_key = self._slot_key
        keys = [slot_key[s] for s in slots.tolist()]
        kinds = cols["kind"][slots]  # 0 = raw (bundles, pi), 1 = pre-packed payload
        raw, packed = slots[kinds == 0], slots[kinds == 1]
        bundles = cols["mask"][raw]
        nnz = cols["nnz"][raw]
        pairs = np.arange(self.num_bundles * self.k_bound) < nnz.sum(axis=1)[:, None]
        shape = (packed.shape[0], self.num_bundles, self.k_bound)
        return keys, {
            "slots": slots,
            "kinds": kinds,
            "raw_counts": bundles.sum(axis=1, dtype=np.int32),
            "raw_nnz": nnz[bundles],
            "raw_idx": cols["idx"][raw][pairs],
            "raw_val": cols["val"][raw][pairs],
            "raw_pi": cols["pi"][raw][bundles],
            "packed_idx": cols["idx"][packed].reshape(shape),
            "packed_val": cols["val"][packed].reshape(shape),
            "packed_mask": cols["mask"][packed],
            "packed_pi": cols["pi"][packed],
        }

    def _install_encoded(self, arrays: dict, keys: list) -> None:
        """Fill the encoding columns of the accounts an
        :meth:`_encode_accounts` record holds, from its arrays.  A record
        whose keys, slots and kinds differ in length, or whose accounts do
        not fit this book's B and K, raises ValueError."""
        slots = np.asarray(arrays["slots"], np.int64)
        packed = np.asarray(arrays["kinds"], np.int8) != 0
        if not (len(keys) == slots.shape[0] == packed.shape[0]):
            raise ValueError("account encoding length mismatch")
        counts = np.asarray(arrays["raw_counts"], np.int64)
        b_cap, k_cap = self.num_bundles, self.k_bound
        if counts.shape != (int((~packed).sum()),) or (counts < 0).any() \
                or (counts > b_cap).any():
            raise ValueError("account encoding does not fit the book")
        mask = np.arange(b_cap) < counts[:, None]
        nnz = np.zeros(mask.shape, np.int32)
        nnz[mask] = np.asarray(arrays["raw_nnz"], np.int32)
        if (nnz < 0).any() or (nnz > k_cap).any():
            raise ValueError("account encoding does not fit the book")
        self._store_columns(slots[~packed], [k for k, p in zip(keys, packed) if not p],
                            self._flat_columns(
                                mask, nnz, np.asarray(arrays["raw_idx"], np.int32),
                                np.asarray(arrays["raw_val"], np.float32),
                                np.asarray(arrays["raw_pi"], np.float32)))
        self._store_columns(slots[packed], [k for k, p in zip(keys, packed) if p],
                            self._packed_columns(*(arrays[f"packed_{name}"] for name in (
                                "idx", "val", "mask", "pi"))))

    def export_state(
        self, clear_dirty: bool = False
    ) -> tuple[dict[str, np.ndarray], dict]:
        """Full mutable state as (flat arrays, JSON-able metadata).

        The encoding is O(1) npz entries regardless of book size: raw
        (bundles, pi) submissions are CSR-flattened across accounts and
        pre-packed payloads are stacked, so a 100k-row book checkpoints as
        ~15 arrays instead of ~300k tiny zip members.  Accounts are stored
        *independently* of the slot arrays, and the restored book keeps them
        as its one account store (the encoding columns), so
        :meth:`parity_check` on it is a real oracle (a corrupt array region
        cannot hide behind accounts re-derived from the same bytes).  Keys must be
        JSON-serializable (the service uses strings throughout).

        With ``clear_dirty=True`` the checkpoint-dirty set is reset, making
        this export the new baseline the next :meth:`export_dirty_state`
        delta chains from.  The returned arrays alias live book storage —
        callers persisting them asynchronously must copy first.
        """
        live = np.flatnonzero(self._cols["live"][: self._next_slot])
        keys, acct_arrays = self._encode_accounts(live)
        arrays = {
            "idx": self.idx,
            "val": self.val,
            "mask": self.mask,
            "pi": self.pi,
            "ledger": self._ledger,
            "sell_ledger": self._sell_ledger,
            "free": np.asarray(self._free, np.int64),
            **acct_arrays,
            "base_cost": self.base_cost,
        }
        meta = {
            "keys": keys,
            "num_bundles": self.num_bundles,
            "k_bound": self.k_bound,
            "rows_cap": self.rows_cap,
            "num_resources": self.num_resources,
            "next_slot": self._next_slot,
            "generation": self._generation,
            "deltas_applied": self.deltas_applied,
        }
        if clear_dirty:
            self._ckpt_dirty.clear()
        return arrays, meta

    @property
    def dirty_rows(self) -> int:
        """Slots written since the last checkpoint export (delta size)."""
        return len(self._ckpt_dirty)

    def mark_dirty(self, slots) -> None:
        """Re-mark rows checkpoint-dirty — the undo for a cleared export
        whose record never became durable (failed background save)."""
        self._ckpt_dirty.update(int(s) for s in slots)

    def export_dirty_state(
        self, clear: bool = True
    ) -> tuple[dict[str, np.ndarray], dict]:
        """Only the rows written since the last export, as a delta record.

        The payload carries each dirty slot's row arrays (fancy-indexed —
        already a stable copy, safe to serialize asynchronously), the full
        f64 ledgers and freelist (O(R + frees), tiny next to the rows), and
        the raw accounts behind the dirty *live* slots in the identical
        encoding :meth:`export_state` uses.  ``meta["row_keys"]`` records
        each dirty slot's occupant (``None`` = tombstone), so
        :meth:`apply_dirty_state` can evict superseded keys before
        installing the new ones.  With ``clear=True`` the dirty set resets,
        chaining the next delta off this one.
        """
        rows = sorted(self._ckpt_dirty)
        b, k = self.num_bundles, self.k_bound
        sl = np.asarray(rows, np.int64)
        el = (
            sl[:, None] * (b * k) + np.arange(b * k, dtype=np.int64)[None, :]
        ).reshape(-1)
        keys, acct_arrays = self._encode_accounts(sl[self._cols["live"][sl]])
        arrays = {
            "rows": sl,
            "idx": self.idx[el],
            "val": self.val[el],
            "mask": self.mask[sl],
            "pi": self.pi[sl],
            "ledger": self._ledger.copy(),
            "sell_ledger": self._sell_ledger.copy(),
            "free": np.asarray(self._free, np.int64),
            **acct_arrays,
        }
        meta = {
            "keys": keys,
            "row_keys": [self._slot_key[s] for s in rows],
            "num_bundles": self.num_bundles,
            "k_bound": self.k_bound,
            "rows_cap": self.rows_cap,
            "num_resources": self.num_resources,
            "next_slot": self._next_slot,
            "generation": self._generation,
            "deltas_applied": self.deltas_applied,
        }
        if clear:
            self._ckpt_dirty.clear()
        return arrays, meta

    def apply_dirty_state(self, arrays: dict, meta: dict) -> None:
        """Replay one :meth:`export_dirty_state` record onto this book.

        The record must be the next delta in the chain that produced this
        book's state (base + ordered replay).  Capacity growth recorded in
        the delta is re-applied; superseded occupants of dirty slots are
        evicted before the new keys install, so remove→re-add slot swaps
        within one delta window land exactly.  The device mirror is
        invalidated (full re-upload on the next sync).
        """
        if (
            int(meta["num_bundles"]) != self.num_bundles
            or int(meta["k_bound"]) != self.k_bound
            or int(meta["num_resources"]) != self.num_resources
        ):
            raise ValueError("delta record shape does not match this book")
        new_cap = int(meta["rows_cap"])
        if new_cap < self.rows_cap:
            raise ValueError("delta record predates this book (rows_cap shrank)")
        if new_cap > self.rows_cap:
            self._grow(new_cap)
        rows = np.asarray(arrays["rows"], np.int64)
        b, k = self.num_bundles, self.k_bound
        el = (
            rows[:, None] * (b * k) + np.arange(b * k, dtype=np.int64)[None, :]
        ).reshape(-1)
        self.idx[el] = np.asarray(arrays["idx"], np.int32).reshape(-1)
        self.val[el] = np.asarray(arrays["val"], np.float32).reshape(-1)
        self.mask[rows] = np.asarray(arrays["mask"], bool)
        self.pi[rows] = np.asarray(arrays["pi"], np.float32)
        for s in rows:  # evict every dirty slot's previous occupant first
            old = self._slot_key[int(s)]
            if old is not None:
                self._key_slot.pop(old, None)
                self._slot_key[int(s)] = None
        self._cols["live"][rows] = False
        for s, key in zip(rows, meta["row_keys"]):
            if key is not None:
                self._slot_key[int(s)] = key
                self._key_slot[key] = int(s)
        self._install_encoded(arrays, meta["keys"])
        self._ledger = np.asarray(arrays["ledger"], np.float64).copy()
        self._sell_ledger = np.asarray(arrays["sell_ledger"], np.float64).copy()
        self._free = [int(x) for x in arrays["free"]]
        self._next_slot = int(meta["next_slot"])
        self._generation = int(meta["generation"])
        self.deltas_applied = int(meta["deltas_applied"])
        self._dev = None
        self._dev_pending.clear()

    @classmethod
    def from_state(
        cls, arrays: dict, meta: dict, device: str | torch.device = "cuda"
    ) -> "MarketBook":
        """Rebuild a book bit-identically from :meth:`export_state` output.

        The device mirror starts cold on ``device`` (full upload on first
        sync); everything host-side — slot arrays, both f64
        ledgers, key↔slot maps, freelist order (LIFO reuse determinism),
        generation, and the accounts' encoding columns behind the
        :meth:`rebuilt` oracle — is restored exactly.
        """
        book = cls(
            np.asarray(arrays["base_cost"], np.float32),
            int(meta["num_bundles"]),
            int(meta["k_bound"]),
            int(meta["rows_cap"]),
            device,
        )
        if book.rows_cap != int(meta["rows_cap"]):
            raise ValueError(
                f"rows_cap {meta['rows_cap']} is not the power of two the "
                "book would allocate — corrupt metadata"
            )
        book.idx = np.asarray(arrays["idx"], np.int32).copy()
        book.val = np.asarray(arrays["val"], np.float32).copy()
        book.mask = np.asarray(arrays["mask"], bool).copy()
        book.pi = np.asarray(arrays["pi"], np.float32).copy()
        book._ledger = np.asarray(arrays["ledger"], np.float64).copy()
        book._sell_ledger = np.asarray(
            arrays["sell_ledger"], np.float64
        ).copy()
        book._free = [int(s) for s in arrays["free"]]
        book._next_slot = int(meta["next_slot"])
        book._generation = int(meta["generation"])
        book.deltas_applied = int(meta["deltas_applied"])
        book._install_encoded(arrays, meta["keys"])
        for s, key in zip(np.asarray(arrays["slots"], np.int64).tolist(), meta["keys"]):
            book._key_slot[key] = s
            book._slot_key[s] = key
        return book


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
