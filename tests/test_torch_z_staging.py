"""The z-mode kernels' span plans and staging arithmetic, replayed in numpy
on the CPU.

``csrc/sparse_bid_eval.cu`` (``sparse_bid_eval_z``) and
``csrc/sparse_bid_eval_csr.cu`` (``sparse_bid_eval_csr_z``) take their span
plan from :func:`ops.z_plan` / :func:`ops.csr_z_plan`: each CTA owns one
contiguous span of users and copies that span of the book into shared
memory with the index arithmetic replayed below (``stage`` with its
incremental row/column walk, the mask's whole words after an alignment
shift, the CSR stretch ``[offsets[u0·B], offsets[u1·B])``).  The replay
fills a model of each CTA's shared memory with the provenance of every
word, then follows the kernels' reads: every element must be staged where
the kernel reads it, read exactly once by the selection, and the CTAs'
spans must cover the users exactly.  Last, the chosen terms read from
those words are summed and held against the JAX reference's z.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small books: more threads only contend with the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

_jax_padded = jax.jit(jref.sparse_bid_eval, static_argnums=5)
_jax_flat = jax.jit(jref.sparse_bid_eval_csr, static_argnums=6)

IDX, VAL, PI, MASK, PRICES, OFF = range(6)  # provenance tags: which array a word came from
EMPTY = -1


def _stage(n_rows, length, stride, nt):
    """Destination word of each element e < n_rows·length under the
    kernel's ``stage()``: thread t starts at (t // len, t % len) and steps
    by (nt // len, nt % len), carrying a column overflow into the row."""
    n = n_rows * length
    dest = np.full(n, -1, np.int64)
    t = np.arange(min(nt, n))
    row, col = t // length, t % length
    drow, dcol = nt // length, nt % length
    e = t.copy()
    while len(e):
        dest[e] = row * stride + col
        row, col = row + drow, col + dcol
        wrap = col >= length
        col, row = np.where(wrap, col - length, col), np.where(wrap, row + 1, row)
        live = e + nt < n
        e, row, col = e[live] + nt, row[live], col[live]
    assert (dest >= 0).all()
    return dest


def _regions(plan, names):
    """name -> (first word, words) of the plan's regions, in carve order."""
    at = [getattr(plan, n) for n in names] + [plan.words]
    for a in at:
        assert a % 4 == 0, "regions are 16-byte aligned"
    return {n: (at[i], at[i + 1] - at[i]) for i, n in enumerate(names)}


class Smem:
    """One CTA's shared memory: the (array, element) each word was copied from."""

    def __init__(self, plan, names):
        self.tag = np.full((plan.words, 2), EMPTY, np.int64)
        self.regions = _regions(plan, names)
        assert 4 * plan.words <= ops.Z_SMEM_BUDGET

    def put(self, region, dest, array, elements):
        first, size = self.regions[region]
        assert dest.size == 0 or (dest.min() >= 0 and dest.max() < size), f"{region} overflows"
        assert len(np.unique(dest)) == dest.size, f"{region}: a word written twice"
        assert (self.tag[first + dest, 0] == EMPTY).all()
        self.tag[first + dest] = np.stack([np.full(dest.size, array), elements], 1)

    def get(self, region, words, array):
        """The elements the kernel finds at ``words`` of a region."""
        first, size = self.regions[region]
        assert (words >= 0).all() and (words < size).all(), f"{region}: read outside"
        tags = self.tag[first + words]
        assert (tags[..., 0] == array).all(), f"{region}: a read of an unstaged word"
        return tags[..., 1]


def _stage_mask(sm, u0, nu, B, align):
    """The span's mask bytes, staged as the whole words that hold them from
    a mask whose address is ``align`` mod 4: the kernel's s_mask[q*B + b]
    must be mask byte (u0 + q)·B + b."""
    mshift = (align + u0 * B) & 3
    words = (mshift + nu * B + 3) // 4
    first = u0 * B - mshift  # mask index of the first staged byte: a word boundary
    assert (align + first) % 4 == 0
    sm.put("mask", np.arange(words), MASK, first + 4 * np.arange(words))  # stage_flat
    byte = mshift + np.arange(nu * B)
    got = sm.get("mask", byte // 4, MASK) + byte % 4
    np.testing.assert_array_equal(got, u0 * B + np.arange(nu * B))


def _spans(U, span):
    u0 = np.arange(0, U, span)
    nu = np.minimum(span, U - u0)
    assert (nu >= 1).all() and nu.sum() == U and len(u0) == -(-U // span)
    np.testing.assert_array_equal(np.concatenate([np.arange(a, a + n) for a, n in zip(u0, nu)]),
                                  np.arange(U))
    return zip(u0.tolist(), nu.tolist())


def _padded_book(U, B, K, R, vector_pi, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, R, (U, B, K)).astype(np.int32)
    dup = rng.random((U, B)) < 0.3
    idx[dup, -1] = idx[dup, 0]  # repeated pools inside a bundle
    val = rng.uniform(-2, 4, (U, B, K)).astype(np.float32)
    mask = rng.random((U, B)) < 0.8
    pi = rng.uniform(-5, 40, (U, B) if vector_pi else U).astype(np.float32)
    prices = rng.random(R).astype(np.float32)
    return idx, val, mask, pi, prices


def _z_of(pools, vals, R):
    """The chosen terms the kernel reads, summed in float64."""
    assert ((pools >= 0) & (pools < R)).all()
    z = np.zeros(R)
    np.add.at(z, pools, vals.astype(np.float64))
    return z


def _check_z_region(sm, plan, R):
    """The z tiles: one (R,) tile, or one a warp (z_mode 2), or none."""
    tiles = {0: 0, 1: 1, 2: plan.threads // 32}[plan.z_mode]
    assert plan.threads % 32 == 0 and sm.regions["z"][1] >= tiles * R


PADDED = [  # (B, K, R, vector pi)
    (3, 2, 1_000, False),  # the planet book
    (8, 3, 24, True),  # the economy book
    (4, 8, 1_000, False), (4, 8, 1_000, True),  # the synthetic books
    (4, 3, 128, True), (4, 3, 129, False),  # both sides of the warp tiles
    (4, 3, 4_096, False), (4, 3, 4_097, True),  # both sides of the staged prices
    (2, 1, 1, True),
    (4, 256, 24, True),  # B*K whose 32 users do not fit: the book from device memory
]
USERS = ["1", "31", "span-1", "span", "span+1", "3span+5"]


def _users(name, span):
    return {"1": 1, "31": 31, "span-1": span - 1, "span": span, "span+1": span + 1,
            "3span+5": 3 * span + 5}[name]


@pytest.mark.parametrize("users", USERS)
@pytest.mark.parametrize("B,K,R,vector_pi", PADDED)
def test_padded_staging_reads_every_pair_once(B, K, R, vector_pi, users):
    plan = ops.z_plan(B, K, R, vector_pi)
    U = _users(users, plan.span)
    idx, val, mask, pi, prices = _padded_book(U, B, K, R, vector_pi, seed=U + R)
    assert plan.threads == min(ops.Z_THREADS, plan.span) and plan.span % 32 == 0
    assert plan.z_mode == (0 if R > ops.Z_STAGE_MAX_R else 2 if R <= ops.Z_WARP_TILE_MAX_R else 1)
    BK, pi_len = B * K, (B if vector_pi else 1)
    reads = np.zeros(U * BK, np.int64)
    sel_pools, sel_vals = [], []
    _, chosen_t = ref.sparse_bid_eval(*map(torch.from_numpy, (idx, val, mask, pi, prices)), R)
    chosen = chosen_t.numpy()
    for cta, (u0, nu) in enumerate(_spans(U, plan.span)):
        sm = Smem(plan, ["idx", "val", "pi", "mask", "prices", "sel", "z"])
        q = np.arange(nu)[:, None]
        pair = (q * plan.ik + np.arange(BK)[None, :])  # the kernel's ib[b*K + k]
        if plan.stage_book:
            # rows back to back go by stage_flat (word e to word e), else by
            # stage() at the odd stride
            rows = (np.arange(nu * BK) if plan.ik == BK
                    else _stage(nu, BK, plan.ik, plan.threads))
            sm.put("idx", rows, IDX, u0 * BK + np.arange(nu * BK))
            sm.put("val", rows, VAL, u0 * BK + np.arange(nu * BK))
            sm.put("pi", np.arange(nu * pi_len) if plan.pv == pi_len
                   else _stage(nu, pi_len, plan.pv, plan.threads), PI,
                   u0 * pi_len + np.arange(nu * pi_len))
            _stage_mask(sm, u0, nu, B, cta % 4)
            got_i = sm.get("idx", pair, IDX)
            np.testing.assert_array_equal(got_i, sm.get("val", pair, VAL))
            np.testing.assert_array_equal(
                sm.get("pi", q * plan.pv + np.arange(pi_len)[None, :], PI),
                (u0 + q) * pi_len + np.arange(pi_len)[None, :])
        else:  # read in place: ib = idx + (u0 + q) * BK
            got_i = (u0 + q) * BK + np.arange(BK)[None, :]
        np.testing.assert_array_equal(got_i, (u0 + q) * BK + np.arange(BK)[None, :])
        np.add.at(reads, got_i.ravel(), 1)
        if plan.stage_prices:
            sm.put("prices", _stage(1, R, R, plan.threads), PRICES, np.arange(R))
            np.testing.assert_array_equal(sm.get("prices", np.arange(R), PRICES), np.arange(R))
        _check_z_region(sm, plan, R)
        assert sm.regions["sel"][1] >= nu
        # the scatter: the chosen bundle's K terms of each user in
        qq = np.flatnonzero(chosen[u0:u0 + nu] >= 0)[:, None]
        e = got_i[qq, chosen[u0 + qq] * K + np.arange(K)[None, :]]
        sel_pools.append(idx.reshape(-1)[e].ravel())
        sel_vals.append(val.reshape(-1)[e].ravel())
    np.testing.assert_array_equal(reads, 1)  # every pair read once by the selection
    z = _z_of(np.concatenate(sel_pools), np.concatenate(sel_vals), R)
    zj, cj = _jax_padded(*map(jnp.asarray, (idx, val, mask, pi, prices)), R)
    np.testing.assert_array_equal(chosen, np.asarray(cj))
    np.testing.assert_allclose(z, np.asarray(zj), rtol=1e-5, atol=1e-4)


def _csr_book(U, B, R, mean, kmax, vector_pi, seed, long_user=None):
    """Flat CSR streams whose users hold exactly ``mean`` elements each
    (so the plan does not move with U), spread over B bundles of 0..kmax
    elements, empty bundles included; ``long_user=(u, n)`` gives one user a
    bundle of n elements more."""
    rng = np.random.default_rng(seed)
    counts = np.zeros((U, B), np.int64)
    for _ in range(mean):  # each element to a random bundle with room
        room = counts < kmax
        pick = np.argmax(rng.random((U, B)) * room, axis=1)
        counts[np.arange(U), pick] += 1
    if long_user is not None:
        counts[long_user[0], 0] += long_user[1]
    offsets = np.zeros(U * B + 1, np.int32)
    offsets[1:] = np.cumsum(counts.ravel())
    nnz = int(offsets[-1])
    idx = rng.integers(0, R, nnz).astype(np.int32)
    val = rng.uniform(-2, 4, nnz).astype(np.float32)
    mask = rng.random((U, B)) < 0.8
    pi = rng.uniform(-5, 40, (U, B) if vector_pi else U).astype(np.float32)
    prices = rng.random(R).astype(np.float32)
    return idx, val, offsets, mask, pi, prices, int(counts.max())


def _replay_csr(U, B, R, vector_pi, book, chosen):
    """Replay every CTA of the CSR plan with the users' ``chosen`` bundles →
    (CTAs past cap, the kernel's z summed in its order, the plan)."""
    idx, val, offsets, mask, pi, prices, k_bound = book
    nnz = idx.size
    plan = ops.csr_z_plan(U, B, nnz, R, vector_pi)
    pi_len = B if vector_pi else 1
    reads = np.zeros(nnz, np.int64)
    stretch_end = int(offsets[0])
    pools, vals, past_cap = [], [], 0
    for cta, (u0, nu) in enumerate(_spans(U, plan.span)):
        sm = Smem(plan, ["off", "idx", "val", "pi", "mask", "prices", "sel", "z"])
        sm.put("off", np.arange(nu * B + 1), OFF, u0 * B + np.arange(nu * B + 1))
        e = np.arange(nu * pi_len)  # stage_rows: element e to row e // len at the odd stride
        sm.put("pi", e // pi_len * plan.pv + e % pi_len, PI, u0 * pi_len + e)
        assert plan.pv == pi_len or plan.pv % 2 == 1
        _stage_mask(sm, u0, nu, B, cta % 4)
        base = int(offsets[u0 * B])
        length = int(offsets[(u0 + nu) * B]) - base
        assert base == stretch_end, "the CTAs' stretches tile the streams"
        stretch_end = base + length
        head = base & 3  # staged from the 16-byte boundary at or below base
        staged = head + length <= plan.cap
        past_cap += not staged
        if staged:
            sm.put("idx", np.arange(head + length), IDX, base - head + np.arange(head + length))
            sm.put("val", np.arange(head + length), VAL, base - head + np.arange(head + length))
        _check_z_region(sm, plan, R)
        off = sm.get("off", np.arange(nu * B + 1), OFF)
        np.testing.assert_array_equal(off, u0 * B + np.arange(nu * B + 1))
        ob = offsets[off].astype(np.int64)  # the staged offsets' values
        # every bundle (q, b): s = ob[q*B + b] - base, c = min(count, k_bound),
        # and the kernel reads I[s + k], V[s + k] for k < c
        s = ob[:-1] - base
        c = np.minimum(np.diff(ob), k_bound)
        seg = np.repeat(np.arange(nu * B), c)
        rel = np.repeat(s, c) + np.arange(c.sum()) - np.repeat(np.cumsum(c) - c, c)
        got = sm.get("idx", head + rel, IDX) if staged else base + rel  # I = s_idx + head
        if staged:
            np.testing.assert_array_equal(got, sm.get("val", head + rel, VAL))
        np.testing.assert_array_equal(got, np.arange(offsets[u0 * B], offsets[(u0 + nu) * B]))
        np.add.at(reads, got, 1)
        picked = chosen[u0 + seg // B] == seg % B
        pools.append(idx[got[picked]])
        vals.append(val[got[picked]])
    assert stretch_end == int(offsets[-1])
    np.testing.assert_array_equal(reads, 1)  # every element read once by the selection
    z = _z_of(np.concatenate(pools), np.concatenate(vals), R)
    return past_cap, z, plan


def _jax_csr(book, R):
    """The JAX reference's (z, chosen) of a CSR book."""
    idx, val, offsets, mask, pi, prices, _ = book
    rows = np.repeat(np.arange(offsets.size - 1, dtype=np.int32), np.diff(offsets))
    zj, cj = _jax_flat(*map(jnp.asarray, (idx, val, rows, mask, pi, prices)), R)
    return np.asarray(zj), np.asarray(cj)


CSR = [  # (B, R, mean elements a user, longest bundle, vector pi)
    (3, 1_000, 6, 2, False),  # the planet book
    (4, 1_000, 16, 16, False), (4, 1_000, 16, 16, True),  # skewed, empty bundles
    (8, 24, 24, 4, True),  # the economy's shape
    (2, 4_097, 3, 3, False),  # unstaged prices
    (1, 1, 1, 1, True),
]


@pytest.mark.parametrize("users", USERS)
@pytest.mark.parametrize("B,R,mean,kmax,vector_pi", CSR)
def test_csr_staging_reads_every_element_once(B, R, mean, kmax, vector_pi, users):
    span = ops.csr_z_plan(1_000, B, 1_000 * mean, R, vector_pi).span
    U = _users(users, span)
    book = _csr_book(U, B, R, mean, kmax, vector_pi, seed=U + B)
    zj, cj = _jax_csr(book, R)
    _, chosen = ref.sparse_bid_eval_csr(*map(torch.from_numpy, book[:6]), R, book[6])
    np.testing.assert_array_equal(chosen.numpy(), cj)
    past_cap, z, plan = _replay_csr(U, B, R, vector_pi, book, cj)
    assert plan.span == span and plan.cap >= span * mean
    assert past_cap == 0
    np.testing.assert_allclose(z, zj, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("vector_pi", [False, True], ids=["scalar_pi", "vector_pi"])
def test_csr_stretch_past_cap_takes_the_device_memory_branch(vector_pi):
    """One user far longer than the book's mean: its CTA's stretch exceeds
    cap and is read in place; the other CTAs stay staged."""
    B, R, U = 4, 24, 3_000
    plan0 = ops.csr_z_plan(U, B, U * 8, R, vector_pi)
    book = _csr_book(U, B, R, 8, 8, vector_pi, seed=5, long_user=(U // 2, plan0.cap + 100))
    zj, cj = _jax_csr(book, R)
    past_cap, z, plan = _replay_csr(U, B, R, vector_pi, book, cj)
    assert past_cap == 1 and -(-U // plan.span) > 1
    np.testing.assert_allclose(z, zj, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("vector_pi", [False, True], ids=["scalar_pi", "vector_pi"])
@pytest.mark.parametrize("R", [1, 24, 128, 129, 1_000, ops.Z_STAGE_MAX_R])
def test_layouts_fit_the_budget(R, vector_pi):
    """Every B·K up to the synthetic 4 × 8 stages the book; every CSR book
    with up to 4 bundles of k_bound 16 (64 elements a user) stages a span's
    mean stretch; both within Z_SMEM_BUDGET and with R staged."""
    for B in range(1, 9):
        for K in range(1, 33 // B):
            plan = ops.z_plan(B, K, R, vector_pi)
            assert plan.stage_book and plan.stage_prices
            assert 4 * plan.words <= ops.Z_SMEM_BUDGET and plan.span >= 32
    for B in (1, 2, 3, 4):
        for mean in (1, 4, 16, 16 * B):
            plan = ops.csr_z_plan(10_000, B, 10_000 * mean, R, vector_pi)
            assert 4 * plan.words <= ops.Z_SMEM_BUDGET and plan.stage_prices
            assert plan.span >= 32 and plan.cap >= plan.span * mean


def test_plans_reject_what_they_cannot_stage():
    with pytest.raises(ValueError):
        ops.z_plan(4, 0, 24, False)
    with pytest.raises(ValueError):
        ops.csr_z_plan(10, 40_000, 10, 24, False)  # 32 users' offsets past the budget
