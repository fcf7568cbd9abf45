"""The order in which the partials kernel folds, replayed in numpy, against
the port's plain version and the JAX reference, bit for bit, on the CPU.

``csrc/sparse_bid_eval.cu`` does not fold the block partials the way
``ref.block_partials`` spells them.  It merges each row's chosen terms so
that the first term of a pool carries the k-order fold from +0 of the
pool's terms (the row value), adds into each level-1 window only the pools
its rows touch, row by row, and folds the later levels as left folds.  That
is bit-identical only because adding +0.0 to a running sum that started at
+0 changes nothing (such a sum is never -0.0 in round-to-nearest).  The
replay below is that order in float32 numpy; the books are adversarial:
-0.0, ±inf (so NaN too), repeated pools inside one bundle, padded users and
every regime of ``ref.fold_plan``.  The reference's side is
``_user_block_partials`` as the settlement compiles it, inside
``_blocked_demand_parts``: XLA fuses it with the selection there, and a
stand-alone jit of it vectorizes 20 and 32 rows in other trees.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small books: more threads only contend with the other test workers

import jax  # noqa: E402

from repro.core.auction import _blocked_demand_parts  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

F32 = np.float32
_jax_parts = jax.jit(_blocked_demand_parts, static_argnums=(5, 6))


def _merged_terms(sel_idx, sel_val):
    """(pools, values) (U, K): the first term of each pool in a row carries
    the k-order fold from +0 of the pool's terms; later ones are -1."""
    K = sel_idx.shape[1]
    pools = np.full_like(sel_idx, -1)
    vals = np.zeros_like(sel_val)
    for k in range(K):
        first = np.ones(sel_idx.shape[0], bool)
        for k0 in range(k):
            first &= sel_idx[:, k0] != sel_idx[:, k]
        x = F32(0) + sel_val[:, k]
        for k2 in range(k + 1, K):
            x = np.where(sel_idx[:, k2] == sel_idx[:, k], x + sel_val[:, k2], x)
        pools[:, k] = np.where(first, sel_idx[:, k], -1)
        vals[:, k] = x
    return pools, vals


def _left_fold(x):
    acc = np.zeros(x.shape[:-1], F32)
    for i in range(x.shape[-1]):
        acc = acc + x[..., i]
    return acc


def _vector_fold(x):
    """The kernel's fold_whole(vectorized) of n = 16..32 values."""
    n = x.shape[-1]
    nmain = n // 16 * 16
    a, b = x[..., 0:8], x[..., 8:16]
    for s in range(16, nmain, 16):
        a = a + x[..., s:s + 8]
        b = b + x[..., s + 8:s + 16]
    v = a + b
    pos = nmain
    if n - nmain >= 8:
        v = v + x[..., nmain:nmain + 8]
        pos += 8
    h = v[..., :4] + v[..., 4:]
    acc = (h[..., 0] + h[..., 2]) + (h[..., 1] + h[..., 3])
    for i in range(pos, n):
        acc = acc + x[..., i]
    return acc


def replay_partials(sel_idx, sel_val, R, nb):
    """(nb, R) block partials in the kernel's order."""
    U, K = sel_idx.shape
    m = -(-U // nb)
    pools, vals = _merged_terms(sel_idx, sel_val)
    if m == 1 and R <= ref.ONEHOT_ROWS_MAX_R:  # a row of -0.0 terms on one pool keeps -0.0
        neg = ((sel_idx == sel_idx[:, :1]) & (sel_val.view(np.int32) == np.int32(-(2**31)))).all(1)
        vals[neg, 0] = -0.0
    pad = nb * m - U
    pools = np.concatenate([pools, np.full((pad, K), -1, pools.dtype)]).reshape(nb, m, K)
    vals = np.concatenate([vals, np.zeros((pad, K), F32)]).reshape(nb, m, K)
    if m <= 32:  # one CTA a block: rows as (R,) vectors, folded whole
        rows = np.zeros((nb, R, m), F32)
        jj, ii, kk = np.nonzero(pools >= 0)
        rows[jj, pools[jj, ii, kk], ii] = vals[jj, ii, kk]
        if m == 1:  # the row itself
            return rows[..., 0]
        vectorized = pad == 0 and R <= ref.ONEHOT_ROWS_MAX_R and m >= 16
        return _vector_fold(rows) if vectorized else _left_fold(rows)
    (n, lo), *_ = ref.fold_plan(m)
    n1 = -(-n // 32)
    acc = np.zeros((nb, n1, R), F32)
    blk = np.arange(nb)[:, None]
    win = np.arange(n1)[None, :]
    for row in range(32):  # level 1: rows in order, only the pools each row touches
        i = win * 32 + row - lo
        inside = (i >= 0) & (i < m)
        ic = np.clip(i, 0, m - 1)
        for k in range(K):
            p = np.where(inside, pools[blk, ic, k], -1)
            live = p >= 0
            b_, w_ = np.nonzero(live)
            acc[b_, w_, p[live]] = acc[b_, w_, p[live]] + vals[blk, ic, k][live]
    x = acc.transpose(0, 2, 1)  # (nb, R, n1): the later levels, left folds
    for n_in, lo_n in ref.fold_plan(n1):
        nw = -(-n_in // 32)
        xp = np.zeros(x.shape[:-1] + (nw * 32,), F32)
        xp[..., lo_n:lo_n + n_in] = x
        x = _left_fold(xp.reshape(x.shape[:-1] + (nw, 32)))
    return _left_fold(x)


def _adversarial_book(U, B, K, R, seed):
    """A K-padded book with repeated pools inside bundles, -0.0, +0.0 and
    ±inf values across many binades (an out user's inf times 0 is NaN),
    masked bundles and users priced out."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, R, (U, B, K)).astype(np.int32)
    dup = rng.random((U, B)) < 0.3
    idx[dup, -1] = idx[dup, 0]
    val = (rng.uniform(-2, 4, (U, B, K)) * 10.0 ** rng.integers(-3, 4, (U, B, K))).astype(F32)
    val[rng.random((U, B, K)) < 0.05] = -0.0
    val[rng.random((U, B, K)) < 0.05] = 0.0
    # one sign of inf a user: a bundle of +inf and -inf would cost NaN, where
    # the reference's argmin and the port's first extremum pick differently
    inf = np.where(rng.random(U) < 0.5, np.inf, -np.inf).astype(F32)[:, None, None]
    val = np.where(rng.random((U, B, K)) < 0.004, inf, val).astype(F32)
    mask = rng.random((U, B)) < 0.8
    pi = rng.uniform(-5, 40, U).astype(F32)
    pi[rng.random(U) < 0.1] = -1e30
    prices = rng.random(R).astype(F32)
    return idx, val, mask, pi, prices


def _same_bits(a, b):
    """NaN where the other is NaN; every other value with the same bits."""
    a, b = np.asarray(a, F32), np.asarray(b, F32)
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(np.where(nan, 0, a.view(np.int32)),
                                  np.where(nan, 0, b.view(np.int32)))


def _check(book, R, nb):
    """The replayed order against ref.block_partials on the same selection,
    and against the reference's settlement partials (_user_block_partials
    as _blocked_demand_parts compiles it, fused with the selection)."""
    sel_idx, sel_val, chosen, _ = ref.select_padded(*map(torch.from_numpy, book))
    got = replay_partials(sel_idx.numpy(), sel_val.numpy(), R, nb)
    _same_bits(got, ref.block_partials(sel_idx, sel_val, R, nb).numpy())
    jparts, jchosen, _ = _jax_parts(*book, R, nb)
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(jchosen))
    _same_bits(got, jparts)


@pytest.mark.parametrize("R", [1, 24, 129])
@pytest.mark.parametrize("pad", [0, 3], ids=["full", "padded"])
@pytest.mark.parametrize("m", [1, 15, 16, 20, 24, 31, 32, 33, 100, 1024, 1025, 1056, 8087])
def test_kernel_fold_order_is_bit_identical(m, pad, R):
    """m rows a block (8 blocks, pad zero users), one pool, one-hot rows
    (R ≤ 128) and scattered rows (R > 128); 1056 rows take three levels."""
    _check(_adversarial_book(8 * m - pad, 2, 3, R, seed=m * 7 + pad + R), R, 8)


def test_one_block_and_long_bundles():
    """num_blocks = 1, and K = 8 bundles with repeated pools over 5 pools."""
    _check(_adversarial_book(3000, 2, 8, 5, seed=1), 5, 1)
