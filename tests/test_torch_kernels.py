"""The port's plain kernel versions against the JAX package, on the CPU.

The CUDA kernels run only on the card (``chip_smoke.py`` holds them against
these plain versions there).  Here the plain versions meet the JAX oracles
(``repro.kernels.ref``) and the Pallas kernels in interpret mode: chosen
bundles exactly, z to rtol 1e-6 / atol 1e-5 (the scatters add in other
orders).  The deterministic partials mode must equal the reference's
``_blocked_demand_parts`` bit for bit — that pins XLA's fold order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny books: more threads only contend with the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core.auction import _blocked_demand_parts, sparse_bundle_costs  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.sparse_bid_eval import sparse_bid_eval as pallas_sbe  # noqa: E402
from repro.kernels.sparse_bid_eval_csr import sparse_bid_eval_csr as pallas_sbe_csr  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

_blocked_parts_jit = jax.jit(_blocked_demand_parts, static_argnums=(5, 6))


def _book(U, B, K, R, vector_pi, seed=0, scale=False):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, R, size=(U, B, K)).astype(np.int32)
    val = rng.uniform(-2, 4, size=(U, B, K)).astype(np.float32)
    if scale:  # values across many binades, so a wrong fold order shows
        val = (val * 10.0 ** rng.integers(-3, 4, size=(U, B, K))).astype(np.float32)
    mask = rng.random((U, B)) < 0.8
    mask[:, 0] = True
    pi = rng.uniform(-5, 15, size=(U, B) if vector_pi else (U,)).astype(np.float32)
    prices = np.abs(rng.normal(size=R)).astype(np.float32)
    return idx, val, mask, pi, prices


def _csr(idx, val):
    """Flat CSR streams of a padded book with skewed bundle sizes."""
    U, B, K = idx.shape
    rng = np.random.default_rng(1)
    counts = rng.integers(0, K + 1, size=U * B)
    offsets = np.zeros(U * B + 1, np.int32)
    offsets[1:] = np.cumsum(counts)
    take = np.arange(K)[None, :] < counts[:, None]
    rows = np.repeat(np.arange(U * B, dtype=np.int32), counts)
    return idx.reshape(U * B, K)[take], val.reshape(U * B, K)[take], offsets, rows


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


SHAPES = [(4, 1, 3, 1), (33, 3, 18, 4), (128, 8, 130, 3), (517, 5, 200, 8)]


@pytest.mark.parametrize("vector_pi", [False, True], ids=["scalar_pi", "vector_pi"])
@pytest.mark.parametrize("U,B,R,K", SHAPES)
def test_plain_sparse_bid_eval_matches_jax(U, B, R, K, vector_pi):
    idx, val, mask, pi, prices = _book(U, B, K, R, vector_pi)
    z, chosen = ops.sparse_bid_eval(*_t(idx, val, mask, pi, prices), R)
    zr, cr = jref.sparse_bid_eval(*map(jnp.asarray, (idx, val, mask, pi, prices)), R)
    zk, ck = pallas_sbe(*map(jnp.asarray, (idx, val, mask, pi, prices)), R, interpret=True)
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(cr))
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(ck))
    np.testing.assert_allclose(z.numpy(), np.asarray(zr), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(zk), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("vector_pi", [False, True], ids=["scalar_pi", "vector_pi"])
@pytest.mark.parametrize("U,B,R,K", SHAPES)
def test_plain_sparse_bid_eval_csr_matches_jax(U, B, R, K, vector_pi):
    idx, val, mask, pi, prices = _book(U, B, K, R, vector_pi)
    fi, fv, offsets, rows = _csr(idx, val)
    z, chosen = ops.sparse_bid_eval_csr(*_t(fi, fv, offsets, mask, pi, prices), R, K)
    zr, cr = jref.sparse_bid_eval_csr(*map(jnp.asarray, (fi, fv, rows, mask, pi, prices)), R)
    zk, ck = pallas_sbe_csr(
        *map(jnp.asarray, (fi, fv, offsets, mask, pi, prices)), R, K, interpret=True
    )
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(cr))
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(ck))
    np.testing.assert_allclose(z.numpy(), np.asarray(zr), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(zk), rtol=1e-6, atol=1e-5)


def test_empty_csr_bundles_cost_zero():
    R = 5
    offsets = np.array([0, 0, 2, 2, 3], np.int32)  # (u0: empty, 2 elems), (u1: empty, 1)
    fi = np.array([1, 3, 4], np.int32)
    fv = np.array([1.0, 2.0, -1.0], np.float32)
    prices = np.arange(1, R + 1, dtype=np.float32)
    costs, _, _ = ref.csr_costs(*_t(fi, fv, offsets, prices), 2, 2, 2)
    np.testing.assert_array_equal(costs.numpy(), [[0.0, 2.0 + 8.0], [0.0, -5.0]])
    # scalar π: the empty bundle is the cheapest and costs 0 ≤ π
    mask = np.ones((2, 2), bool)
    pi = np.array([0.0, -10.0], np.float32)
    z, chosen = ops.sparse_bid_eval_csr(*_t(fi, fv, offsets, mask, pi, prices), R, 2)
    np.testing.assert_array_equal(chosen.numpy(), [0, -1])
    np.testing.assert_array_equal(z.numpy(), np.zeros(R, np.float32))


def test_all_invalid_user_is_out():
    idx, val, mask, pi, prices = _book(16, 3, 2, 7, vector_pi=True)
    mask[5] = False
    _, chosen = ops.sparse_bid_eval(*_t(idx, val, mask, pi, prices), 7, num_blocks=8)
    assert chosen[5] == -1
    idx, val, mask, pi, prices = _book(16, 3, 2, 7, vector_pi=False)
    mask[5] = False
    _, chosen = ops.sparse_bid_eval(*_t(idx, val, mask, pi, prices), 7)
    assert chosen[5] == -1


# ---------------------------------------------------------------------------
# pinned XLA numerics: the partials fold and the contracted cost fold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "m,pad,R",
    [(1, 0, 24), (7, 3, 24), (16, 0, 24), (16, 5, 24), (24, 0, 24), (29, 2, 30),
     (32, 0, 24), (33, 1, 24), (128, 0, 24), (128, 7, 200), (1025, 4, 24), (8087, 5, 24)],
)
def test_partials_mode_matches_blocked_demand_parts(m, pad, R):
    """Block partials bit-identical to the reference at m rows per block,
    with and without zero-padded users (pad), one-hot (R ≤ 128) and
    scatter (R > 128) rows; m = 8087 is the 100k-agent economy book."""
    U = 8 * m - pad
    B, K = (8, 3) if m == 8087 else (3, 3)
    for vector_pi in (False, True):
        args = _book(U, B, K, R, vector_pi, seed=m + pad, scale=True)
        parts, chosen = ops.sparse_bid_eval(*_t(*args), R, num_blocks=8)
        jparts, jchosen, _ = _blocked_parts_jit(*args, R, 8)
        np.testing.assert_array_equal(chosen.numpy(), np.asarray(jchosen))
        np.testing.assert_array_equal(parts.numpy(), np.asarray(jparts))


@pytest.mark.parametrize("K", [1, 2, 3, 8, 15])
def test_cost_fold_matches_xla(K):
    """Bundle costs are v₀p₀ then one FMA per term, as XLA contracts them."""
    idx, val, mask, _, prices = _book(3000, 4, K, 50, vector_pi=True, scale=True)
    jc = np.asarray(jax.jit(sparse_bundle_costs)(idx, val, mask, prices))
    g = torch.from_numpy(prices)[torch.from_numpy(idx).long()]
    pc = torch.where(torch.from_numpy(mask), ref.cost_fold(torch.from_numpy(val), g), float("inf"))
    np.testing.assert_array_equal(pc.numpy(), jc)


def test_fma_is_correctly_rounded():
    """ref.fma against exact rational arithmetic on values where a separate
    multiply and add round differently."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a = rng.standard_normal(2000).astype(np.float32)
    b = rng.standard_normal(2000).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.standard_normal(2000) * 1e-6)).astype(np.float32)
    got = ref.fma(*_t(a, b, c)).numpy()
    for x, y, w, g in zip(a[:300], b[:300], c[:300], got[:300]):
        exact = Fraction(float(x)) * Fraction(float(y)) + Fraction(float(w))
        lo, hi = np.nextafter(g, np.float32(-np.inf)), np.nextafter(g, np.float32(np.inf))
        err = abs(Fraction(float(g)) - exact)
        assert err <= abs(Fraction(float(lo)) - exact) and err <= abs(Fraction(float(hi)) - exact)
    assert (got != (a * b + c)).any()  # the test data does exercise the single rounding


@pytest.mark.parametrize("n", [5, 16, 24, 33, 100, 1056])
def test_fold_plan_matches_xla_reduce_window(n):
    """XLA rewrites a long reduce into windows of 32 padded by pad//2 zeros
    in front: the HLO it compiles names the same windows as fold_plan."""
    x = jnp.zeros((8, n, 24), jnp.float32)
    hlo = jax.jit(lambda v: v.sum(axis=1)).lower(x).compile().as_text()
    for n_in, lo in ref.fold_plan(n):
        nw = -(-n_in // 32)
        pad = nw * 32 - n_in
        expect = "window={size=1x32x1 stride=1x32x1" + (f" pad=0_0x{lo}_{pad - lo}x0_0" if pad else "")
        assert expect in hlo, (n_in, expect)
    assert ("reduce-window" in hlo) == (n > 32)


def test_cpu_wrappers_do_not_count_launches():
    ops.reset_launch_counts()
    args = _t(*_book(8, 2, 2, 5, vector_pi=False))
    ops.sparse_bid_eval(*args, 5)
    ops.sparse_bid_eval(*args, 5, 2)
    ops.ordered_scatter_add(torch.zeros(3), torch.tensor([0, 2, 0]), torch.ones(3))
    ops.ordered_rows_add(torch.zeros(3, 2), torch.tensor([0, 2, 0]), torch.ones(3, 2))
    assert ops.launch_counts() == {
        "bid_eval": 0, "sparse_bid_eval_z": 0, "sparse_bid_eval_partials": 0,
        "sparse_bid_eval_csr_z": 0, "wkv6": 0, "ordered_scatter_add": 0, "ordered_rows_add": 0,
    }


def test_wrapper_rejects_other_devices():
    args = [t.to("meta") for t in _t(*_book(8, 2, 2, 5, vector_pi=False))]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.sparse_bid_eval(*args, 5)


@pytest.mark.parametrize("num_blocks", [0, ops.MAX_BLOCKS + 1])
def test_partials_wrapper_rejects_block_counts_past_the_grid(num_blocks):
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        args = (torch.zeros((8, 2, 2), dtype=torch.int32, device="cuda"),
                torch.zeros((8, 2, 2), device="cuda"),
                torch.zeros((8, 2), dtype=torch.bool, device="cuda"),
                torch.zeros(8, device="cuda"), torch.zeros(5, device="cuda"))
        with pytest.raises(ValueError, match="num_blocks"):
            ops.sparse_bid_eval(*args, 5, num_blocks)
