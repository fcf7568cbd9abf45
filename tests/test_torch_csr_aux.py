"""The port's last CSR pieces against the live reference's: the
scatter-free demand layouts (``csr_demand_aux``), the CSR proxy demand's
``aux`` branch and the clock that builds ``aux``, ``pack_bids_csr``,
``MarketBook.problem`` / ``device_problem``, and the alias
``believed_bundle_costs``.

Contract: the layouts, the packed streams and the book views are the
reference's bit for bit; with ``aux`` the chosen bundles are bit for bit
(each bundle's cost folds its terms in k order on both sides) and z is
within the CSR tolerance (it reassociates within a pool: rtol 1e-5, atol
1e-5 of the largest |z|).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny books: more threads only contend with the other test workers

import jax.numpy as jnp  # noqa: E402

import repro.core as jx  # noqa: E402
from repro.core import economy as jx_economy  # noqa: E402
from repro.core.types import MarketBook as JBook  # noqa: E402
from repro_torch import core as pt  # noqa: E402
from repro_torch.core import economy as pt_economy  # noqa: E402

Z_RTOL = 1e-5
AUX_FIELDS = ("kmaj_idx", "kmaj_val", "inv_count_perm", "pool_pos", "pool_live", "chunk_pool")


def _bundle_lists(seed, users=60, bundles=4, pools=23, k_max=5, pairs=True):
    """Random XOR lists, bundles of 1..k_max pools, as (idx, val) pairs
    (repeated pools, explicit zero values, trailing (0, 0) entries) or
    dense (R,) vectors; buys and sells."""
    rng = np.random.default_rng(seed)
    out, pis = [], []
    for _ in range(users):
        alts = []
        for _ in range(int(rng.integers(1, bundles + 1))):
            k = int(rng.integers(1, k_max + 1))
            idx = rng.integers(0, pools, k).astype(np.int32)
            val = rng.uniform(-2, 4, k).astype(np.float32)
            val[rng.random(k) < 0.1] = 0.0
            if pairs:
                if rng.random() < 0.2:  # a trailing (0, 0) entry: trimmed
                    idx, val = np.append(idx, 0), np.append(val, np.float32(0))
                alts.append((idx, val))
            else:
                q = np.zeros(pools, np.float32)
                np.add.at(q, idx, val)
                alts.append(q)
        out.append(alts)
        pis.append(float(rng.uniform(-3, 20)))
    return out, np.asarray(pis, np.float32), np.linspace(1.0, 2.0, pools).astype(np.float32)


def _books(seed, **kw):
    lists, pis, base = _bundle_lists(seed, **kw)
    return (jx.pack_bids_csr(lists, pis, base),
            pt.pack_bids_csr(lists, pis, base, device="cpu"))


FIELDS = ("idx", "val", "rows", "offsets", "bundle_mask", "pi", "base_cost", "supply_scale")


@pytest.mark.parametrize("pairs", [True, False], ids=["pairs", "dense"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_bids_csr_streams_bit_for_bit(seed, pairs):
    jp, pp = _books(seed, pairs=pairs)
    for f in FIELDS:
        a, b = np.asarray(getattr(jp, f)), getattr(pp, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert (pp.num_resources, pp.k_bound) == (jp.num_resources, jp.k_bound)


def test_pack_bids_csr_rejects_out_of_range_pools():
    with pytest.raises(ValueError, match="bundle pool indices"):
        pt.pack_bids_csr([[(np.array([0, 9]), np.array([1.0, 1.0]))]], [1.0],
                         np.ones(4, np.float32), device="cpu")


@pytest.mark.parametrize("chunk", [1, 8, 128])
@pytest.mark.parametrize("seed", [0, 3])
def test_csr_demand_aux_arrays_bit_for_bit(seed, chunk):
    jp, pp = _books(seed)
    ja, pa = jx.csr_demand_aux(jp, chunk=chunk), pt.csr_demand_aux(pp, chunk=chunk)
    for f in AUX_FIELDS:
        a, b = np.asarray(getattr(ja, f)), getattr(pa, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert pa.m_k == ja.m_k and pa.chunk == ja.chunk == chunk


def test_csr_demand_aux_of_an_empty_book():
    jp = jx.csr_problem_from_arrays(np.zeros(0, np.int32), np.zeros(0, np.float32),
                                    np.zeros(7, np.int32), np.ones((3, 2), bool),
                                    np.ones(3, np.float32), np.ones(4, np.float32))
    pp = pt.csr_problem_from_arrays(np.zeros(0, np.int32), np.zeros(0, np.float32),
                                    np.zeros(7, np.int32), np.ones((3, 2), bool),
                                    np.ones(3, np.float32), np.ones(4, np.float32),
                                    device="cpu")
    ja, pa = jx.csr_demand_aux(jp), pt.csr_demand_aux(pp)
    for f in AUX_FIELDS:
        assert np.array_equal(np.asarray(getattr(ja, f)), getattr(pa, f).numpy()), f
    z, chosen, _ = pt.csr_proxy_demand(pp, torch.ones(4), pa)
    assert not z.any() and chosen.tolist() == [0, 0, 0]


def _vector(problem_j, problem_p):
    rng = np.random.default_rng(5)
    piv = rng.uniform(-3, 20, problem_j.bundle_mask.shape).astype(np.float32)
    return (dataclasses.replace(problem_j, pi=jnp.asarray(piv)),
            dataclasses.replace(problem_p, pi=torch.from_numpy(piv)))


@pytest.mark.parametrize("vector_pi", [False, True], ids=["scalar_pi", "vector_pi"])
@pytest.mark.parametrize("seed", [0, 1, 4])
def test_aux_demand_chosen_bit_for_bit_and_z_close(seed, vector_pi):
    jp, pp = _books(seed, users=200, k_max=6)
    if vector_pi:
        jp, pp = _vector(jp, pp)
    ja, pa = jx.csr_demand_aux(jp, chunk=8), pt.csr_demand_aux(pp, chunk=8)
    rng = np.random.default_rng(seed)
    for _ in range(4):
        prices = rng.uniform(0.0, 3.0, jp.num_resources).astype(np.float32)
        zj, cj, aj = jx.csr_proxy_demand(jp, jnp.asarray(prices), ja)
        zp, cp, ap = pt.csr_proxy_demand(pp, torch.from_numpy(prices), pa)
        assert np.array_equal(np.asarray(cj), cp.numpy())
        assert np.array_equal(np.asarray(aj), ap.numpy())
        scale = max(float(np.abs(np.asarray(zj)).max()), 1.0)
        np.testing.assert_allclose(zp.numpy(), np.asarray(zj), rtol=Z_RTOL, atol=Z_RTOL * scale)
        # the plain branch selects the same bundles
        zn, cn, _ = pt.csr_proxy_demand(pp, torch.from_numpy(prices))
        assert torch.equal(cn, cp)
        np.testing.assert_allclose(zn.numpy(), zp.numpy(), rtol=Z_RTOL, atol=Z_RTOL * scale)


def test_clock_builds_aux_for_the_demand_fn_that_wants_it():
    """``clock_auction`` hands ``csr_proxy_demand`` the layouts of its book
    (built once, as the reference's clock builds them) and settles as the
    reference does; the kernel adapter, which wants none, gets None."""
    sp = jx.random_market(203, 37, seed=17, supply=(2.0, 6.0))
    jp = jx.csr_from_padded(sp)
    a = np.asarray
    pp = pt.csr_problem_from_arrays(a(jp.idx), a(jp.val), a(jp.offsets), a(jp.bundle_mask),
                                    a(jp.pi), a(jp.base_cost), a(jp.supply_scale),
                                    k_bound=jp.k_bound, device="cpu")
    seen = []
    inner = pt.csr_proxy_demand

    def spy(problem, prices, aux=None):
        seen.append(aux)
        return inner(problem, prices, aux)

    spy.csr_signature = spy.csr_wants_aux = True
    cfg = dict(max_rounds=3000, alpha=0.6, delta=0.25)
    r = pt.clock_auction(pp, torch.full((37,), 0.1), pt.ClockConfig(**cfg), demand_fn=spy)
    assert seen and all(x is seen[0] for x in seen) and isinstance(seen[0], pt.CSRDemandAux)
    want = pt.csr_demand_aux(pp)
    for f in AUX_FIELDS:
        assert torch.equal(getattr(seen[0], f), getattr(want, f)), f
    rj = jx.clock_auction(jp, jnp.full((37,), 0.1), jx.ClockConfig(**cfg),
                          demand_fn=jx.csr_proxy_demand)
    assert bool(r.converged) and bool(rj.converged)
    np.testing.assert_allclose(r.prices.numpy(), np.asarray(rj.prices), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(r.won.numpy(), np.asarray(rj.won))

    calls = []

    def no_aux(problem, prices, aux=None):
        calls.append(aux)
        return inner(problem, prices)

    no_aux.csr_signature = True
    pt.clock_auction(pp, torch.full((37,), 0.1), pt.ClockConfig(max_rounds=5), demand_fn=no_aux)
    assert calls and all(x is None for x in calls)


R, B, K = 6, 3, 4
BASE = np.linspace(1.0, 2.0, R).astype(np.float32)


def _filled_books(seed, n=40):
    rng = np.random.default_rng(seed)
    jb = JBook(BASE, B, K, rows_cap=16)
    pb = pt.MarketBook(BASE, B, K, rows_cap=16, device="cpu")
    for i in range(n):
        if i % 7 == 6 and f"a{i - 3}" in jb:
            for book in (jb, pb):
                book.remove(f"a{i - 3}")
            continue
        nb = int(rng.integers(1, B + 1))
        bundles = []
        for _ in range(nb):
            k = int(rng.integers(1, K + 1))
            bundles.append((rng.integers(0, R, k).astype(np.int32),
                            rng.uniform(-3, 5, k).astype(np.float32)))
        pis = rng.uniform(0.5, 20.0, nb).astype(np.float32)
        for book in (jb, pb):
            book.upsert(f"a{i}", bundles, pis)
    return jb, pb


@pytest.mark.parametrize("seed", [0, 1])
def test_market_book_problem_views_equal_the_reference(seed):
    """``problem`` (a fresh snapshot) and ``device_problem`` (the mirror,
    synced by row writes, read again after more deltas) equal the
    reference's views field for field, the fixed-K ladder included."""
    jb, pb = _filled_books(seed)
    for view in ("problem", "device_problem"):
        jp, pp = getattr(jb, view)(), getattr(pb, view)()
        for f in FIELDS:
            a, b = np.asarray(getattr(jp, f)), getattr(pp, f).numpy()
            assert a.dtype == b.dtype and np.array_equal(a, b), (view, f)
        assert (pp.num_resources, pp.k_bound) == (jp.num_resources, jp.k_bound)
    for book in (jb, pb):  # deltas after the first sync reach the mirror
        book.upsert("late", [(np.array([1, 2], np.int32), np.array([1.5, -0.5], np.float32))],
                    np.array([7.0], np.float32))
        book.remove("a0")
    jp, pp = jb.device_problem(), pb.device_problem()
    for f in FIELDS:
        assert np.array_equal(np.asarray(getattr(jp, f)), getattr(pp, f).numpy()), f
    assert pp.idx.data_ptr() == pb._sync_device()["idx"].data_ptr()  # the mirror, no copy


def test_market_book_views_settle_like_the_reference():
    jb, pb = _filled_books(2)
    cfg = dict(max_rounds=2000, alpha=0.6, delta=0.25)
    rj = jx.clock_auction(jb.problem(), jnp.full((R,), 0.5), jx.ClockConfig(**cfg),
                          demand_fn=jx.csr_proxy_demand)
    rp = pt.clock_auction(pb.device_problem(), torch.full((R,), 0.5), pt.ClockConfig(**cfg),
                          demand_fn=pt.csr_proxy_demand)
    np.testing.assert_allclose(rp.prices.numpy(), np.asarray(rj.prices), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(rp.won.numpy(), np.asarray(rj.won))


def test_believed_bundle_costs_is_the_alias():
    assert pt_economy.believed_bundle_costs is pt.bundle_cluster_costs
    rng = np.random.default_rng(0)
    req = rng.uniform(0, 3, (50, 4)).astype(np.float32)  # (N, T)
    prices = rng.uniform(0.1, 2.0, 12).astype(np.float32)  # (C·T,)
    want = jx_economy.believed_bundle_costs(req, prices)
    got = pt_economy.believed_bundle_costs(req, prices)
    assert np.asarray(want).dtype == got.dtype and np.array_equal(np.asarray(want), got)
