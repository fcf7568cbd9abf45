"""The port's reserve curves and clock auction against the JAX package, on the CPU.

Settlement through the blocked demand fn must reproduce the reference bit
for bit — prices, rounds, chosen bundles, SYSTEM checks — under the fixed and
adaptive schedules, the λ-bisection refiner and tie-breaking jitter; payments
agree to rtol 1e-5.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny books: more threads only contend with the other test workers

import jax.numpy as jnp  # noqa: E402

import repro.core as jx  # noqa: E402
from repro_torch import core as pt  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

CONFIGS = {
    "fixed": dict(max_rounds=3000, alpha=0.6, delta=0.25),
    "adaptive": dict(max_rounds=3000, alpha=0.3, delta=0.25, alpha_growth=1.6, delta_decay=0.6),
    "refine": dict(max_rounds=3000, alpha=0.6, delta=0.25, refine_rounds=8),
    "ties": dict(max_rounds=3000, alpha=0.6, delta=0.25, refine_rounds=8, break_ties=True),
}


def _to_port(sp) -> pt.SparseAuctionProblem:
    """The JAX package's SparseAuctionProblem as the port's, on the CPU."""
    a = lambda x: np.asarray(x)  # noqa: E731
    return pt.sparse_problem_from_arrays(
        a(sp.idx), a(sp.val), a(sp.bundle_mask), a(sp.pi), a(sp.base_cost),
        supply_scale=a(sp.supply_scale), device="cpu",
    )


def _vector_pi(sp):
    piv = jnp.broadcast_to(sp.pi[:, None], (sp.num_users, sp.num_bundles))
    return dataclasses.replace(sp, pi=jnp.asarray(piv))


def _dense_book(U, B, R, seed, uniform_k=False):
    """The books of tests/test_sparse.py and tests/test_csr.py."""
    rng = np.random.default_rng(seed)
    bl, pis = [], []
    for _ in range(U):
        alts = []
        for _ in range(int(rng.integers(1, B + 1))):
            q = np.zeros(R, np.float32)
            k = 3 if uniform_k else int(rng.integers(1, 4))
            q[rng.choice(R, size=k, replace=False)] = rng.uniform(-2, 4, size=k)
            alts.append(q)
        bl.append(alts)
        pis.append(float(rng.uniform(-5, 15)))
    return jx.sparsify(jx.pack_bids(bl, pis, base_cost=np.ones(R, np.float32)))


def _quickstart_book(mod, **kw):
    """examples/quickstart.py's pools and bids, packed sparse."""
    pools = [
        mod.ResourcePool("us-east", "tpu_chips", base_cost=10.0, utilization=0.93, supply=512),
        mod.ResourcePool("us-east", "hbm_gb", base_cost=0.05, utilization=0.90, supply=8192),
        mod.ResourcePool("eu-west", "tpu_chips", base_cost=10.0, utilization=0.35, supply=512),
        mod.ResourcePool("eu-west", "hbm_gb", base_cost=0.05, utilization=0.30, supply=8192),
    ]
    idx = mod.pool_index([p.name for p in pools])
    tilde_p = mod.reserve_prices(pools)
    bl, pis = mod.operator_supply_bids(pools, tilde_p, lots=4)
    trees = [
        (mod.OneOf(mod.All(mod.Res("us-east/tpu_chips", 256), mod.Res("us-east/hbm_gb", 4096)),
                   mod.All(mod.Res("eu-west/tpu_chips", 256), mod.Res("eu-west/hbm_gb", 4096))),
         6000.0),
        (mod.All(mod.Res("us-east/tpu_chips", 128), mod.Res("us-east/hbm_gb", 2048)), 9000.0),
        (mod.OneOf(mod.All(mod.Res("us-east/tpu_chips", 128), mod.Res("us-east/hbm_gb", 1024)),
                   mod.All(mod.Res("eu-west/tpu_chips", 128), mod.Res("eu-west/hbm_gb", 1024))),
         1500.0),
    ]
    for tree, pi in trees:
        bl.append(mod.flatten(tree, idx))
        pis.append(pi)
    base = np.array([p.base_cost for p in pools])
    return mod.pack_bids_sparse(bl, pis, base_cost=base, **kw), tilde_p


BOOKS = {
    "random_market_200x30": lambda: jx.random_market(200, 30, seed=0, supply=(2.0, 6.0)),
    "random_market_226x30": lambda: jx.random_market(226, 30, seed=1, supply=(2.0, 6.0)),
    "random_market_vector_pi": lambda: _vector_pi(
        jx.random_market(203, 37, seed=17, supply=(2.0, 6.0))),
    "test_sparse_book": lambda: _dense_book(120, 4, 13, seed=5),
    "test_csr_book": lambda: _dense_book(57, 3, 15, seed=3, uniform_k=True),
}


def _assert_results_agree(rj, rt):
    for f in ("prices", "chosen_bundle", "won", "alloc_idx", "alloc_val", "excess_demand"):
        np.testing.assert_array_equal(getattr(rt, f).numpy(), np.asarray(getattr(rj, f)), err_msg=f)
    assert int(rt.rounds) == int(rj.rounds)
    assert bool(rt.converged) == bool(rj.converged)
    np.testing.assert_allclose(rt.payments.numpy(), np.asarray(rj.payments), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("book", list(BOOKS))
def test_blocked_clock_matches_jax(book, cfg):
    sp = BOOKS[book]()
    R = sp.num_resources
    config_j = jx.ClockConfig(**CONFIGS[cfg])
    config_t = pt.ClockConfig(**CONFIGS[cfg])
    p0 = np.full(R, 0.1, np.float32)
    rj = jx.clock_auction(sp, jnp.asarray(p0), config_j, demand_fn=jx.sparse_proxy_demand_blocked)
    spt = _to_port(sp)
    rt = pt.clock_auction(spt, torch.from_numpy(p0), config_t, demand_fn=ops.blocked_bid_demand_fn())
    _assert_results_agree(rj, rt)
    assert pt.verify_system(spt, rt) == jx.verify_system(sp, rj)
    np.testing.assert_allclose(
        pt.surplus_and_trade(spt, rt), jx.surplus_and_trade(sp, rj), rtol=1e-5
    )


def test_csr_book_settles_like_padded_and_like_jax():
    sp = _dense_book(57, 3, 15, seed=7)
    csr_j = jx.csr_from_padded(sp)
    spt = _to_port(sp)
    csr_t = pt.csr_from_padded(spt)
    for f in ("idx", "val", "rows", "offsets"):
        np.testing.assert_array_equal(getattr(csr_t, f).numpy(), np.asarray(getattr(csr_j, f)))
    p0 = np.full(15, 0.1, np.float32)
    cfg = dict(max_rounds=3000, alpha=0.6, delta=0.25)
    rj = jx.clock_auction(csr_j, jnp.asarray(p0), jx.ClockConfig(**cfg),
                          demand_fn=jx.sparse_proxy_demand_blocked)
    r_csr = pt.clock_auction(csr_t, torch.from_numpy(p0), pt.ClockConfig(**cfg),
                             demand_fn=pt.sparse_proxy_demand_blocked)
    r_pad = pt.clock_auction(spt, torch.from_numpy(p0), pt.ClockConfig(**cfg),
                             demand_fn=pt.sparse_proxy_demand_blocked)
    _assert_results_agree(rj, r_csr)
    for f in ("prices", "chosen_bundle", "payments"):
        np.testing.assert_array_equal(getattr(r_csr, f).numpy(), getattr(r_pad, f).numpy())
    assert pt.verify_system(csr_t, r_csr) == jx.verify_system(csr_j, rj)
    idx, val = pt.csr_padded_views(csr_t)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(sp.idx))
    np.testing.assert_array_equal(val.numpy(), np.asarray(sp.val))


def test_quickstart_book_matches_jax():
    sp, tilde_j = _quickstart_book(jx)
    spt, tilde_t = _quickstart_book(pt, device="cpu")
    np.testing.assert_array_equal(tilde_t, tilde_j)
    for f in ("idx", "val", "bundle_mask", "pi", "base_cost", "supply_scale"):
        np.testing.assert_array_equal(getattr(spt, f).numpy(), np.asarray(getattr(sp, f)))
    rj = jx.clock_auction(sp, jnp.asarray(tilde_j), demand_fn=jx.sparse_proxy_demand_blocked)
    rt = pt.clock_auction(spt, torch.from_numpy(tilde_t), demand_fn=pt.sparse_proxy_demand_blocked)
    _assert_results_agree(rj, rt)
    assert all(pt.verify_system(spt, rt).values())
    assert pt.verify_system(spt, rt) == jx.verify_system(sp, rj)


def test_random_market_packs_like_jax():
    sp = jx.random_market(50, 9, seed=4)
    spt = pt.random_market(50, 9, seed=4, device="cpu")
    for f in ("idx", "val", "bundle_mask", "pi", "base_cost", "supply_scale"):
        np.testing.assert_array_equal(getattr(spt, f).numpy(), np.asarray(getattr(sp, f)))


@pytest.mark.parametrize("curve", ["exp", "logistic", "piecewise"])
def test_reserve_curves_match_jax(curve):
    rng = np.random.default_rng(0)
    psi = np.concatenate([[0.0, 0.6, 0.85, 0.88, 1.0], rng.random(200)]).astype(np.float32)
    cost = rng.uniform(0.05, 10.0, psi.size)
    rel = np.clip(rng.random(psi.size) + 0.3, 0.0, 1.0)
    pools_j = [jx.ResourcePool(f"c{i}", "t", float(c), float(u), reliability=float(r))
               for i, (c, u, r) in enumerate(zip(cost, psi, rel))]
    pools_t = [pt.ResourcePool(f"c{i}", "t", float(c), float(u), reliability=float(r))
               for i, (c, u, r) in enumerate(zip(cost, psi, rel))]
    wj, wt = jx.CURVE_FAMILIES[curve], pt.CURVE_FAMILIES[curve]
    a, b = jx.reserve_prices(pools_j, wj), pt.reserve_prices(pools_t, wt)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(b, a)
    from repro.core.reserve import reputation_weighted_reserve as jrwr

    np.testing.assert_array_equal(
        pt.reputation_weighted_reserve(pools_t, wt, discount=0.7),
        jrwr(pools_j, wj, discount=0.7),
    )


def test_default_demand_fns_settle_close_to_padded():
    """The float-close paths: the default demand fns (the kernel wrappers'
    adapters), scatter z (padded) and segment z (CSR native)."""
    sp = jx.random_market(203, 37, seed=17, supply=(2.0, 6.0))
    spt = _to_port(sp)
    csr = pt.csr_from_padded(spt)
    p0 = torch.full((37,), 0.1)
    cfg = pt.ClockConfig(max_rounds=3000, alpha=0.6, delta=0.25)
    r_pad = pt.clock_auction(spt, p0, cfg)
    r_krn = pt.clock_auction(csr, p0, cfg)
    r_scatter = pt.clock_auction(spt, p0, cfg, demand_fn=pt.sparse_proxy_demand)
    r_nat = pt.clock_auction(csr, p0, cfg, demand_fn=pt.csr_proxy_demand)
    rj = jx.clock_auction(sp, jnp.full((37,), 0.1), jx.ClockConfig(max_rounds=3000, alpha=0.6,
                                                                   delta=0.25))
    for r in (r_pad, r_krn, r_scatter, r_nat):
        assert bool(r.converged)
        np.testing.assert_allclose(r.prices.numpy(), np.asarray(rj.prices), rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(r.won.numpy(), np.asarray(rj.won))


def test_mismatched_demand_fn_raises():
    spt = pt.random_market(10, 4, device="cpu")
    with pytest.raises(TypeError):
        pt.clock_auction(spt, torch.zeros(4), demand_fn=ops.csr_bid_demand_fn())
    with pytest.raises(TypeError):
        pt.clock_auction(pt.csr_from_padded(spt), torch.zeros(4), demand_fn=lambda *a: None)
