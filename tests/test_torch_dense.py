"""The port's dense §III path (the paper's encoding, ``bid_eval``, the dense
clock, provisioning) against the JAX package, on the CPU.

The numerics contract (``repro_torch/kernels/ref.py``) is pinned here first:
XLA's dense cost fold is a left FMA fold below R = 60 (bitwise); from R = 60
XLA vectorizes it in an order that changes with R, and the port's 32-lane
fold is held to 2⁻²⁰·Σ|b·p|.  The z fold over users is bitwise at every
size.  The dense clock must then reproduce the reference bit for bit —
rounds, prices, chosen, won, allocations, SYSTEM flags — with payments and
surplus to rtol 1e-5.  One regime is float-close by design: the settled
``excess_demand`` of a book with 16..32 users (XLA vectorizes that
stand-alone reduce in a pattern that changes with the pool count; the
clock's in-loop z, which sets rounds and prices, stays bitwise).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny books: more threads only contend with the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jx  # noqa: E402
from repro.core import provisioner as jprov  # noqa: E402
from repro.core.auction import bundle_costs as jx_bundle_costs  # noqa: E402
from repro.core.auction import proxy_demand as jx_proxy_demand  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch import core as pt  # noqa: E402
from repro_torch.core import provisioner as tprov  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

FOLD_R = [2, 4, 8, 16, 24, 32, 33, 40, 128, 200]
FOLD_U = [9, 19, 20, 32, 240]  # left fold, 16..32 vectorized (two patterns), windows of 32
SETTLE_Z_FLOAT_CLOSE_USERS = range(16, 33)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _scaled_book(U, B, R, seed, active=False):
    """Bundles across many binades, so a wrong fold order shows."""
    rng = np.random.default_rng(seed)
    b = rng.uniform(-2, 4, (U, B, R)).astype(np.float32)
    b = (b * 10.0 ** rng.integers(-3, 4, (U, B, R))).astype(np.float32)
    mask = rng.random((U, B)) < 0.9
    pi = (rng.normal(size=U) * 1e3 + (1e7 if active else 0.0)).astype(np.float32)
    prices = np.abs(rng.normal(size=R)).astype(np.float32)
    return b, mask, pi, prices


def _round_book(U, B, R, seed):
    """The repo's ``bid_eval_round`` book: normal bundles, mask < 0.9, π
    normal·5, prices |normal|."""
    rng = np.random.default_rng(seed)
    return (
        rng.normal(size=(U, B, R)).astype(np.float32),
        rng.random((U, B)) < 0.9,
        (rng.normal(size=U) * 5).astype(np.float32),
        np.abs(rng.normal(size=R)).astype(np.float32),
    )


# ---------------------------------------------------------------------------
# the pinned folds
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("R", FOLD_R)
def test_dense_cost_fold_matches_xla(R):
    """Bitwise below R = 60 (left FMA fold); the 32-lane regime to 2⁻²⁰·Σ|b·p|."""
    b, mask, _, prices = _scaled_book(37, 3, R, seed=R)
    jc = np.asarray(jax.jit(jx_bundle_costs)(b, mask, prices))
    tc = pt.bundle_costs(*_t(b, mask, prices)).numpy()
    if R < ref.DENSE_LANE_FOLD_MIN_R:
        np.testing.assert_array_equal(tc, jc)
    else:
        scale = (np.abs(b.astype(np.float64)) * prices).sum(-1)[mask]
        assert (np.abs(tc[mask].astype(np.float64) - jc[mask]) <= 2.0**-20 * scale).all()
        np.testing.assert_array_equal(tc[~mask], jc[~mask])
        assert not np.array_equal(tc, jc)  # the regime is real: XLA's order differs


@pytest.mark.parametrize("R", FOLD_R)
def test_dense_z_fold_matches_xla(R):
    """z over users, fused with the row gather as in the reference's clock:
    bitwise at every user count (left fold, the two 16..32 patterns, windows)."""
    for U in FOLD_U:
        args = _scaled_book(U, 3, R, seed=U * R, active=U != 240)
        x, _, _ = jax.jit(jx_proxy_demand)(*args)
        jz = np.asarray(jax.jit(lambda *a: jx_proxy_demand(*a)[0].sum(axis=0))(*args))
        tz = ref.dense_fold(torch.from_numpy(np.array(x)).T).numpy()
        np.testing.assert_array_equal(tz, jz, err_msg=f"U={U}")


# ---------------------------------------------------------------------------
# bid_eval's plain version against the jnp oracle and the Pallas kernel
# ---------------------------------------------------------------------------

BID_EVAL_SHAPES = [(9, 2, 2), (19, 4, 4), (23, 3, 40), (240, 3, 40), (100, 3, 128)]


@pytest.mark.parametrize("U,B,R", BID_EVAL_SHAPES)
def test_plain_bid_eval_matches_jax(U, B, R):
    """The jnp oracle jitted, as the clock runs it (eager, its z reduce
    stands alone and folds left): chosen exact, z bitwise below R = 60.  The
    Pallas kernel in interpret mode: chosen exact, z to rtol 1e-6."""
    args = _round_book(U, B, R, seed=U + R)
    z, chosen = ops.bid_eval(*_t(*args))
    zj, cj = jax.jit(functools.partial(jops.bid_eval, backend="jnp"))(*args)
    zk, ck = jops.bid_eval(*map(jnp.asarray, args), backend="interpret")
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(ck))
    if R < ref.DENSE_LANE_FOLD_MIN_R:
        np.testing.assert_array_equal(z.numpy(), np.asarray(zj))
    else:
        np.testing.assert_allclose(z.numpy(), np.asarray(zj), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(z.numpy(), np.asarray(zk), rtol=1e-6, atol=1e-5)


def test_user_without_a_valid_bundle_is_in_only_at_infinite_pi():
    """The reference's rule (the Pallas kernel instead requires cost < 3e38):
    a fully masked user costs +inf, so it is in only when π = +inf, and then
    its bundle 0 counts in z."""
    b, mask, pi, prices = _round_book(6, 3, 5, seed=0)
    mask[2] = False
    mask[4] = False
    pi[4] = np.inf
    z, chosen = ops.bid_eval(*_t(b, mask, pi, prices))
    zj, cj = jax.jit(functools.partial(jops.bid_eval, backend="jnp"))(b, mask, pi, prices)
    assert chosen[2] == -1 and chosen[4] == 0
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(z.numpy(), np.asarray(zj))
    x, _, _ = pt.proxy_demand(*_t(b, mask, pi, prices))
    np.testing.assert_array_equal(x[4].numpy(), b[4, 0])


def test_ties_take_the_first_cheapest_bundle():
    b, mask, pi, prices = _round_book(8, 4, 6, seed=1)
    b[:, 2] = b[:, 1]  # bundles 1 and 2 tie everywhere
    b[:, 0] = b[:, 1] * 2.0 + 5.0
    mask[:] = True
    pi[:] = 1e9
    z, chosen = ops.bid_eval(*_t(b, mask, pi, prices))
    zj, cj = jax.jit(functools.partial(jops.bid_eval, backend="jnp"))(b, mask, pi, prices)
    np.testing.assert_array_equal(chosen.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(z.numpy(), np.asarray(zj))
    assert set(chosen.tolist()) <= {1, 3}


def test_cpu_bid_eval_does_not_count_launches_and_other_devices_raise():
    ops.reset_launch_counts()
    args = _t(*_round_book(8, 2, 5, seed=2))
    ops.bid_eval(*args)
    ops.bid_demand_fn()(*args)
    assert ops.launch_counts()["bid_eval"] == 0
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.bid_eval(*[a.to("meta") for a in args])


# ---------------------------------------------------------------------------
# packers and converters
# ---------------------------------------------------------------------------


def _quickstart(mod, **kw):
    """examples/quickstart.py's pools and bids, packed dense."""
    pools = [
        mod.ResourcePool("us-east", "tpu_chips", base_cost=10.0, utilization=0.93, supply=512),
        mod.ResourcePool("us-east", "hbm_gb", base_cost=0.05, utilization=0.90, supply=8192),
        mod.ResourcePool("eu-west", "tpu_chips", base_cost=10.0, utilization=0.35, supply=512),
        mod.ResourcePool("eu-west", "hbm_gb", base_cost=0.05, utilization=0.30, supply=8192),
    ]
    idx = mod.pool_index([p.name for p in pools])
    tilde_p = mod.reserve_prices(pools)
    bl, pis = mod.operator_supply_bids(pools, tilde_p, lots=4)
    user_jobs = [-1] * len(bl)
    east, west = "us-east", "eu-west"
    trees = [
        (mod.OneOf(mod.All(mod.Res(f"{east}/tpu_chips", 256), mod.Res(f"{east}/hbm_gb", 4096)),
                   mod.All(mod.Res(f"{west}/tpu_chips", 256), mod.Res(f"{west}/hbm_gb", 4096))),
         6000.0),
        (mod.All(mod.Res(f"{east}/tpu_chips", 128), mod.Res(f"{east}/hbm_gb", 2048)), 9000.0),
        (mod.OneOf(mod.All(mod.Res(f"{east}/tpu_chips", 128), mod.Res(f"{east}/hbm_gb", 1024)),
                   mod.All(mod.Res(f"{west}/tpu_chips", 128), mod.Res(f"{west}/hbm_gb", 1024))),
         1500.0),
    ]
    for j, (tree, pi) in enumerate(trees):
        bl.append(mod.flatten(tree, idx))
        pis.append(pi)
        user_jobs.append(j)
    prob = mod.pack_bids(bl, pis, base_cost=np.array([p.base_cost for p in pools]), **kw)
    return prob, tilde_p, pools, user_jobs


def _elastic(mod, util_east, job_chips, **kw):
    """examples/elastic_train.py's ``run_auction`` book."""
    pools = [
        mod.ResourcePool("us-east", "tpu_chips", 10.0, util_east, supply=256),
        mod.ResourcePool("eu-west", "tpu_chips", 10.0, 0.30, supply=256),
    ]
    tilde_p = mod.reserve_prices(pools)
    bl, pis = mod.operator_supply_bids(pools, tilde_p, lots=4)
    user_jobs = [-1] * len(bl)
    bl.append([np.array([job_chips, 0], np.float32), np.array([0, job_chips], np.float32)])
    pis.append(job_chips * 10.0 * 4)
    user_jobs.append(0)
    prob = mod.pack_bids(bl, pis, base_cost=np.array([10.0, 10.0]), **kw)
    return prob, tilde_p, pools, user_jobs


DENSE_FIELDS = ("bundles", "bundle_mask", "pi", "base_cost", "supply_scale")
SPARSE_FIELDS = ("idx", "val", "bundle_mask", "pi", "base_cost", "supply_scale")


def _assert_same_bytes(a, b, fields):
    for f in fields:
        assert getattr(a, f).numpy().tobytes() == np.asarray(getattr(b, f)).tobytes(), f


def test_pack_bids_sparsify_densify_match_jax():
    pj, tj, _, _ = _quickstart(jx)
    pp, tp, _, _ = _quickstart(pt, device="cpu")
    np.testing.assert_array_equal(tp, tj)
    _assert_same_bytes(pp, pj, DENSE_FIELDS)
    _assert_same_bytes(pt.sparsify(pp), jx.sparsify(pj), SPARSE_FIELDS)
    sj = jx.random_market(40, 9, seed=4)
    sp = pt.random_market(40, 9, seed=4, device="cpu")
    _assert_same_bytes(pt.densify(sp), jx.densify(sj), DENSE_FIELDS)
    _assert_same_bytes(pt.sparsify(pt.densify(sp), k_max=4), jx.sparsify(jx.densify(sj), 4),
                       SPARSE_FIELDS)
    with pytest.raises(ValueError, match="k_max"):
        pt.sparsify(pp, k_max=1)


# ---------------------------------------------------------------------------
# the dense clock
# ---------------------------------------------------------------------------


def _assert_fields_equal(a, b, fields):
    for f in fields:
        np.testing.assert_array_equal(getattr(a, f).numpy(), np.asarray(getattr(b, f)), err_msg=f)


FIXED = dict(max_rounds=3000, alpha=0.6, delta=0.25)


def _to_port(p) -> pt.AuctionProblem:
    a = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return pt.AuctionProblem(a(p.bundles), a(p.bundle_mask), a(p.pi), a(p.base_cost),
                             a(p.supply_scale))


def _random_dense(nb, r, seed, vector_pi=False):
    pd = jx.densify(jx.random_market(nb, r, seed=seed))
    if vector_pi:
        rel = np.random.default_rng(seed).uniform(0.8, 1.2, pd.bundle_mask.shape)
        pd = dataclasses.replace(pd, pi=pd.pi[:, None] * jnp.asarray(rel, jnp.float32))
    return pd, np.full(r, 0.1, np.float32)


CLOCK_BOOKS = {
    "quickstart": lambda: (*_quickstart(jx)[:2], {}),
    "elastic_east_congested": lambda: (*_elastic(jx, 0.93, 128)[:2], {}),
    "elastic_east_idle": lambda: (*_elastic(jx, 0.20, 64)[:2], {}),
    "random_market_seed0": lambda: (*_random_dense(200, 40, 0), FIXED),
    "random_market_seed3": lambda: (*_random_dense(200, 40, 3), FIXED),
    "random_market_seed7": lambda: (*_random_dense(200, 40, 7), FIXED),
    "vector_pi": lambda: (*_random_dense(60, 20, 11, vector_pi=True), FIXED),
    "break_ties": lambda: (*_random_dense(60, 20, 11), dict(FIXED, break_ties=True)),
    "adaptive": lambda: (*_random_dense(60, 20, 11), dict(
        max_rounds=3000, alpha=0.3, delta=0.25, alpha_growth=1.6, delta_decay=0.6)),
    "refine": lambda: (*_random_dense(60, 20, 11), dict(FIXED, refine_rounds=8)),
    "users_20": lambda: (*_random_dense(12, 8, 1), FIXED),
    "users_32": lambda: (*_random_dense(24, 8, 5), FIXED),
}


@pytest.mark.parametrize("book", list(CLOCK_BOOKS))
def test_dense_clock_matches_jax(book):
    pj, p0, cfg = CLOCK_BOOKS[book]()
    rj = jx.clock_auction(pj, jnp.asarray(p0), jx.ClockConfig(**cfg))
    pp = _to_port(pj)
    rt = pt.clock_auction(pp, torch.from_numpy(np.asarray(p0, np.float32)), pt.ClockConfig(**cfg))
    _assert_fields_equal(rt, rj, ("prices", "chosen_bundle", "won", "allocations"))
    assert int(rt.rounds) == int(rj.rounds)
    assert bool(rt.converged) == bool(rj.converged)
    if pp.num_users in SETTLE_Z_FLOAT_CLOSE_USERS:
        np.testing.assert_allclose(rt.excess_demand.numpy(), np.asarray(rj.excess_demand),
                                   rtol=1e-6, atol=1e-5)
    else:
        _assert_fields_equal(rt, rj, ("excess_demand",))
    np.testing.assert_allclose(rt.payments.numpy(), np.asarray(rj.payments), rtol=1e-5, atol=1e-6)
    assert pt.verify_system(pp, rt) == jx.verify_system(pj, rj)
    assert all(pt.verify_system(pp, rt).values())
    np.testing.assert_allclose(pt.surplus_and_trade(pp, rt), jx.surplus_and_trade(pj, rj),
                               rtol=1e-5)
    pi = pp.pi
    if pi.ndim == 2:  # γ prices the chosen bundle's own π
        pi = pi.gather(1, rt.chosen_bundle.long().clamp(min=0)[:, None])[:, 0]
    np.testing.assert_allclose(rt.premium(pi).numpy(), np.asarray(rj.premium(pi.numpy())),
                               rtol=1e-5)


def test_vector_pi_route_and_sparse_twin_agree_with_the_dense_proxy():
    """Vector π goes through ``sparse_bid_eval`` on the exact sparse form of
    the book: its costs equal the dense fold below R = 60, so chosen and z
    equal the dense proxy's.  The book's sparse twin settles float-close
    (its z folds in blocks), and a sparse demand fn on the dense book raises."""
    pj, p0 = _random_dense(60, 20, 11, vector_pi=True)
    pp = _to_port(pj)
    prices = torch.from_numpy(np.abs(np.random.default_rng(0).normal(size=20)).astype(np.float32))
    args = (pp.bundles, pp.bundle_mask, pp.pi, prices)
    z, chosen, _ = ops.bid_demand_fn()(*args)
    x, chosen_d, _ = pt.proxy_demand(*args)
    np.testing.assert_array_equal(chosen.numpy(), chosen_d.numpy())
    np.testing.assert_array_equal(z.numpy(), ref.dense_fold(x.T).numpy())
    cfg = pt.ClockConfig(**FIXED)
    start = torch.from_numpy(p0)
    r_dense = pt.clock_auction(pp, start, cfg)
    r_sp = pt.clock_auction(pt.sparsify(pp), start, cfg, demand_fn=pt.sparse_proxy_demand_blocked)
    np.testing.assert_allclose(r_sp.prices.numpy(), r_dense.prices.numpy(), rtol=1e-4, atol=1e-4)
    assert bool(r_sp.converged) and bool(r_dense.converged)
    with pytest.raises(TypeError, match="dense"):
        pt.clock_auction(pp, start, cfg, demand_fn=pt.sparse_proxy_demand_blocked)


def test_sparse_result_premium_and_dense_allocations_match_jax():
    sj = jx.random_market(50, 12, seed=2)
    sp = pt.random_market(50, 12, seed=2, device="cpu")
    p0 = np.full(12, 0.1, np.float32)
    rj = jx.clock_auction(sj, jnp.asarray(p0), jx.ClockConfig(**FIXED),
                          demand_fn=jx.sparse_proxy_demand_blocked)
    rt = pt.clock_auction(sp, torch.from_numpy(p0), pt.ClockConfig(**FIXED),
                          demand_fn=pt.sparse_proxy_demand_blocked)
    np.testing.assert_array_equal(rt.allocations_dense(12).numpy(),
                                  np.asarray(rj.allocations_dense(12)))
    np.testing.assert_allclose(rt.premium(sp.pi).numpy(), np.asarray(rj.premium(sj.pi)),
                               rtol=1e-5)


# ---------------------------------------------------------------------------
# provisioning
# ---------------------------------------------------------------------------

PROVISION_BOOKS = {
    "quickstart": lambda mod, **kw: _quickstart(mod, **kw),
    "elastic_east_congested": lambda mod, **kw: _elastic(mod, 0.93, 128, **kw),
    "elastic_east_idle": lambda mod, **kw: _elastic(mod, 0.20, 64, **kw),
}


@pytest.mark.parametrize("book", list(PROVISION_BOOKS))
def test_grants_from_allocation_match_jax(book):
    pj, tj, pools, jobs = PROVISION_BOOKS[book](jx)
    pp, tp, _, _ = PROVISION_BOOKS[book](pt, device="cpu")
    rj = jx.clock_auction(pj, jnp.asarray(tj))
    rt = pt.clock_auction(pp, torch.from_numpy(np.asarray(tp, np.float32)))
    names = ["team-A", "team-B", "team-C"]
    clusters, rtypes = [p.cluster for p in pools], [p.rtype for p in pools]
    gj = jprov.grants_from_allocation(rj, names, clusters, rtypes, jobs)
    gt = tprov.grants_from_allocation(rt, names, clusters, rtypes, jobs)
    assert gt and [dataclasses.astuple(g) for g in gt] == [dataclasses.astuple(g) for g in gj]
    for g in gt:
        assert tprov.plan_mesh_shape(g.chips, 2) == jprov.plan_mesh_shape(g.chips, 2)
    for g in gt:  # one rank without a process group, as the reference's mesh on one device
        mesh = tprov.grant_to_mesh(g, 2, device="cpu")
        assert tuple(mesh.shape) == jprov.grant_to_mesh(g, 2).devices.shape == (1, 1)
