"""The sharded clock's parts against the live JAX reference, on the CPU.

``pad_users``, ``sparse_proxy_demand_exact`` and the demand fns'
``partials_fn`` (what a rank of ``sharded_clock_auction`` evaluates on its
own blocks), each held bit for bit; the clock itself, on gloo process
groups, is ``tests/test_torch_sharded.py``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny books: more threads only contend with the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jx  # noqa: E402
from repro.core.auction import _blocked_demand_parts  # noqa: E402
from repro_torch import core as pt  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from test_torch_sharded import (  # noqa: E402
    ARRAYS, BOOKS, _jx_problem, _market, _pt_problem, _same_bits,
)


@pytest.mark.parametrize("multiple", [1, 3, 8, 16])
@pytest.mark.parametrize("vector_pi", [False, True], ids=["scalar_pi", "vector_pi"])
def test_pad_users_matches_reference(multiple, vector_pi):
    arrays = dict(_market(13, 5, 1))
    if vector_pi:
        arrays["pi"] = np.repeat(arrays["pi"][:, None], arrays["idx"].shape[1], 1)
    want = jx.pad_users(_jx_problem(arrays), multiple)
    got = pt.pad_users(_pt_problem(arrays), multiple)
    assert got.num_users == want.num_users and got.num_users % multiple == 0
    for k in ARRAYS:
        assert _same_bits(getattr(got, k).numpy(), np.asarray(getattr(want, k))), k
    # padded rows never activate and leave the demand of the real rows alone
    z, chosen, active = pt.sparse_proxy_demand_exact(
        got.idx, got.val, got.bundle_mask, got.pi, torch.full((5,), 0.3), 5)
    z0, chosen0, _ = pt.sparse_proxy_demand_exact(
        *(getattr(_pt_problem(arrays), k) for k in ARRAYS[:4]), torch.full((5,), 0.3), 5)
    n = len(arrays["pi"])
    assert not active[n:].any() and torch.equal(chosen[:n], chosen0)
    assert _same_bits(z.numpy(), z0.numpy())


@pytest.mark.parametrize("users", [1, 2, 8, 15, 16, 20, 21, 24, 32, 33, 100, 1025])
@pytest.mark.parametrize("r", [5, 24, 128, 129])
def test_sparse_proxy_demand_exact_matches_reference(users, r):
    """z bit for bit (XLA's column sum of the one-hot rows: the fold of one
    user block), chosen and active exactly, across every fold regime."""
    rng = np.random.default_rng(users * 1000 + r)
    idx = rng.integers(0, r, (users, 3, 4)).astype(np.int32)
    val = rng.uniform(-2, 4, (users, 3, 4)).astype(np.float32)
    val[0, :, 0] = -0.0
    mask = rng.random((users, 3)) < 0.85
    pi = rng.uniform(1, 30, users).astype(np.float32)
    prices = rng.uniform(0.1, 1, r).astype(np.float32)
    zj, cj, aj = jax.jit(functools.partial(jx.sparse_proxy_demand_exact, num_resources=r))(
        idx, val, mask, pi, prices)
    t = [torch.from_numpy(a) for a in (idx, val, mask, pi, prices)]
    z, chosen, active = pt.sparse_proxy_demand_exact(*t, r)
    assert _same_bits(z.numpy(), np.asarray(zj))
    assert np.array_equal(chosen.numpy(), np.asarray(cj))
    assert np.array_equal(active.numpy(), np.asarray(aj))
    assert pt.sparse_proxy_demand_exact.exact_settlement


@pytest.mark.parametrize("name,ranks", [("padded157_ties", 4), ("signed_zero8", 8),
                                        ("signed_zero5", 8), ("signed_zero15", 8)])
def test_partials_fn_gathers_into_the_blocked_partials(name, ranks):
    """Each rank's partials over its own blocks, gathered in rank order, are
    the reference's partials of the whole padded book, bit for bit (a block
    of one real row keeps -0.0), for the plain demand fn and the kernel
    adapter (its plain version on CPU tensors) alike."""
    arrays, _ = BOOKS[name]
    r = len(arrays["base_cost"])
    prob = pt.pad_users(_pt_problem(arrays), 8)
    prices = torch.full((r,), 0.1)
    jp = jx.pad_users(_jx_problem(arrays), 8)
    parts_jit = jax.jit(_blocked_demand_parts, static_argnums=(5, 6))
    want = np.asarray(parts_jit(jp.idx, jp.val, jp.bundle_mask, jp.pi,
                                jnp.asarray(prices.numpy()), r, 8)[0])
    if name in ("signed_zero8", "signed_zero5"):
        assert np.signbit(want[:, 0]).any()  # the case is live
    per = prob.num_users // ranks
    for fn in (pt.sparse_proxy_demand_blocked, ops.blocked_bid_demand_fn(8)):
        parts = [fn.partials_fn(*(getattr(prob, k)[i * per:(i + 1) * per] for k in ARRAYS[:4]),
                                prices, r, 8 // ranks)[0] for i in range(ranks)]
        assert _same_bits(torch.cat(parts).numpy(), want)
