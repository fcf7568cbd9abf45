"""The port's sharded clock on gloo process groups, against the live JAX reference.

Mirrors ``tests/test_sharded_settlement.py``.  ``sharded_clock_auction``
and ``Economy(settle_mesh=...)`` run in spawned processes, one a rank, at
gloo world sizes 1, 2, 4 and 8 (``_spawn``: each world size once a module,
within ``SPAWN_TIMEOUT_S``).  Contract: every rank returns the same whole
result, and it is the reference's sharded clock bit for bit at every world
size, which on a book of whole blocks is also the reference's unsharded
``clock_auction(..., demand_fn=sparse_proxy_demand_blocked)`` and the port's
own.  EpochStats are bit-identical across world sizes and to the port's
unsharded economy, and match the reference's as ``test_torch_economy.py``
holds them (payment-derived fields to rtol 1e-5).
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny books: more threads only contend with the other test workers

import jax.numpy as jnp  # noqa: E402

import repro.core as jx  # noqa: E402
from repro_torch import core as pt  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
WORLDS = (1, 2, 4, 8)
SPAWN_TIMEOUT_S = 110
SEEDS = (0, 3, 7)
EPOCHS = 3
CLOCK = dict(max_rounds=3000, alpha=0.6, delta=0.25)
FIELDS = ("prices", "alloc_idx", "alloc_val", "chosen_bundle", "won", "payments",
          "excess_demand", "rounds", "converged")
ARRAYS = ("idx", "val", "bundle_mask", "pi", "base_cost", "supply_scale")


def _market(u, r, seed):
    p = jx.random_market(u, r, seed=seed, supply=(2.0, 6.0))
    return {k: np.asarray(getattr(p, k)) for k in ARRAYS}


def _signed_zero_book(users, seed):
    """``users`` bidders whose bundles are all -0.0 on pool 0 (plus one
    positive term elsewhere on every other bundle), over one operator seller
    a pool: a block of one real row keeps -0.0 in its partial there."""
    rng = np.random.default_rng(seed)
    r, b, k = 4, 2, 2
    idx = np.zeros((users + r, b, k), np.int32)
    val = np.zeros((users + r, b, k), np.float32)
    idx[:users, 0] = 0
    val[:users, 0] = -0.0
    idx[:users, 1] = [1, 2]
    val[:users, 1] = rng.uniform(0.5, 2.0, (users, 2))
    mask = np.ones((users + r, b), bool)
    for p in range(r):
        idx[users + p, 0, 0] = p
        val[users + p, 0, 0] = -3.0
        mask[users + p, 1] = False
    pi = np.concatenate([rng.uniform(5, 10, users), -rng.uniform(0.5, 1.0, r)]).astype(np.float32)
    return {"idx": idx, "val": val, "bundle_mask": mask, "pi": pi,
            "base_cost": np.ones(r, np.float32), "supply_scale": np.full(r, 3.0, np.float32)}


# name: (book, break_ties).  market* books are whole blocks (240 users, 8 of
# 30); padded157 has 3 padded rows in 8 blocks of 20, where the reference's
# sharded fold (no padding inside a shard: XLA's vectorized form) is not its
# unsharded one (a left fold), and its tie jitter is indexed before the
# padding; the signed-zero books put one real row in a block: 8 users, 5
# users (fewer than blocks) and 15 (the last block one row).
BOOKS = {
    **{f"market{s}": (_market(203, 37, s), False) for s in SEEDS},
    "padded157_ties": (_market(120, 37, 0), True),
    "signed_zero8": (_signed_zero_book(4, 0), False),
    "signed_zero5": (_signed_zero_book(1, 1), False),
    "signed_zero15": (_signed_zero_book(11, 2), False),
}
WHOLE_BLOCKS = ("market0", "market3", "market7", "signed_zero8")

WORKER = r"""
import pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
from repro_torch import core as pt
from repro_torch.core import economy as economy_mod

rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=world, rank=rank)
books, clock, fields, seeds, epochs = pickle.load(open(f"{tmp}/books.pkl", "rb"))
out = {"clock": {}, "economy": {}}
mesh = pt.users_mesh()
assert (mesh.size, mesh.rank) == (world, rank)
for name, (arrays, ties) in books.items():
    prob = pt.SparseAuctionProblem(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                                   num_resources=len(arrays["base_cost"]))
    cfg = pt.ClockConfig(break_ties=ties, **clock)
    res = pt.sharded_clock_auction(prob, torch.full((prob.num_resources,), 0.1), cfg, mesh=mesh)
    out["clock"][name] = {f: np.asarray(getattr(res, f)) for f in fields}
sharded_calls = []
inner = economy_mod.sharded_clock_auction
economy_mod.sharded_clock_auction = lambda *a, **k: sharded_calls.append(1) or inner(*a, **k)
for seed in seeds:
    eco = pt.make_fleet_economy(seed=seed, device="cpu", settle_mesh=mesh)
    out["economy"][seed] = [eco.run_epoch() for _ in range(epochs)]
explicit = len(sharded_calls)
auto = pt.make_fleet_economy(seed=seeds[1], device="cpu")  # settle_mesh=None: auto-shard
out["auto"] = auto.run_epoch()
out["calls"] = (explicit, len(sharded_calls) - explicit)
pickle.dump(out, open(f"{tmp}/rank{rank}.pkl", "wb"))
dist.barrier()  # no rank tears its connections down while a peer still uses them
dist.destroy_process_group()
"""


def _spawn(world: int, tmp: Path) -> list[dict]:
    """Run WORKER on ``world`` gloo ranks → each rank's outputs."""
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "books.pkl", "wb") as f:
        pickle.dump((BOOKS, CLOCK, FIELDS, SEEDS, EPOCHS), f)
    env = dict(os.environ, PYTHONPATH=str(SRC))
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(tmp)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {world}: rc {p.returncode}\n{log}"
    outs = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return outs


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = _spawn(world, tmp_path_factory.mktemp(f"world{world}"))
        return cache[world]

    return get


def _jx_problem(arrays):
    return jx.SparseAuctionProblem(**{k: jnp.asarray(v) for k, v in arrays.items()},
                                   num_resources=len(arrays["base_cost"]))


def _pt_problem(arrays):
    return pt.SparseAuctionProblem(**{k: torch.from_numpy(v) for k, v in arrays.items()},
                                   num_resources=len(arrays["base_cost"]))


def _fields(res):
    return {f: np.asarray(getattr(res, f)) for f in FIELDS}


@pytest.fixture(scope="module")
def references():
    """Per book: the reference's sharded clock on one device and its
    unsharded blocked clock, and the port's unsharded clock."""
    out = {}
    for name, (arrays, ties) in BOOKS.items():
        r = len(arrays["base_cost"])
        jcfg = jx.ClockConfig(break_ties=ties, **CLOCK)
        tcfg = pt.ClockConfig(break_ties=ties, **CLOCK)
        jp, p0 = _jx_problem(arrays), jnp.full((r,), 0.1)
        out[name] = {
            "jax_sharded": _fields(jx.sharded_clock_auction(jp, p0, jcfg, mesh=jx.users_mesh(1))),
            "jax_unsharded": _fields(jx.clock_auction(
                jp, p0, jcfg, demand_fn=jx.sparse_proxy_demand_blocked)),
            "port_unsharded": _fields(pt.clock_auction(
                _pt_problem(arrays), torch.full((r,), 0.1), tcfg,
                demand_fn=pt.sparse_proxy_demand_blocked)),
        }
    return out


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and a.tobytes() == b.tobytes()


def _assert_same_result(got, want, where, jax_payments=False):
    """Every field bit for bit; against the reference, payments to rtol 1e-5
    (the port prices a settled bundle with its own fold, ROADMAP queue 3)."""
    for f in FIELDS:
        if f == "payments" and jax_payments:
            np.testing.assert_allclose(got[f], want[f], rtol=1e-5, err_msg=str(where))
        else:
            assert _same_bits(got[f], want[f]), (where, f, got[f], want[f])


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_clock_matches_reference(spawned, references, world):
    outs = spawned(world)
    for name in BOOKS:
        got = outs[0]["clock"][name]
        for r, o in enumerate(outs[1:], 1):
            _assert_same_result(o["clock"][name], got, (name, world, f"rank {r} vs rank 0"))
        refs = references[name]
        _assert_same_result(got, refs["jax_sharded"], (name, world, "reference sharded"), True)
        if name in WHOLE_BLOCKS:
            _assert_same_result(got, refs["jax_unsharded"], (name, world, "reference unsharded"),
                                True)
            _assert_same_result(got, refs["port_unsharded"], (name, world, "port unsharded"))
    assert int(outs[0]["clock"]["market0"]["rounds"]) > 10  # the market actually ticked


def _stats_equal(a, b) -> bool:
    da, db = dataclasses.asdict(a), dataclasses.asdict(b)
    return da.keys() == db.keys() and all(
        _same_bits(da[k], db[k]) if isinstance(da[k], np.ndarray)
        else (da[k] == db[k] or (da[k] != da[k] and db[k] != db[k])) for k in da)


@pytest.fixture(scope="module")
def economy_references():
    def run(mod, seed, **kw):
        eco = mod.make_fleet_economy(seed=seed, **kw)
        return [eco.run_epoch() for _ in range(EPOCHS)]

    return {seed: {"jax": run(jx, seed, settle_mesh=jx.users_mesh(1)),
                   "port": run(pt, seed, device="cpu")} for seed in SEEDS}


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_economy_matches_reference(spawned, economy_references, world):
    from test_torch_economy import _assert_stats_agree

    outs = spawned(world)
    for seed in SEEDS:
        got = outs[0]["economy"][seed]
        for r, o in enumerate(outs[1:], 1):
            assert all(map(_stats_equal, o["economy"][seed], got)), (seed, world, r)
        want = economy_references[seed]
        for e, (sj, st, su) in enumerate(zip(want["jax"], got, want["port"])):
            _assert_stats_agree(sj, st, (seed, world, e))
            assert _stats_equal(st, su), (seed, world, e, "port unsharded")
    # settle_mesh=None shards by itself over a group of several ranks whose
    # size divides settle_blocks, and settles the same epochs
    explicit, auto = outs[0]["calls"]
    assert explicit == len(SEEDS) * EPOCHS and auto == (world > 1)
    assert _stats_equal(outs[0]["auto"], outs[0]["economy"][SEEDS[1]][0])


def test_one_rank_without_a_group_matches_unsharded(references):
    """``users_mesh()`` with no process group: one rank, no collective."""
    mesh = pt.users_mesh()
    assert (mesh.group, mesh.size, mesh.rank) == (None, 1, 0)
    for name in ("market0", "padded157_ties", "signed_zero5"):
        arrays, ties = BOOKS[name]
        cfg = pt.ClockConfig(break_ties=ties, **CLOCK)
        r = len(arrays["base_cost"])
        got = _fields(pt.sharded_clock_auction(_pt_problem(arrays), torch.full((r,), 0.1), cfg))
        _assert_same_result(got, references[name]["jax_sharded"], name, True)


def test_csr_problem_shards_its_padded_reconstruction(references):
    arrays, _ = BOOKS["market3"]
    csr = pt.csr_from_padded(_pt_problem(arrays))
    got = _fields(pt.sharded_clock_auction(csr, torch.full((37,), 0.1), pt.ClockConfig(**CLOCK)))
    _assert_same_result(got, references["market3"]["jax_sharded"], "csr", True)


def test_sharded_rejects_bad_arguments():
    """The reference's checks, messages and order."""
    sp = pt.random_market(6, 4, seed=0, supply=(2.0, 6.0), device="cpu")
    p0 = torch.full((4,), 0.5)
    with pytest.raises(TypeError, match="needs a SparseAuctionProblem"):
        pt.sharded_clock_auction(pt.densify(sp), p0)
    with pytest.raises(ValueError, match="num_blocks=0 must be >= 1"):
        pt.sharded_clock_auction(sp, p0, num_blocks=0)
    with pytest.raises(TypeError, match="is not a sparse demand fn"):
        pt.sharded_clock_auction(sp, p0, demand_fn=lambda *a: None)
    # a demand fn with a baked-in block count is not silently re-blocked
    with pytest.raises(ValueError, match="folds z over 16 user blocks"):
        pt.sharded_clock_auction(sp, p0, demand_fn=pt.blocked_demand_fn(16))
    with pytest.raises(ValueError, match="device count 3 must divide num_blocks=8"):
        pt.sharded_clock_auction(sp, p0, mesh=pt.UsersMesh(None, 3, 0))
    res = pt.sharded_clock_auction(sp, p0, demand_fn=pt.blocked_demand_fn(16), num_blocks=16)
    assert bool(res.converged)
    with pytest.raises(ValueError, match="not initialised"):
        pt.users_mesh(group=object())


def test_economy_settle_mesh_one_rank_and_fused():
    """An explicit one-rank mesh settles the epochs the default path does;
    fused=True with a settle mesh raises the reference's error."""
    ea = pt.make_fleet_economy(seed=3, device="cpu")
    eb = pt.make_fleet_economy(seed=3, device="cpu", settle_mesh=pt.users_mesh())
    for _ in range(2):
        assert _stats_equal(ea.run_epoch(), eb.run_epoch())
    with pytest.raises(ValueError, match="fused=True runs unsharded"):
        pt.make_fleet_economy(seed=0, device="cpu", fused=True, settle_mesh=pt.users_mesh())
