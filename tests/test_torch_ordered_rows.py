"""The port's operand-order row scatter (``kernels.ops.ordered_rows_add``) and
the autograd functions built on it (``ordered_gather``,
``ordered_scatter_rows``, ``models.layers.embed_lookup``), on the CPU.

The plain version is held to ``np.add.at`` bit for bit: float32, float64,
and bfloat16 rounded after every add (ml_dtypes' ``np.add.at``), with rows
out of range dropped.  The gradient of ``embed_lookup`` is held to
``jax.grad`` of the reference's ``table[tokens]`` bit for bit: XLA's CPU
scatter-add folds each row in operand order, as ``np.add.at`` does (checked
here against ``np.add.at`` too), so the tolerance is 0.  The CUDA kernel
itself runs only on the card (``chip_smoke.py`` holds it to this plain
version bit for bit); here the wrapper's refusals are checked on fake CUDA
tensors.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny tensors: more threads only contend with the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.models.layers import embed_lookup  # noqa: E402

DTYPES = {"float32": (torch.float32, np.float32), "float64": (torch.float64, np.float64),
          "bfloat16": (torch.bfloat16, ml_dtypes.bfloat16)}
# (targets, rows, row shape, lowest index, highest index + 1)
SHAPES = [(50, 400, (7,), -5, 60), (3, 1_000, (1,), 0, 3), (129, 64, (2, 5), -1, 140),
          (1, 300, (33,), 0, 1), (40, 0, (4,), 0, 40), (6, 50, (16,), 10, 20)]


def _torch(a, dtype):
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.asarray(a).astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def _bits(t):
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()


def _add_at(out, index, source):
    want = out.copy()
    keep = (index >= 0) & (index < len(out))
    np.add.at(want, index[keep], source[keep])
    return want


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", range(len(SHAPES)), ids=lambda i: "x".join(
    map(str, SHAPES[i][:2])))
def test_plain_ordered_rows_add_is_np_add_at(dtype, shape):
    n, e, row, lo, hi = SHAPES[shape]
    tdt, ndt = DTYPES[dtype]
    rng = np.random.default_rng(shape)
    out = rng.normal(size=(n, *row)).astype(ndt)
    out[0] = -0.0  # signed zeros survive where no row lands
    index = rng.integers(lo, hi, size=e)
    source = (rng.normal(size=(e, *row)) * 10.0 ** rng.integers(-3, 4, size=(e,) + (1,) *
                                                                 len(row))).astype(ndt)
    want = _torch(_add_at(out, index, source), tdt)
    for index_dtype in (torch.int64, torch.int32):
        got = ops.ordered_rows_add(_torch(out, tdt), torch.from_numpy(index).to(index_dtype),
                                   _torch(source, tdt))
        assert got.dtype == tdt and np.array_equal(_bits(got), _bits(want))


def test_bfloat16_rounds_after_every_add():
    """1 + 2⁻⁸ + 2⁻⁸ is 1 + 2⁻⁷, a bfloat16, but rounded after every add
    each 2⁻⁸ alone rounds away (a tie, to even) and the sum stays 1."""
    out = torch.ones((1, 1), dtype=torch.bfloat16)
    src = torch.full((2, 1), 2.0 ** -8, dtype=torch.bfloat16)
    got = ops.ordered_rows_add(out, torch.zeros(2, dtype=torch.int64), src)
    assert float(got) == 1.0
    assert float(ref.ordered_rows_add(torch.ones((1, 1)), torch.zeros(2, dtype=torch.int64),
                                      src.float())) == 1.0 + 2.0 ** -7


def test_plain_version_folds_in_operand_order():
    """Large and small rows into one target: the order decides the sum."""
    src = torch.tensor([[1e8], [1.0], [-1e8], [1.0]], dtype=torch.float32)
    for perm in ([0, 1, 2, 3], [1, 3, 0, 2], [0, 2, 1, 3]):
        got = ops.ordered_rows_add(torch.zeros((1, 1)), torch.zeros(4, dtype=torch.int64),
                                   src[perm])
        want = np.zeros((1, 1), np.float32)
        np.add.at(want, np.zeros(4, np.int64), src[perm].numpy())
        assert float(got) == float(want[0, 0])


REJECTED = {
    "int8 out": ((8, 4), torch.int8, torch.int8, torch.int64, TypeError),
    "mixed dtypes": ((8, 4), torch.float32, torch.bfloat16, torch.int64, TypeError),
    "float index": ((8, 4), torch.float32, torch.float32, torch.float32, TypeError),
    "row shape": ((8, 5), torch.float32, torch.float32, torch.int64, ValueError),
}


@pytest.mark.parametrize("case", REJECTED)
def test_wrapper_rejects_what_the_kernel_cannot_take(case):
    """On (fake) CUDA tensors the wrapper raises before any launch."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    shape, out_dtype, source_dtype, index_dtype, error = REJECTED[case]
    with FakeTensorMode():
        out = torch.zeros(shape, dtype=out_dtype, device="cuda")
        index = torch.zeros(10, dtype=index_dtype, device="cuda")
        source = torch.zeros((10, 4), dtype=source_dtype, device="cuda")
        with pytest.raises(error):
            ops.ordered_rows_add(out, index, source)


def test_wrapper_launches_nothing_without_rows_or_targets():
    from torch._subclasses.fake_tensor import FakeTensorMode

    ops.reset_launch_counts()
    with FakeTensorMode():
        for n, e in ((0, 10), (10, 0)):
            out = torch.zeros((n, 4), device="cuda")
            ops.ordered_rows_add(out, torch.zeros(e, dtype=torch.int64, device="cuda"),
                                 torch.zeros((e, 4), device="cuda"))
    assert ops.launch_counts()["ordered_rows_add"] == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("vocab,d,batch,seq", [(50, 16, 4, 500), (512, 64, 2, 48)])
def test_embed_lookup_gradient_is_jax_grad_bit_for_bit(dtype, vocab, d, batch, seq):
    """Many repeated tokens (a tenth of the vocabulary in use): the gradient
    of ``embed_lookup`` equals ``jax.grad`` of the reference's
    ``table[tokens]`` bit for bit, and both equal ``np.add.at``."""
    tdt, ndt = DTYPES[dtype]
    rng = np.random.default_rng(vocab)
    table = rng.normal(size=(vocab, d)).astype(ndt)
    toks = rng.integers(0, max(vocab // 10, 1), size=(batch, seq)).astype(np.int32)
    g = rng.normal(size=(batch, seq, d)).astype(ndt)

    def f(t, tk, w):
        return jnp.sum((jnp.asarray(t)[tk] * w).astype(jnp.float32))

    want = np.asarray(jax.jit(jax.grad(f))(jnp.asarray(table), jnp.asarray(toks),
                                           jnp.asarray(g)))
    assert np.array_equal(want, _add_at(np.zeros_like(table), toks.reshape(-1),
                                        g.reshape(-1, d)))
    t = _torch(table, tdt).requires_grad_(True)
    rows = embed_lookup(torch.from_numpy(toks), t)
    assert torch.equal(rows.detach(), _torch(table, tdt)[torch.from_numpy(toks).long()])
    (grad,) = torch.autograd.grad(rows, t, _torch(g, tdt))
    assert grad.dtype == tdt and np.array_equal(_bits(grad), _bits(_torch(want, tdt)))


def test_embed_lookup_forward_is_the_reference_embedding():
    rng = np.random.default_rng(3)
    table = rng.normal(size=(30, 8)).astype(np.float32)
    toks = rng.integers(0, 30, size=(3, 7)).astype(np.int32)
    want = np.asarray(jnp.asarray(table)[jnp.asarray(toks)])
    assert np.array_equal(embed_lookup(torch.from_numpy(toks), torch.from_numpy(table)).numpy(),
                          want)


def test_ordered_gather_and_scatter_rows_out_of_range():
    """An index out of range gathers zeros and takes no gradient; the
    scatter drops its row, and the scatter's gradient gathers zeros there."""
    table = torch.arange(12.0).reshape(4, 3).requires_grad_(True)
    index = torch.tensor([2, -1, 4, 2, 0])
    rows = ops.ordered_gather(table, index)
    assert torch.equal(rows[1], torch.zeros(3)) and torch.equal(rows[2], torch.zeros(3))
    assert torch.equal(rows[0], table[2].detach())
    (grad,) = torch.autograd.grad(rows, table, torch.ones(5, 3))
    assert torch.equal(grad, torch.tensor([[1.0] * 3, [0.0] * 3, [2.0] * 3, [0.0] * 3]))

    src = torch.arange(15.0).reshape(5, 3).requires_grad_(True)
    out = ops.ordered_scatter_rows(4, index, src)
    assert torch.equal(out, torch.tensor([[12.0, 13, 14], [0, 0, 0], [9, 11, 13], [0, 0, 0]]))
    up = torch.arange(12.0).reshape(4, 3)
    (gsrc,) = torch.autograd.grad(out, src, up)
    assert torch.equal(gsrc, torch.stack([up[2], torch.zeros(3), torch.zeros(3), up[2], up[0]]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_scatter_rows_and_its_gradient_match_the_reference_combine(dtype):
    """The MoE combine's scatter (``zeros.at[buf_tok].add(y)``, pad row
    sliced away) and its gradient against JAX, bit for bit."""
    tdt, ndt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    tg, slots, d = 9, 40, 6
    buf_tok = rng.integers(0, tg + 1, size=slots).astype(np.int32)  # tg: the pad token
    y = rng.normal(size=(slots, d)).astype(ndt)
    up = rng.normal(size=(tg, d)).astype(ndt)

    def combine(yy, bt):
        return jnp.zeros((tg + 1, d), yy.dtype).at[bt].add(yy)[:tg]

    want = np.asarray(jax.jit(combine)(jnp.asarray(y), jnp.asarray(buf_tok)))
    _, vjp = jax.vjp(lambda yy: combine(yy, jnp.asarray(buf_tok)), jnp.asarray(y))
    (want_grad,) = vjp(jnp.asarray(up))
    ty = _torch(y, tdt).requires_grad_(True)
    got = ops.ordered_scatter_rows(tg, torch.from_numpy(buf_tok), ty)  # the pad dropped
    assert np.array_equal(_bits(got.detach()), _bits(_torch(want, tdt)))
    (grad,) = torch.autograd.grad(got, ty, _torch(up, tdt))
    assert np.array_equal(_bits(grad), _bits(_torch(np.asarray(want_grad), tdt)))


# ---------------------------------------------------------------------------
# The kernel's plan and index arithmetic (csrc/ordered_rows.cu), replayed in
# numpy: no CPU run reaches the kernel, so its routes, its one-CTA partition
# (digit passes, warp prefixes, ballot ranks), the scan route's order and
# the fold's ring are held here to a stable argsort and np.add.at,
# tolerance 0.
# ---------------------------------------------------------------------------

WARP = 32
KIB = 1024

# (e, n, width, dtype, index dtype, aligned bytes) -> (route, vec, threads,
# tiles, grid, passes, bits)
PLANS = {
    "a decode step's combine": ((1_024, 4, 7_168, torch.bfloat16, torch.int64, 16),
                                ("scan", 8, 224, 4, 16, 0, 0)),
    "the prefill's combine": ((5_120, 512, 7_168, torch.bfloat16, torch.int64, 16),
                              ("smem", 8, 224, 4, 792, 1, 9)),
    "the qwen3-1.7b embedding gradient": ((2_048, 151_936, 2_048, torch.float32, torch.int32, 16),
                                          ("smem", 4, 256, 2, 792, 2, 9)),
    "E at the one-CTA limit": ((16_384, 64, 2_048, torch.float32, torch.int64, 16),
                               ("smem", 4, 256, 2, 128, 1, 6)),
    "E one past the limit": ((16_385, 64, 2_048, torch.float32, torch.int64, 16),
                             ("sort", 4, 256, 2, 128, 0, 0)),
    "n = 1": ((5_000, 1, 33, torch.float32, torch.int32, 16), ("smem", 1, 64, 1, 1, 1, 0)),
    "n = 1, few rows: scan": ((4_096, 1, 7_168, torch.bfloat16, torch.int64, 16),
                              ("scan", 8, 224, 4, 4, 0, 0)),
    "E = 1": ((1, 151_936, 2_048, torch.float32, torch.int64, 16), ("smem", 4, 256, 2, 2, 2, 9)),
    "E = 1, n = 1": ((1, 1, 2_048, torch.float32, torch.int64, 16), ("scan", 4, 256, 2, 2, 0, 0)),
    "scan rows limit + 1": ((4_097, 1, 7_168, torch.bfloat16, torch.int64, 16),
                            ("smem", 8, 224, 4, 4, 1, 0)),
    "scan bytes past 2 MiB": ((4_096, 32, 7_168, torch.bfloat16, torch.int64, 16),
                              ("smem", 8, 224, 4, 128, 1, 5)),
    "scan bytes within 2 MiB, int32": ((4_096, 32, 7_168, torch.bfloat16, torch.int32, 16),
                                       ("scan", 8, 224, 4, 128, 0, 0)),
    "width not a multiple of 8": ((5_120, 512, 7_172, torch.bfloat16, torch.int64, 16),
                                  ("smem", 4, 256, 8, 792, 1, 9)),
    "width 33 bfloat16": ((5_120, 512, 33, torch.bfloat16, torch.int64, 16),
                          ("smem", 1, 64, 1, 512, 1, 9)),
    "unaligned source, bfloat16": ((5_120, 512, 7_168, torch.bfloat16, torch.int64, 2),
                                   ("smem", 1, 256, 28, 792, 1, 9)),
    "8-byte aligned float32": ((5_120, 512, 2_048, torch.float32, torch.int64, 8),
                               ("smem", 2, 256, 4, 792, 1, 9)),
    "float64 rows of 2,048": ((2_048, 151_936, 2_048, torch.float64, torch.int32, 16),
                              ("smem", 2, 256, 4, 792, 2, 9)),
    "n past int16 keys, 31 bits": ((16_384, 2**31 - 2, 1, torch.float32, torch.int64, 16),
                                   ("smem", 1, 32, 1, 792, 4, 8)),
}


@pytest.mark.parametrize("case", PLANS)
def test_rows_plan_route_vector_and_grid(case):
    """The route, the vector width, the CTA and the grid from the shapes
    alone, at the paths' calls and at each limit."""
    args, want = PLANS[case]
    plan = ops.rows_plan(*args)
    assert tuple(plan[:7]) == want
    e, n, width = args[:3]
    assert plan.threads % WARP == 0 and plan.threads <= ops.ROWS_FOLD_THREADS
    assert plan.tiles * plan.threads * plan.vec >= width and width % plan.vec == 0
    assert plan.vec * args[3].itemsize <= 16 and args[5] % (plan.vec * args[3].itemsize) == 0
    if plan.route == "smem":  # the partition's keys, counters and two orders fit
        assert plan.smem_bytes <= 227 * KIB and plan.passes * plan.bits >= (n - 1).bit_length()


def _ballot(pred):
    """(..., 32) bool -> (...) uint64 mask, lane l at bit l."""
    return (pred.astype(np.uint64) << np.arange(WARP, dtype=np.uint64)).sum(-1, dtype=np.uint64)


def _popc(x):
    return np.vectorize(lambda v: bin(int(v)).count("1"), otypes=[np.int64])(x)


def _peers(d):
    """(..., 32) digits (-1: a dropped lane) -> the kept lanes of each lane's
    step with its digit (0 for a dropped lane), as ``peers_of``: one ballot
    for each bit in which the kept lanes' digits differ."""
    kept = d >= 0
    u = np.where(kept, d, 0).astype(np.uint64)
    full = np.uint64(2**WARP - 1)
    any_ = np.bitwise_or.reduce(u, -1, keepdims=True)
    all_ = np.bitwise_and.reduce(np.where(kept, u, full), -1, keepdims=True)
    varying = any_ ^ all_
    peers = np.where(kept, _ballot(kept)[..., None], np.uint64(0))
    for b in range(WARP):
        bit = ((u >> np.uint64(b)) & np.uint64(1)).astype(bool)
        ones = _ballot(bit)[..., None]
        narrow = ((varying >> np.uint64(b)) & np.uint64(1)).astype(bool)
        peers = np.where(narrow, peers & np.where(bit, ones, ~ones & full), peers)
    return peers


def replay_partition(index, n, plan):
    """(perm, starts, targets): the kept rows in the order the one-CTA
    partition leaves them, and its runs of equal targets (starts[-1] the
    kept count), as ``partition_kernel`` computes them: each pass counts
    each warp's rows by digit, scans the counts digit-major and places each
    row at its (digit, warp) start + the rows of its digit the warp has
    placed + its rank among its step's lanes with that digit."""
    wide = index.astype(np.int64)
    keys = np.where((wide >= 0) & (wide < n), wide, -1)  # the index read in place
    warps, buckets = ops.ROWS_PART_WARPS, 1 << plan.bits
    below = (np.uint64(1) << np.arange(WARP, dtype=np.uint64)) - np.uint64(1)
    order, length = np.arange(index.shape[0]), index.shape[0]
    for p in range(plan.passes):
        sub = -(-length // (warps * WARP)) * WARP  # whole steps a warp
        at = np.arange(warps)[:, None] * sub + np.arange(sub)[None, :]
        inside = at < length
        rows = np.where(inside, order[np.minimum(at, max(length - 1, 0))] if length else 0, 0)
        k = np.where(inside, keys[rows], -1)
        d = np.where(k >= 0, (k >> (p * plan.bits)) & (buckets - 1), -1)
        counters = np.zeros((warps, buckets), np.int64)
        w_, r_ = np.nonzero(d >= 0)
        np.add.at(counters, (w_, d[w_, r_]), 1)
        flat = counters.T.reshape(-1)  # digit-major: (digit, warp)
        placed = (np.cumsum(flat) - flat).reshape(buckets, warps).T.copy()
        total = int(flat.sum())
        steps = sub // WARP
        ds, rs = d.reshape(warps, steps, WARP), rows.reshape(warps, steps, WARP)
        peers = _peers(ds)
        rank, size = _popc(peers & below), _popc(peers)
        lead = (ds >= 0) & ((peers & below) == 0)
        to = np.full(total, -1, np.int64)
        wi = np.broadcast_to(np.arange(warps)[:, None], (warps, WARP))
        for s in range(steps):
            dd, keep, ld = ds[:, s], ds[:, s] >= 0, lead[:, s]
            pos = np.take_along_axis(placed, np.maximum(dd, 0), 1) + rank[:, s]
            assert (to[pos[keep]] == -1).all(), "two rows placed at one position"
            to[pos[keep]] = rs[:, s][keep]
            np.add.at(placed, (wi[ld], dd[ld]), size[:, s][ld])
        assert (to >= 0).all()
        order, length = to, total
    sorted_keys = keys[order]
    head = np.ones(length, bool)
    head[1:] = sorted_keys[1:] != sorted_keys[:-1]
    starts = np.append(np.flatnonzero(head), length)
    return order, starts, sorted_keys[head]


def _partition_index(name):
    """(index, n) of a partition case, from a seed."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "the prefill's combine":
        n, slots, kept = 512, 5_120, 4_018
        index = np.full(slots, n, np.int64)  # empty capacity slots: the pad token, dropped
        index[rng.choice(slots, kept, replace=False)] = np.repeat(np.arange(n), 8)[
            rng.choice(n * 8, kept, replace=False)]
        return index, n
    if name == "the qwen3-1.7b embedding gradient":
        return rng.integers(0, 151_936, 2_048).astype(np.int32), 151_936
    if name == "E at the limit, one chain of 10,000":
        index = rng.integers(2, 64, 16_384)
        index[rng.choice(16_384, 10_000, replace=False)] = 0
        index[rng.choice(16_384, 160, replace=False)] = rng.choice([-1, 67, -5], 160)
        return index.astype(np.int64), 64
    if name == "every row on one target (a chain of E)":
        return np.full(16_384, 299, np.int32), 300
    if name == "n = 1":
        return rng.integers(-1, 2, 5_000).astype(np.int32), 1
    if name == "E = 1":
        return np.array([151_935], np.int64), 151_936
    if name == "every row dropped":
        return rng.choice(np.array([-1, 4_096, 2**40], np.int64), 6_000), 4_096
    if name == "31 key bits, int64 past int32":
        index = rng.integers(0, 2**31 - 2, 12_000)
        index[::7] = rng.integers(0, 5, index[::7].shape)  # repeats
        index[::11] = rng.choice([2**33 + 3, -2**40, 2**31 - 2], index[::11].shape)
        return index.astype(np.int64), 2**31 - 2
    raise KeyError(name)


PARTITIONS = ["the prefill's combine", "the qwen3-1.7b embedding gradient",
              "E at the limit, one chain of 10,000", "every row on one target (a chain of E)",
              "n = 1", "E = 1", "every row dropped", "31 key bits, int64 past int32"]


@pytest.mark.parametrize("name", PARTITIONS)
def test_partition_replay_is_a_stable_argsort_of_the_kept_rows(name):
    index, n = _partition_index(name)
    plan = ops.rows_plan(index.shape[0], n, 2_048, torch.float32,
                         torch.from_numpy(index).dtype, 16)
    assert plan.route == "smem"
    perm, starts, targets = replay_partition(index, n, plan)
    wide = index.astype(np.int64)
    kept = np.flatnonzero((wide >= 0) & (wide < n))
    want = kept[np.argsort(wide[kept], kind="stable")]
    assert np.array_equal(perm, want)
    keys, first = np.unique(wide[want], return_index=True)
    assert np.array_equal(targets, keys) and np.array_equal(starts, np.append(first, len(want)))
    assert len(targets) <= min(n, index.shape[0])  # the runs fit the scratch's min(n, E)


@pytest.mark.parametrize("name", ["E at the limit, one chain of 10,000", "every row dropped",
                                  "31 key bits, int64 past int32", "E = 1"])
def test_sort_route_partition_writes_what_the_kernel_does(name):
    """``ops.rows_sort_partition`` (the sort route's torch ops, here on the
    CPU) fills the scratch as the one-CTA partition does: the sorted rows,
    min(n, E) + 1 run starts, the run targets and the run count."""
    index, n = _partition_index(name)
    e = index.shape[0]
    cap = min(n, e)
    plan = ops.rows_plan(e, n, 2_048, torch.float32, torch.from_numpy(index).dtype, 16)
    perm, starts, targets = replay_partition(index, n, plan)
    scratch = torch.full((e + 2 * (cap + 1) + 1,), -7, dtype=torch.int32)
    ops.rows_sort_partition(torch.from_numpy(index), n, scratch)
    got = scratch.numpy()
    runs = len(targets)
    assert got[-1] == runs
    assert np.array_equal(got[:len(perm)], perm)
    assert np.array_equal(got[e:e + runs + 1], starts)
    assert np.array_equal(got[e + cap + 1:e + cap + 1 + runs], targets)


def replay_scan(index, t, plan):
    """The rows the scan route's CTA of target ``t`` adds, in its order:
    rounds of ROWS_SCAN_ITEMS · threads index rows, each compacted by its
    warps' ballot counts in (item, warp, lane) order."""
    e, threads = index.shape[0], plan.threads
    warps = threads // WARP
    below = (np.uint64(1) << np.arange(WARP, dtype=np.uint64)) - np.uint64(1)
    chain = []
    for base in range(0, e, ops.ROWS_SCAN_ITEMS * threads):
        r = base + np.arange(ops.ROWS_SCAN_ITEMS)[:, None] * threads + np.arange(threads)
        hit = (r < e) & (index[np.minimum(r, e - 1)].astype(np.int64) == t)
        m = _ballot(hit.reshape(ops.ROWS_SCAN_ITEMS, warps, WARP))
        counts = _popc(m)
        at = (np.cumsum(counts.reshape(-1)) - counts.reshape(-1)).reshape(counts.shape)
        lanes = hit.reshape(ops.ROWS_SCAN_ITEMS, warps, WARP)
        found = int(counts.sum())
        lst = np.full(found, -1, np.int64)
        i_, w_, l_ = np.nonzero(lanes)
        pos = at[i_, w_] + _popc(m[i_, w_] & below[l_])
        assert (np.bincount(pos, minlength=found) == 1).all()
        lst[pos] = r.reshape(ops.ROWS_SCAN_ITEMS, warps, WARP)[i_, w_, l_]
        chain.extend(lst.tolist())
    return chain


SCANS = {
    "a decode step's combine": (1_024, 4, 7_168, "bfloat16", np.int64),
    "every row on one target": (4_096, 1, 33, "float32", np.int64),
    "int32, rows out of range both sides": (3_000, 6, 64, "float64", np.int32),
    "E = 1": (1, 1, 2_048, "float32", np.int64),
}


@pytest.mark.parametrize("case", SCANS)
def test_scan_route_replay_folds_as_np_add_at(case):
    """Each target's rows in the scan route's order are its rows in operand
    order, and folded in that order from out's value they equal np.add.at
    bit for bit."""
    e, n, width, dtype, index_dtype = SCANS[case]
    tdt, ndt = DTYPES[dtype]
    rng = np.random.default_rng(len(case))
    if case == "a decode step's combine":  # 4 tokens, 8 experts each, slots of 4
        index = np.full(e, n, index_dtype)
        index[rng.choice(e, 32, replace=False)] = np.repeat(np.arange(n), 8)
    elif case == "every row on one target":
        index = np.zeros(e, index_dtype)
    else:
        index = rng.integers(-3, n + 3, e).astype(index_dtype)
    plan = ops.rows_plan(e, n, width, tdt, torch.from_numpy(index).dtype, 16)
    assert plan.route == "scan" and plan.grid == n * plan.tiles
    source = (rng.normal(size=(e, width)) * 10.0 ** rng.integers(-3, 4, (e, 1))).astype(ndt)
    out = rng.normal(size=(n, width)).astype(ndt)
    got = out.copy()
    for t in range(n):
        chain = replay_scan(index, t, plan)
        assert chain == np.flatnonzero(index.astype(np.int64) == t).tolist()
        for row in chain:
            got[t] = got[t] + source[row]
    want = _add_at(out, index.astype(np.int64), source)
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("rows", [0, 1, 2, 7, 8, 9, 10, 17, 1_000])
def test_fold_ring_reads_each_row_from_its_slot_and_refills_only_read_slots(rows):
    """``fold_chain``'s ring: kAhead rows staged ahead, one commit group a
    row; row r is read from the slot it was staged in after its group has
    landed (wait_group kAhead - 1), and the slot refilled in iteration r is
    the one read in iteration r - 1, never one still to be read."""
    ahead = ops.ROWS_AHEAD
    slots_n = ahead + 1
    slots, groups, read_at = {}, [], {}
    for k in range(ahead):
        if k < rows:
            slots[k] = k
        groups.append(k if k < rows else None)
    slot, fill = 0, ahead
    for r in range(rows):
        landed = len(groups) - (ahead - 1)  # groups complete in order
        assert r in groups[:landed] and slots[slot] == r
        read_at[slot] = r
        if r + ahead < rows:
            assert fill != slot and read_at.get(fill, -1) in (r - 1, -1)
            assert all(slots.get(fill) != q for q in range(r + 1, rows))
            slots[fill] = r + ahead
        groups.append(r + ahead if r + ahead < rows else None)
        slot = (slot + 1) % slots_n
        fill = (fill + 1) % slots_n
    assert sorted(read_at.values()) == list(range(max(rows - slots_n, 0), rows))
