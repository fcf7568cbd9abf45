"""The arithmetic of ``csrc/ordered_scatter.cu``, replayed in numpy on the
CPU, against ``np.argsort(kind="stable")`` and ``np.add.at``, bit for bit.

The kernel partitions the rows stably by target and folds each target's
rows in order.  Its partition is index arithmetic that no CPU run reaches:
per-warp target counts and each warp's kept rows compacted in order, the
block totals target-major with each warp's exclusive prefix, a one-block
exclusive scan in rounds, and the placement of each kept row at its
(target, chunk) start + its warp's prefix + the rows of its target the
warp has placed + its rank among the lanes of its 32-row step of the
compacted list with the same target (one ballot for each bit in which the
step's targets differ).  The fold copies each target's rows
through a ring of stages as 16-byte-aligned windows.  The replay below is
that arithmetic at the kernel's chunk and warp sizes (``ops.scatter_plan``);
the partition must be the stable argsort of the kept rows' targets, and the
fold through the modelled windows must equal ``np.add.at``.  The port's
plain version (``ops.ordered_scatter_add`` on CPU tensors, and
``ref.ordered_scatter_add``) is held to ``np.add.at`` on the same cases.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # small streams: more threads only contend with the other test workers

from repro_torch.kernels import ops, ref  # noqa: E402

WARP = 32
SCAN_ROUND = 1_024 * 8  # kScanRound: kScanThreads · kScanItems
STAGE_BYTES = 16 * 1_024  # kStageBytes
COUNTER_BYTES = 48 * 1_024  # kCounterBytes

SUBNORMALS_64 = np.array([5e-324, -5e-324, 4e-320, -2.5e-310, 0.0, -0.0, 1e-300, -1e-300])
SUBNORMALS_32 = np.array([1e-45, -1e-45, 3e-41, -1.1e-38, 0.0, -0.0, 1e-30, -1e-30], np.float32)


def _stream(rng, e, n, width, dtype, idx_dtype, *, drop=0.05, lo=None, hi=None):
    """(index, source, init): targets in [lo, hi) (dropped ones outside
    0..n-1 mixed in at rate ``drop``), values over eight decades."""
    lo = -2 if lo is None else lo
    hi = n + 2 if hi is None else hi
    idx = rng.integers(0, n, e)
    out_of_range = rng.random(e) < drop
    idx = np.where(out_of_range, rng.choice([lo, -1, n, hi - 1], e), idx).astype(idx_dtype)
    src = (rng.uniform(-3, 5, (e, width)) * 10.0 ** rng.integers(-4, 5, (e, 1))).astype(dtype)
    init = rng.uniform(-1, 1, (n, width)).astype(dtype)
    return idx, src, init


def _fused_test_streams():
    """The two streams the fused epoch's test file drew, in its order, from
    one generator: float32 rows of 1 and float64 rows of 3 into 24."""
    rng = np.random.default_rng(0)
    streams = []
    for dtype, width in ((np.float32, 1), (np.float64, 3)):
        idx = rng.integers(-2, 26, 50_000)
        src = (rng.uniform(-3, 5, (50_000, width)) * 10.0 ** rng.integers(-4, 5, (50_000, 1))
               ).astype(dtype)
        streams.append((idx, src, rng.uniform(-1, 1, (24, width)).astype(dtype)))
    return streams


def _case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "float32 W=1 (the fused test)":
        return _fused_test_streams()[0]
    if name == "float64 W=3 (the fused test)":
        return _fused_test_streams()[1]
    if name == "every row dropped":
        idx = rng.choice(np.array([-1, -7, 24, 2**40], np.int64), 40_000)
        return idx, rng.uniform(-1, 1, (40_000, 1)).astype(np.float32), \
            rng.uniform(-1, 1, (24, 1)).astype(np.float32)
    if name == "one target holds every row":
        idx = np.full(60_000, 5, np.int32)
        return idx, rng.uniform(-1, 1, (60_000, 1)).astype(np.float32), \
            np.zeros((24, 1), np.float32)
    if name == "255 targets, int32":
        return _stream(rng, 70_000, 255, 1, np.float32, np.int32)
    if name == "255 targets, int64 past int32":
        idx, src, init = _stream(rng, 70_000, 255, 3, np.float64, np.int64)
        far = rng.random(70_000) < 0.02  # low 32 bits in range: dropped only if read as int64
        idx = np.where(far, (np.int64(1) << 33) + idx % 255, idx)
        return idx, src, init
    if name == "E not a multiple of the chunk":
        return _stream(rng, 2_048 * 3 + 77, 24, 1, np.float32, np.int32)
    if name == "W=8 float64, int64":
        return _stream(rng, 30_000, 8, 8, np.float64, np.int64)
    if name == "W=3 float64 from float32 rows":
        idx, src, init = _stream(rng, 30_000, 8, 3, np.float32, np.int64)
        return idx, src, init.astype(np.float64)
    if name == "W=1 float32 from float64 rows":
        idx, src, init = _stream(rng, 30_000, 24, 1, np.float64, np.int32)
        return idx, src, init.astype(np.float32)
    if name == "float64 with ±0.0 and subnormals":
        idx, _, _ = _stream(rng, 40_000, 8, 3, np.float64, np.int64)
        src = rng.choice(SUBNORMALS_64, (40_000, 3))
        init = rng.choice(np.array([0.0, -0.0, 5e-324, -5e-324]), (8, 3))
        return idx, src, init
    if name == "float32 with ±0.0 and subnormals":
        idx, _, _ = _stream(rng, 40_000, 24, 1, np.float32, np.int32)
        src = rng.choice(SUBNORMALS_32, (40_000, 1))
        return idx, src, rng.choice(np.array([0.0, -0.0], np.float32), (24, 1))
    if name == "12,288 targets: one warp a block, two scan rounds":
        return _stream(rng, 5_000, 12_288, 1, np.float32, np.int32)
    raise KeyError(name)


CASES = (
    "float32 W=1 (the fused test)", "float64 W=3 (the fused test)", "every row dropped",
    "one target holds every row", "255 targets, int32", "255 targets, int64 past int32",
    "E not a multiple of the chunk", "W=8 float64, int64", "W=3 float64 from float32 rows",
    "W=1 float32 from float64 rows", "float64 with ±0.0 and subnormals",
    "float32 with ±0.0 and subnormals", "12,288 targets: one warp a block, two scan rounds",
)


# ---------------------------------------------------------------------------
# the kernel's arithmetic
# ---------------------------------------------------------------------------


def _ballot(pred):
    """(..., 32) bool -> (...) uint64 mask, lane l at bit l."""
    return (pred.astype(np.uint64) << np.arange(WARP, dtype=np.uint64)).sum(-1, dtype=np.uint64)


def _popc(x):
    """Set bits of each 32-bit mask (SWAR, as __popc)."""
    x = x.astype(np.uint64)
    x = x - ((x >> np.uint64(1)) & np.uint64(0x55555555))
    x = (x & np.uint64(0x33333333)) + ((x >> np.uint64(2)) & np.uint64(0x33333333))
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F)
    return (((x * np.uint64(0x01010101)) & np.uint64(0xFFFFFFFF)) >> np.uint64(24)).astype(np.int64)


def _targets(index, n, plan):
    """(chunks, warps, sub) targets of each warp's rows (-1: dropped or past
    E), the index read in place and compared before any narrowing."""
    e = index.shape[0]
    wide = index.astype(np.int64)
    t = np.where((wide >= 0) & (wide < n), wide, -1)
    cover = plan.chunks * plan.warps * plan.sub
    assert cover >= e and plan.sub % WARP == 0
    return np.concatenate([t, np.full(cover - e, -1)]).reshape(plan.chunks, plan.warps, plan.sub)


def _peers(t):
    """(..., 32) targets -> the kept lanes of each lane's step with its
    target (0 for a dropped lane), as ``peers_of``: one ballot for each bit
    in which the kept lanes' targets differ."""
    kept = t >= 0
    u = np.where(kept, t, 0).astype(np.uint64)
    any_ = np.bitwise_or.reduce(u, -1, keepdims=True)
    all_ = np.bitwise_and.reduce(np.where(kept, u, np.uint64(2**WARP - 1)), -1, keepdims=True)
    varying = any_ ^ all_
    full = np.uint64(2**WARP - 1)
    peers = np.where(kept, _ballot(kept)[..., None], np.uint64(0))
    for b in range(WARP):  # only the varying bits narrow the mask
        bit = ((u >> np.uint64(b)) & np.uint64(1)).astype(bool)
        ones = _ballot(bit)[..., None]
        narrow = ((varying >> np.uint64(b)) & np.uint64(1)).astype(bool)
        peers = np.where(narrow, peers & np.where(bit, ones, ~ones & full), peers)
    return peers


def replay_partition(index, n, plan):
    """(rows, offsets): the source row placed at each position, and each
    target's first position (offsets[n] the kept total), as the count, scan
    and place kernels compute them."""
    t = _targets(index, n, plan)
    chunks, warps, sub = t.shape
    kept = t >= 0
    # 1. count: each warp's counters, its exclusive prefix, block totals;
    #    each warp's kept rows compacted in order into its own region
    counters = np.zeros((chunks, warps, n), np.int64)
    c_, w_, r_ = np.nonzero(kept)
    np.add.at(counters, (c_, w_, t[c_, w_, r_]), 1)
    wprefix = np.cumsum(counters, 1) - counters
    counts = counters.sum(1).T.reshape(-1)  # target-major: counts[t * chunks + c]
    at = np.cumsum(kept, 2) - kept  # found + popc(kept & below), step by step
    crow = np.zeros((chunks, warps, sub), np.int64)
    ctgt = np.full((chunks, warps, sub), -1)
    row_id = np.arange(chunks * warps * sub).reshape(t.shape)
    crow[c_, w_, at[kept]] = row_id[kept]
    ctgt[c_, w_, at[kept]] = t[kept]
    assert (np.count_nonzero(ctgt >= 0, 2) == kept.sum(2)).all()
    # 2. scan: one block, rounds of SCAN_ROUND counts, a carry between them
    starts = np.empty_like(counts)
    offsets = np.zeros(n + 1, np.int64)
    carry = 0
    for base in range(0, counts.size, SCAN_ROUND):
        part = counts[base:base + SCAN_ROUND]
        starts[base:base + part.size] = carry + np.cumsum(part) - part
        carry += int(part.sum())
    offsets[:n] = starts[np.arange(n) * chunks]
    offsets[n] = carry
    # 3. place: each warp walks its compacted list, 32 a step, all warps at once
    steps = sub // WARP
    ts = ctgt.reshape(chunks, warps, steps, WARP)
    rs = crow.reshape(chunks, warps, steps, WARP)
    peers = _peers(ts)
    below = (np.uint64(1) << np.arange(WARP, dtype=np.uint64)) - np.uint64(1)
    rank, size = _popc(peers & below), _popc(peers)
    lead = (ts >= 0) & ((peers & below) == 0)
    placed = starts.reshape(n, chunks).T[:, None, :] + wprefix  # (chunks, warps, n)
    rows = np.full(max(carry, 1), -1, np.int64)
    shape = (chunks, warps, WARP)
    ci = np.broadcast_to(np.arange(chunks)[:, None, None], shape)
    wi = np.broadcast_to(np.arange(warps)[None, :, None], shape)
    for s in range(steps):
        tt, keep, ld = ts[:, :, s], ts[:, :, s] >= 0, lead[:, :, s]
        pos = np.take_along_axis(placed, np.maximum(tt, 0), 2) + rank[:, :, s]
        assert (rows[pos[keep]] == -1).all(), "two rows placed at one position"
        rows[pos[keep]] = rs[:, :, s][keep]
        np.add.at(placed, (ci[ld], wi[ld], tt[ld]), size[:, :, s][ld])
    return rows[:carry], offsets


def replay_fold(part, offsets, init):
    """``init`` with each target's rows of ``part`` added in order, read
    through the fold kernel's stage windows."""
    out = init.copy()
    n, width = init.shape
    v = 16 // part.itemsize
    per = STAGE_BYTES // part.itemsize // width * width  # kStage: whole rows
    room = (per + 3 * v - 1) // v * v  # kSlot: a ring slot
    for t in range(n):
        lo, hi = int(offsets[t]) * width, int(offsets[t + 1]) * width
        for g0 in range(lo, hi, per):
            g1 = min(g0 + per, hi)
            a0, a1 = g0 // v * v, -(-g1 // v) * v
            assert a1 <= part.size and a1 - a0 <= room
            slot = part[a0:a1]
            rows = (g1 - g0) // width
            for c in range(width):
                chain = slot[g0 - a0 + c:g0 - a0 + c + rows * width:width]
                out[t, c] = np.add.accumulate(np.concatenate([out[t, c:c + 1], chain]))[-1]
    return out


def _expected(index, source, init):
    n = init.shape[0]
    keep = (index.astype(np.int64) >= 0) & (index.astype(np.int64) < n)
    want = init.copy()
    np.add.at(want, index[keep].astype(np.int64), source[keep].astype(init.dtype))
    return want, keep


@pytest.mark.parametrize("name", CASES)
def test_partition_replay_is_a_stable_argsort(name):
    """The replayed count, scan and place kernels put every kept row, and
    only those, where a stable sort by target puts it; each target's offset
    is its first row there."""
    index, source, init = _case(name)
    n = init.shape[0]
    plan = ops.scatter_plan(index.shape[0], n)
    assert plan.warps * n * 4 <= COUNTER_BYTES
    rows, offsets = replay_partition(index, n, plan)
    _, keep = _expected(index, source, init)
    kept = np.flatnonzero(keep)
    want = kept[np.argsort(index[kept].astype(np.int64), kind="stable")]
    np.testing.assert_array_equal(rows, want)
    counts = np.bincount(index[kept].astype(np.int64), minlength=n)
    np.testing.assert_array_equal(offsets, np.concatenate([[0], np.cumsum(counts)]))


@pytest.mark.parametrize("name", CASES)
def test_ordered_scatter_add_matches_numpy_add_at(name):
    """The replayed fold over the replayed partition, the wrapper's plain
    version and ``ref.ordered_scatter_add`` all add in operand order:
    np.add.at, bit for bit, rows out of range dropped, continuing from the
    values already there, a float64 row converted into a float32 out as
    PyTorch converts it."""
    index, source, init = _case(name)
    n, width = init.shape
    want, _ = _expected(index, source, init)
    rows, offsets = replay_partition(index, n, ops.scatter_plan(index.shape[0], n))
    # the partition buffer as the wrapper sizes it; positions never written hold NaN
    part = np.full(index.shape[0] * width + 16 // init.itemsize, np.nan, init.dtype)
    part[:rows.size * width] = source[rows].astype(init.dtype).reshape(-1)
    assert replay_fold(part, offsets, init).tobytes() == want.tobytes()
    got = ops.ordered_scatter_add(torch.from_numpy(init.copy()), torch.from_numpy(index),
                                  torch.from_numpy(source))
    assert got.numpy().tobytes() == want.tobytes()
    assert ref.ordered_scatter_add(torch.from_numpy(init.copy()), torch.from_numpy(index),
                                   torch.from_numpy(source)).numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("e, n", [
    (4_800_576, 24), (300_000, 8), (100_000, 8), (1_000_000, 1), (1_000_000, 255),
    (1, 1), (5_000, 12_288), (4_800_576, 256),
])
def test_scatter_plan(e, n):
    """The plan covers every row in whole 256-row steps a warp, keeps a
    block's counters in 48 KB, fills the card where the rows allow, and
    gives the scan two rounds at most where the rounding to whole steps
    allows."""
    plan = ops.scatter_plan(e, n)
    assert plan.sub % ops.SCATTER_STEP == 0
    assert plan.chunks * plan.warps * plan.sub >= e > (plan.chunks - 1) * plan.warps * plan.sub
    assert plan.warps * n * 4 <= COUNTER_BYTES and 1 <= plan.warps <= 8
    assert plan.chunks <= ops.SCATTER_CHUNKS
    if plan.sub > ops.SCATTER_STEP and n <= 256:
        assert n * plan.chunks <= ops.SCATTER_STARTS == 2 * SCAN_ROUND


REJECTED = {  # case: (out shape, out dtype, index dtype, exception)
    "9 columns": ((24, 9), torch.float32, torch.int32, ValueError),
    "12,289 targets": ((12_289,), torch.float32, torch.int32, ValueError),
    "a float index": ((24,), torch.float32, torch.float32, TypeError),
    "an int32 out": ((24,), torch.int32, torch.int32, TypeError),
}


@pytest.mark.parametrize("case", list(REJECTED))
def test_wrapper_rejects_what_the_kernel_cannot_take(case):
    """On (fake) CUDA tensors the wrapper raises before any launch on what
    the kernel does not take; the plan refuses 0 and 12,289 targets."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    shape, out_dtype, index_dtype, error = REJECTED[case]
    with FakeTensorMode():
        out = torch.zeros(shape, dtype=out_dtype, device="cuda")
        index = torch.zeros(100, dtype=index_dtype, device="cuda")
        source = torch.zeros((100, *shape[1:]), device="cuda")
        with pytest.raises(error):
            ops.ordered_scatter_add(out, index, source)
    with pytest.raises(ValueError):
        ops.scatter_plan(10, 0 if case == "9 columns" else 12_289)


def test_wrapper_launches_nothing_without_rows_or_targets():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        for n, e in ((24, 0), (0, 100)):
            out = torch.zeros(n, device="cuda")
            assert ops.scatter_args(out, torch.zeros(e, dtype=torch.int32, device="cuda"),
                                    torch.zeros(e, device="cuda")) is None
