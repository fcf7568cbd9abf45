"""The port's MarketBook against the live reference's, operation for operation.

Contract: fed the same seeded interleaving of upserts (raw and pre-packed),
removes and capacity doublings, the two books stay bit-identical in their
host arrays (idx, val, mask, pi), both float64 ledgers, ``supply_scale``,
``export_state`` and ``export_dirty_state``; the port's device mirror, kept
by in-place row writes and read as the K-padded book, holds the numbers of
the reference's CSR mirror, kept by ``_csr_apply_row_deltas``; and
``parity_check`` (the full-repack oracle) passes and catches a corrupted
row.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny books: more threads only contend with the other test workers

from repro.core.types import MarketBook as JBook  # noqa: E402
from repro_torch.core import CSRAuctionProblem, MarketBook, csr_padded_views  # noqa: E402

R, B, K = 6, 3, 4
BASE = np.linspace(1.0, 2.0, R).astype(np.float32)


def _raw(rng):
    """A random raw submission: 1..B bundles of 1..K (idx, val) pairs,
    buys and sells, pools possibly repeated."""
    nb = int(rng.integers(1, B + 1))
    bundles = []
    for _ in range(nb):
        n = int(rng.integers(1, K + 1))
        idx = rng.integers(0, R, n).astype(np.int32)
        val = (rng.uniform(-3, 5, n) * rng.choice([1.0, 0.25], n)).astype(np.float32)
        bundles.append((idx, val))
    return bundles, rng.uniform(0.5, 20.0, nb).astype(np.float32)


def _packed(rng, n):
    """n pre-packed rows in the export_bid_rows layout."""
    idx = rng.integers(0, R, (n, B, K)).astype(np.int32)
    val = rng.uniform(0, 4, (n, B, K)).astype(np.float32)
    mask = rng.random((n, B)) < 0.7
    mask[:, 0] = True
    pi = np.where(mask, rng.uniform(1, 30, (n, B)), 0.0).astype(np.float32)
    val = np.where(mask[:, :, None], val, 0.0).astype(np.float32)
    idx = np.where(mask[:, :, None], idx, 0).astype(np.int32)
    return idx, val, mask, pi


def _assert_books_equal(jb, pb, where):
    for name in ("idx", "val", "mask", "pi", "_ledger", "_sell_ledger"):
        a, b = getattr(jb, name), getattr(pb, name)
        assert a.dtype == b.dtype and np.array_equal(a, b), (where, name)
    assert np.array_equal(jb.supply_scale(), pb.supply_scale()), where
    assert np.array_equal(jb.offered_supply(), pb.offered_supply()), where
    assert jb._key_slot == pb._key_slot and jb._free == pb._free, where
    ja, jm = jb.export_state()
    pa, pm = pb.export_state()
    assert jm == pm, where
    assert ja.keys() == pa.keys(), where
    for k in ja:
        assert ja[k].dtype == pa[k].dtype and np.array_equal(ja[k], pa[k]), (where, k)


def _assert_dirty_equal(jb, pb, where):
    (ja, jm), (pa, pm) = jb.export_dirty_state(clear=True), pb.export_dirty_state(clear=True)
    assert jm == pm, where
    assert ja.keys() == pa.keys(), where
    for k in ja:
        assert ja[k].dtype == pa[k].dtype and np.array_equal(ja[k], pa[k]), (where, k)


def _assert_mirrors_equal(jb, pb, where):
    """The port's padded mirror, flattened, is the reference's CSR mirror,
    whose offsets are the fixed-K ladder."""
    jp, pp = jb.device_problem(), pb.device_padded_problem()
    assert np.array_equal(np.asarray(jp.offsets), np.arange(jb.rows_cap * B + 1) * K), where
    for f in ("idx", "val", "bundle_mask", "pi", "supply_scale", "base_cost"):
        a = np.asarray(getattr(jp, f))
        b = getattr(pp, f).numpy().reshape(a.shape)
        assert a.dtype == b.dtype and np.array_equal(a, b), (where, f)
    assert np.array_equal(pp.idx.numpy().reshape(-1), pb.idx)
    assert np.array_equal(pp.pi.numpy(), pb.pi)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_interleaving_matches_reference_bit_for_bit(seed):
    rng = np.random.default_rng(seed)
    jb, pb = JBook(BASE, B, K, rows_cap=4), MarketBook(BASE, B, K, rows_cap=4, device="cpu")
    live: list[str] = []
    n_keys = 0
    for step in range(60):
        op = rng.random()
        if op < 0.4 or not live:
            if live and rng.random() < 0.3:
                key = live[int(rng.integers(len(live)))]  # an update of a live row
            else:
                key, n_keys = f"k{n_keys}", n_keys + 1
                live.append(key)
            bundles, pi = _raw(rng)
            jb.upsert(key, bundles, pi)
            pb.upsert(key, bundles, pi)
        elif op < 0.7:
            n = int(rng.integers(1, 6))
            keys = [f"p{n_keys + i}" for i in range(n)]
            n_keys += n
            rows = _packed(rng, n)
            jb.upsert_rows(keys, *rows)
            pb.upsert_rows(keys, *rows)
            live += keys
        else:
            key = live.pop(int(rng.integers(len(live))))
            assert jb.remove(key) and pb.remove(key)
        assert jb.rows_cap == pb.rows_cap
        _assert_books_equal(jb, pb, (seed, step))
        if step % 7 == 6:
            _assert_dirty_equal(jb, pb, (seed, step))
    assert pb.rows_cap >= 32  # the book doubled from 4 along the way
    pb.parity_check()
    jb.parity_check()


def test_row_writes_equal_csr_apply_row_deltas():
    """Each sync of the port's mirror (in-place row writes of the dirty
    slots) equals the reference's donated scatter, across syncs, removes
    and a capacity doubling (full re-upload)."""
    rng = np.random.default_rng(5)
    jb, pb = JBook(BASE, B, K, rows_cap=16), MarketBook(BASE, B, K, rows_cap=16, device="cpu")
    keys = [f"a{i}" for i in range(12)]
    rows = _packed(rng, 12)
    jb.upsert_rows(keys, *rows)
    pb.upsert_rows(keys, *rows)
    _assert_mirrors_equal(jb, pb, "first upload")
    for sync in range(5):
        for key in rng.choice(keys, size=3, replace=False):
            bundles, pi = _raw(rng)
            jb.upsert(str(key), bundles, pi)
            pb.upsert(str(key), bundles, pi)
        gone = keys.pop(int(rng.integers(len(keys))))
        jb.remove(gone)
        pb.remove(gone)
        if sync == 3:  # grow past 16 slots: the mirror is uploaded anew
            new = [f"g{i}" for i in range(10)]
            more = _packed(rng, 10)
            jb.upsert_rows(new, *more)
            pb.upsert_rows(new, *more)
            keys += new
        _assert_mirrors_equal(jb, pb, f"sync {sync}")
    assert pb.rows_cap == 32


def test_padded_view_is_the_csr_gather():
    """The port's in-place padded view is what ``csr_padded_views`` gathers
    from the reference's CSR view of the same book."""
    rng = np.random.default_rng(9)
    jb, pb = JBook(BASE, B, K, rows_cap=8), MarketBook(BASE, B, K, rows_cap=8, device="cpu")
    rows, raw = _packed(rng, 7), _raw(rng)
    for book in (jb, pb):
        book.upsert_rows([f"a{i}" for i in range(7)], *rows)
        book.upsert("raw", *raw)
        book.remove("a3")
    jp = jb.device_problem()
    csr = CSRAuctionProblem(
        **{f: torch.from_numpy(np.asarray(getattr(jp, f))) for f in (
            "idx", "val", "rows", "offsets", "bundle_mask", "pi", "base_cost", "supply_scale")},
        num_resources=jp.num_resources, k_bound=jp.k_bound)
    idx, val = csr_padded_views(csr)
    padded = pb.device_padded_problem()
    assert torch.equal(padded.idx, idx) and torch.equal(padded.val, val)
    assert torch.equal(padded.bundle_mask, torch.from_numpy(pb.mask))


def test_parity_check_catches_a_corrupted_row():
    rng = np.random.default_rng(3)
    pb = MarketBook(BASE, B, K, device="cpu")
    pb.upsert_rows([f"a{i}" for i in range(5)], *_packed(rng, 5))
    pb.upsert("raw", *_raw(rng))
    pb.parity_check()
    pb.val[pb._key_slot["a2"] * B * K] += 1.0
    with pytest.raises(AssertionError, match="diverged"):
        pb.parity_check()


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_state_and_dirty_records_cross_packages(direction):
    """export_state / from_state and export_dirty_state / apply_dirty_state
    carry a book from either package into the other, bit for bit."""
    rng = np.random.default_rng(11)
    src = JBook(BASE, B, K, rows_cap=4) if direction == "reference_to_port" else \
        MarketBook(BASE, B, K, rows_cap=4, device="cpu")

    def restore(arrays, meta):
        if direction == "reference_to_port":
            return MarketBook.from_state(arrays, meta, device="cpu")
        return JBook.from_state(arrays, meta)

    src.upsert_rows([f"a{i}" for i in range(6)], *_packed(rng, 6))
    src.upsert("raw0", *_raw(rng))
    base = restore(*src.export_state(clear_dirty=True))
    src.remove("a1")
    src.upsert("raw1", *_raw(rng))
    src.upsert_rows([f"b{i}" for i in range(5)], *_packed(rng, 5))  # grows to 16
    base.apply_dirty_state(*src.export_dirty_state(clear=True))
    _assert_books_equal(src, base, direction)
    base.parity_check()
