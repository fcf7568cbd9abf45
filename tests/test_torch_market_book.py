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


def _assert_dirty_equal(jb, pb, where, clear=True):
    """Both books' dirty records are equal; returns them."""
    (ja, jm), (pa, pm) = jb.export_dirty_state(clear=clear), pb.export_dirty_state(clear=clear)
    assert jm == pm, where
    assert ja.keys() == pa.keys(), where
    for k in ja:
        assert ja[k].dtype == pa[k].dtype and np.array_equal(ja[k], pa[k]), (where, k)
    return (ja, jm), (pa, pm)


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


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_columnar_encoding_is_the_reference_encoding(seed):
    """A seeded interleaving of raw upserts, packed upserts, the service's
    drain (packed rows carrying their raw accounts), removes with LIFO slot
    reuse, capacity doublings, delta replays onto a replica and restores,
    through the port's book and the reference's alike: after every step
    both exporters of the writer and of the replica equal the reference
    twin's, and both books pass ``parity_check``."""
    rng = np.random.default_rng(seed)
    book, twin = MarketBook(BASE, B, K, rows_cap=2, device="cpu"), JBook(BASE, B, K, rows_cap=2)
    replica = MarketBook.from_state(*book.export_state(clear_dirty=True), device="cpu")
    twin_replica = JBook.from_state(*twin.export_state(clear_dirty=True))
    live: list = []
    n_keys = reused = 0

    def fresh_keys(n):
        nonlocal n_keys
        # str and int keys alike: both are JSON-serializable
        keys = [f"k{n_keys + i}" if (n_keys + i) % 3 else n_keys + i for i in range(n)]
        n_keys += n
        return keys

    def some_keys(n):
        """Up to n keys: live ones (updates, of either kind) and new ones."""
        old = [live[i] for i in rng.permutation(len(live))[: int(rng.integers(0, n + 1))]]
        return old + fresh_keys(n - len(old))

    for step in range(80):
        free = set(book._free)
        op = rng.random()
        if op < 0.25 or not live:
            (key,) = some_keys(1)
            acct = _raw(rng)
            for b in (book, twin):
                b.upsert(key, *acct)
        elif op < 0.45:
            keys = some_keys(int(rng.integers(1, 6)))
            rows = _packed(rng, len(keys))
            for b in (book, twin):
                b.upsert_rows(keys, *rows)
        elif op < 0.65:
            keys = some_keys(int(rng.integers(1, 6)))
            raw = [_raw(rng) for _ in keys]
            rows = [book._pack_row(*acct) for acct in raw]
            for b in (book, twin):
                b.upsert_rows(keys, *(np.stack(a) for a in zip(*rows)), raw=raw)
        else:
            for key in [live[i] for i in rng.permutation(len(live))[: int(rng.integers(1, 4))]]:
                assert book.remove(key) and twin.remove(key)
        live = [book._slot_key[s] for s in range(book._next_slot) if book._slot_key[s] is not None]
        reused += len(free - set(book._free))
        _assert_books_equal(twin, book, (seed, step))
        records = _assert_dirty_equal(twin, book, (seed, step), clear=step % 5 == 4)
        if step % 5 == 4:
            twin_replica.apply_dirty_state(*records[0])
            replica.apply_dirty_state(*records[1])
            _assert_books_equal(twin_replica, replica, (seed, step, "replica"))
            _assert_books_equal(book, replica, (seed, step))
        if step % 23 == 22:  # the writer and the replica restart from a full record
            state, twin_state = book.export_state(clear_dirty=True), twin.export_state(
                clear_dirty=True)
            book, replica = (MarketBook.from_state(*state, device="cpu") for _ in range(2))
            twin, twin_replica = (JBook.from_state(*twin_state) for _ in range(2))
            _assert_books_equal(twin, book, (seed, step, "restored"))
    assert book.rows_cap >= 16 and reused > 0  # doubled from 2; freed slots taken again
    book.parity_check()
    replica.apply_dirty_state(*book.export_dirty_state(clear=True))
    replica.parity_check()
    _assert_books_equal(book, replica, (seed, "end"))


def test_export_raises_for_a_key_json_cannot_hold():
    """A non-JSON key is accepted by a write and refused by both exporters
    with the reference book's TypeError; once withdrawn, the book exports."""
    rng = np.random.default_rng(4)
    book, twin = MarketBook(BASE, B, K, device="cpu"), JBook(BASE, B, K)
    odd = frozenset({"not", "json"})
    rows, acct, other = _packed(rng, 2), _raw(rng), _raw(rng)
    for b in (book, twin):
        b.upsert_rows(["a", "b"], *rows)
        b.upsert(odd, *acct)
        b.upsert("c", *other)
    with pytest.raises(TypeError) as reference:
        twin.export_state()
    with pytest.raises(TypeError) as full:
        book.export_state()
    with pytest.raises(TypeError) as dirty:
        book.export_dirty_state(clear=False)
    assert str(full.value) == str(dirty.value) == str(reference.value)
    assert "not JSON-serializable" in str(full.value)
    assert book.remove(odd) and twin.remove(odd)
    _assert_books_equal(twin, book, "withdrawn")
    _assert_dirty_equal(twin, book, "withdrawn")
    book.parity_check()


def test_a_raw_account_past_the_book_is_refused_where_written():
    """The service's drain path checks each raw account against B and K
    before it writes: a refused batch leaves the book as it was."""
    rng = np.random.default_rng(6)
    book = MarketBook(BASE, B, K, device="cpu")
    book.upsert_rows(["a"], *_packed(rng, 1))
    before = book.export_state()
    fits = _raw(rng)
    too_many = ([(np.array([0], np.int32), np.array([1.0], np.float32))] * (B + 1), 1.0)
    too_long = ([(np.arange(K + 1, dtype=np.int32) % R, np.ones(K + 1, np.float32))], 1.0)
    for bad in (too_many, too_long):
        with pytest.raises(ValueError):
            book.upsert_rows(["b", "c"], *_packed(rng, 2), raw=[fits, bad])
        after = book.export_state()
        assert after[1] == before[1] and len(book) == 1 and "b" not in book
        for k, v in before[0].items():
            assert np.array_equal(after[0][k], v), k
    book.parity_check()


@pytest.mark.parametrize("where", ["in_an_account", "past_its_pairs"])
def test_parity_check_catches_a_corrupted_account_column(where):
    """The book's one account store, its encoding columns, is held to the
    slot arrays through the repack: a corrupt pair shows in the slot arrays,
    a stray value past a raw account's pairs in the columns themselves."""
    rng = np.random.default_rng(8)
    pb = MarketBook(BASE, B, K, device="cpu")
    pb.upsert_rows([f"a{i}" for i in range(4)], *_packed(rng, 4))
    pb.upsert("raw", [(np.array([1, 0], np.int32), np.array([2.0, 1.0], np.float32))], 3.0)
    pb.parity_check()
    s = pb._key_slot["raw"]
    if where == "in_an_account":
        pb._cols["val"][s, 0] += 1.0
    else:
        pb._cols["idx"][s, 2] = 1
    with pytest.raises(AssertionError, match="diverged"):
        pb.parity_check()
