"""The port's service durability against the reference's, on the CPU.

* The write-ahead log: one record stream gives the same bytes in both
  packages, and each package replays the other's log, torn tail included.
* Checkpoints: a ``ServiceCheckpointer`` chain (full record plus dirty-row
  deltas) or a ``MarketCheckpointer`` record cut by either package restores
  in the other with equal books, stats and next ticks or epochs.
* ``ServiceConfig`` rejects the reference's bad values, read from the
  reference suite's own list.
* Hard kills: a durable port service killed (``os._exit``) in a subprocess
  mid-ingest, after the drain, after the settle and mid-commit, then resumed
  from disk, ends bit-identical to an uninterrupted port run.
"""
import dataclasses
import importlib.util
import os
import pickle
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny books: more threads only contend with the other test workers

import repro.checkpoint.market as jckpt  # noqa: E402
import repro.core.markets as jmarkets  # noqa: E402
import repro.serve as jserve  # noqa: E402
import repro.serve.market as jmarket  # noqa: E402
import repro.serve.wal as jwal  # noqa: E402
import repro_torch.checkpoint as tckpt  # noqa: E402
import repro_torch.core as pt  # noqa: E402
import repro_torch.serve as tserve  # noqa: E402
import repro_torch.serve.market as tmarket  # noqa: E402
import repro_torch.serve.wal as twal  # noqa: E402

TESTS = Path(__file__).resolve().parent
SRC = TESTS.parent / "src"
JAX = types.SimpleNamespace(
    fleet_economy=jmarkets.fleet_economy, ServiceConfig=jserve.ServiceConfig,
    MarketService=jmarket.MarketService, BidDelta=jmarket.BidDelta,
    submit_record=jmarket._submit_record, WriteAheadLog=jwal.WriteAheadLog,
    MarketCheckpointer=jckpt.MarketCheckpointer, device={},
)
PORT = types.SimpleNamespace(
    fleet_economy=pt.fleet_economy, ServiceConfig=tserve.ServiceConfig,
    MarketService=tmarket.MarketService, BidDelta=tmarket.BidDelta,
    submit_record=tmarket._submit_record, WriteAheadLog=twal.WriteAheadLog,
    MarketCheckpointer=tckpt.MarketCheckpointer, device={"device": "cpu"},
)
PACKAGES = {"reference": JAX, "port": PORT}
DIRECTIONS = [("reference", "port"), ("port", "reference")]
PAYMENT = ("gamma_median", "gamma_mean", "surplus", "value_of_trade", "compensation")


def _records(pkg):
    rng = np.random.default_rng(0)
    out = []
    for i in range(12):
        idx = rng.integers(0, 9, 3).astype(np.int32)
        val = rng.uniform(-2, 3, 3).astype(np.float32)
        out.append(pkg.submit_record(pkg.BidDelta(f"agent-{i}", [(idx, val), (idx[:1], val[:1])],
                                                  rng.uniform(1, 9, 2).astype(np.float32))))
        if i % 4 == 3:
            out.append(("withdraw", f"agent-{i - 1}"))
    out.append(pkg.submit_record(pkg.BidDelta("odd", "not a bundle list", 1.0)))
    return out


def _write_wal(pkg, path):
    wal = pkg.WriteAheadLog(str(path))
    for rec in _records(pkg):
        wal.append(rec)
    wal.reset()  # a compaction bumps the generation in the header
    offsets = [wal.append(rec) for rec in _records(pkg)]
    wal.close()
    return offsets


def test_wal_bytes_identical(tmp_path):
    assert _records(JAX) == _records(PORT)
    assert _write_wal(JAX, tmp_path / "j.wal") == _write_wal(PORT, tmp_path / "t.wal")
    assert (tmp_path / "j.wal").read_bytes() == (tmp_path / "t.wal").read_bytes()


@pytest.mark.parametrize("torn", ["header", "payload", "crc"])
@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_wal_replays_across_packages_torn_tail(tmp_path, writer, reader, torn):
    path = tmp_path / "w.wal"
    offsets = _write_wal(PACKAGES[writer], path)
    data = bytearray(path.read_bytes())
    end = offsets[-2]  # the last intact record ends here
    if torn == "header":
        data = data[: end + 5]
    elif torn == "payload":
        data = data[:-3]
    else:
        data[-1] ^= 0xFF
    path.write_bytes(bytes(data))
    wal = PACKAGES[reader].WriteAheadLog(str(path))
    assert wal.generation == 1 and wal.offset == end
    assert wal.recovered_records == len(offsets) - 1
    assert [r for r, _ in wal.records()] == _records(PORT)[:-1]
    wal.close()


def _bad_config_values():
    """The ``bad`` list of the reference's own config suite."""
    spec = importlib.util.spec_from_file_location(
        "reference_service_config_suite", TESTS / "test_service_config.py")
    suite = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(suite)
    (mark,) = [m for m in suite.test_invalid_values_rejected_at_config_time.pytestmark
               if m.name == "parametrize"]
    return mark.args[1]


@pytest.mark.parametrize("bad", _bad_config_values(), ids=repr)
def test_service_config_rejects_reference_bad_values(bad):
    with pytest.raises(ValueError):
        jserve.ServiceConfig(**bad)
    with pytest.raises(ValueError):
        tserve.ServiceConfig(**bad)


def _churn(pkg, eco, svc, t):
    rng = np.random.default_rng(100 + t)
    keys, idx, val, mask, pi = eco.export_bid_rows()
    live = np.flatnonzero(mask.any(axis=1))
    for j, i in enumerate(rng.choice(live, size=6, replace=False)):
        svc.submit(pkg.BidDelta(keys[i], [(idx[i, b], val[i, b]) for b in np.flatnonzero(mask[i])],
                                pi[i][mask[i]] * (0.85 + 0.05 * j)))
    svc.withdraw(keys[live[t]])


def _assert_stats(sa, sb, where):
    da, db = dataclasses.asdict(sa), dataclasses.asdict(sb)
    for k, va in da.items():
        vb = db[k]
        if k in PAYMENT:
            np.testing.assert_allclose(vb, va, rtol=1e-5, err_msg=f"{where} {k}")
        elif isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb), (where, k)
        else:
            assert va == vb or (va != va and vb != vb), (where, k, va, vb)


def _assert_services_equal(a, b, where):
    (aa, am), (ba, bm) = a.book.export_state(), b.book.export_state()
    assert am == bm, where
    for k in aa:
        assert np.array_equal(aa[k], ba[k]), (where, k)
    assert a.epoch == b.epoch and a.pending == b.pending, where
    assert dataclasses.asdict(a.health) == dataclasses.asdict(b.health), where
    assert len(a.price_history) == len(b.price_history), where
    for pa, pb in zip(a.price_history, b.price_history):
        assert np.array_equal(pa, pb), where
    assert len(a.stats_history) == len(b.stats_history), where
    for sa, sb in zip(a.stats_history, b.stats_history):
        _assert_stats(sa, sb, where)
    np.testing.assert_array_equal(a.reserve, b.reserve)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_service_checkpoint_chain_restores_across_packages(tmp_path, writer, reader):
    """Three committed ticks (a full record, then dirty-row deltas) and a
    tail of acknowledged, undrained deltas: the other package restores the
    chain, replays the WAL, and ticks on exactly as the writer does."""
    w, r = PACKAGES[writer], PACKAGES[reader]
    d = tmp_path / "w"
    cfg = dict(wal_path=str(d / "m.wal"), checkpoint_dir=str(d / "ck"),
               checkpoint_full_every=4)
    os.makedirs(d)
    eco_w = w.fleet_economy(40, 3, seed=2, **w.device)
    svc_w = w.MarketService.from_economy(eco_w, config=w.ServiceConfig(**cfg))
    for t in range(3):
        _churn(w, eco_w, svc_w, t)
        svc_w.tick()
    _churn(w, eco_w, svc_w, 3)  # journaled, not yet drained
    svc_w.flush()
    assert sorted(os.listdir(d / "ck")) == [f"ckpt_{0:08d}", *(f"delta_{s:08d}" for s in (1, 2, 3))]
    shutil.copytree(d, tmp_path / "r")
    rd = tmp_path / "r"
    eco_r = r.fleet_economy(40, 3, seed=2, **r.device)
    svc_r = r.MarketService.from_economy(eco_r, config=r.ServiceConfig(
        **{**cfg, "wal_path": str(rd / "m.wal"), "checkpoint_dir": str(rd / "ck")}))
    assert svc_r.restored_step == 3 and svc_r.replayed_records == 7
    _assert_services_equal(svc_w, svc_r, "restored")
    svc_r.book.parity_check()
    _assert_stats(svc_w.tick(), svc_r.tick(), "next tick")
    _assert_services_equal(svc_w, svc_r, "after the next tick")


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_market_checkpoint_restores_across_packages(tmp_path, writer, reader):
    w, r = PACKAGES[writer], PACKAGES[reader]
    eco_w = w.fleet_economy(120, 4, seed=5, warm_start=True, **w.device)
    for _ in range(2):
        eco_w.run_epoch()
    step = w.MarketCheckpointer(str(tmp_path)).save(eco_w)
    eco_r = r.fleet_economy(120, 4, seed=5, warm_start=True, **r.device)
    assert r.MarketCheckpointer(str(tmp_path)).restore_latest(eco_r) == step == 2
    for f in ("placed", "home", "fill_rate", "epoch"):
        np.testing.assert_array_equal(getattr(eco_w.pop, f), getattr(eco_r.pop, f))
    for epoch in range(2):
        _assert_stats(eco_w.run_epoch(), eco_r.run_epoch(), ("epoch", epoch))
    np.testing.assert_array_equal(eco_w.usage, eco_r.usage)
    np.testing.assert_array_equal(eco_w.belief, eco_r.belief)


# A three-tick workload on a durable port service (dropout faults, churn,
# withdrawals), killable at tick 1 through the service's crash-point hooks,
# resumable from the WAL + checkpoints, and runnable without them as the
# uninterrupted run.
_SCRIPT = """
import dataclasses, os, pickle, sys
import numpy as np
import torch
torch.set_num_threads(1)
from repro_torch.core import FaultModel, fleet_economy
from repro_torch.serve import ServiceConfig
from repro_torch.serve.market import BidDelta, MarketService

mode, point, seed, d = sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4]
TICKS, KILL_TICK = 3, 1
eco = fleet_economy(40, 3, seed=seed, device="cpu")
cfg = ServiceConfig()
if mode != "ref":
    cfg = cfg.replace(wal_path=os.path.join(d, "w.wal"), checkpoint_dir=os.path.join(d, "ck"))
svc = MarketService.from_economy(eco, config=cfg, faults=FaultModel(bid_dropout=0.2, seed=seed))
keys, idx, val, mask, pi = eco.export_bid_rows()
live = np.flatnonzero(mask.any(axis=1))

def batch(t):
    rng = np.random.default_rng(seed * 1000 + t)
    pick = rng.choice(live, size=8, replace=False)
    return [BidDelta(keys[i], [(idx[i, b], val[i, b]) for b in np.flatnonzero(mask[i])],
                     pi[i][mask[i]] * (0.9 + 0.02 * j)) for j, i in enumerate(pick)], keys[pick[0]]

if mode == "crash":
    seen = {"n": 0}
    def boom():
        if point == "mid_ingest":
            if svc.epoch == KILL_TICK:
                seen["n"] += 1
                if seen["n"] == 5:  # the 5th append of tick 1's batch, before its ack
                    os._exit(1)
        elif svc.epoch == (KILL_TICK + 1 if point == "mid_delta" else KILL_TICK):
            os._exit(1)
    svc._test_hooks[point] = boom

# the client re-issues every delta it never saw acknowledged: the resumed run
# re-submits the current tick's whole batch (last write wins)
for t in range(svc.epoch, TICKS):
    ds, wkey = batch(t)
    for dd in ds:
        svc.submit(dd)
    svc.withdraw(wkey)
    svc.tick()
svc.flush()
svc.book.parity_check()
arrays, meta = svc.book.export_state()
out = dict(prices=np.stack(svc.price_history), last_price_epoch=svc._last_price_epoch,
           epoch=svc.epoch, stats=[dataclasses.asdict(s) for s in svc.stats_history],
           book_arrays=dict(arrays), book_meta=meta)
with open(os.path.join(d, f"out_{mode}.pkl"), "wb") as f:
    pickle.dump(out, f)
"""


def _run(mode, point, workdir):
    return subprocess.run(
        [sys.executable, "-c", _SCRIPT, mode, point, "0", str(workdir)],
        env={**os.environ, "PYTHONPATH": str(SRC)}, capture_output=True, text=True, timeout=240,
    )


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    d = tmp_path_factory.mktemp("uninterrupted")
    r = _run("ref", "-", d)
    assert r.returncode == 0, r.stderr
    with open(d / "out_ref.pkl", "rb") as f:
        return pickle.load(f)


@pytest.mark.parametrize("point", ["mid_ingest", "post_drain", "post_settle", "mid_delta"])
def test_hard_kill_recovery_bit_identical(tmp_path, uninterrupted, point):
    r = _run("crash", point, tmp_path)
    assert r.returncode == 1, f"the kill hook never fired: {r.stderr}"
    assert not (tmp_path / "out_crash.pkl").exists()
    r = _run("resume", point, tmp_path)
    assert r.returncode == 0, r.stderr
    with open(tmp_path / "out_resume.pkl", "rb") as f:
        got = pickle.load(f)
    ref = uninterrupted
    np.testing.assert_array_equal(got["prices"], ref["prices"])
    assert got["last_price_epoch"] == ref["last_price_epoch"] and got["epoch"] == ref["epoch"]
    assert len(got["stats"]) == len(ref["stats"])
    for sa, sb in zip(got["stats"], ref["stats"]):
        for k, va in sa.items():
            vb = sb[k]
            if isinstance(va, np.ndarray):
                assert va.dtype == vb.dtype and np.array_equal(va, vb), k
            else:
                assert va == vb or (va != va and vb != vb), (k, va, vb)
    assert got["book_meta"] == ref["book_meta"]
    for k, va in got["book_arrays"].items():
        assert np.array_equal(va, ref["book_arrays"][k]), f"book/{k}"


def test_tick_and_build_timings(tmp_path):
    """Each binding tick leaves its stage timings and the kind of record it
    cut; a preview leaves them as they were; a bridge times its bulk load
    and bootstrap record, a resumed service its restore and WAL replay."""
    cfg = PORT.ServiceConfig(wal_path=str(tmp_path / "m.wal"),
                             checkpoint_dir=str(tmp_path / "ck"), checkpoint_full_every=2)
    eco = PORT.fleet_economy(40, 3, seed=2, device="cpu")
    svc = PORT.MarketService.from_economy(eco, config=cfg)
    assert svc.last_tick_timings == {} and set(svc.build_timings) == {
        "restore_ms", "wal_replay_ms", "load_ms", "bootstrap_ms"}
    kinds, rows = [], []
    for t in range(3):
        _churn(PORT, eco, svc, t)
        svc.tick()
        timings = svc.last_tick_timings
        assert all(timings[k] >= 0.0 for k in (
            "drain_ms", "sync_ms", "settle_ms", "capture_ms", "commit_ms"))
        assert timings["tick_ms"] >= timings["settle_ms"] + timings["commit_ms"]
        kinds.append(timings["record"])
        rows.append(timings["sync_rows"])
    assert kinds == ["delta", "delta", "full"]
    assert rows[0] == svc.book.rows_cap and 0 < rows[1] < svc.book.rows_cap
    before = dict(svc.last_tick_timings)
    svc.preview()
    assert svc.last_tick_timings == before
    _churn(PORT, eco, svc, 3)
    svc.flush()
    resumed = PORT.MarketService.from_economy(PORT.fleet_economy(40, 3, seed=2, device="cpu"),
                                              config=cfg)
    assert resumed.restored_step == 3 and resumed.replayed_records > 0
    assert set(resumed.build_timings) == {"restore_ms", "wal_replay_ms"}
    assert resumed.build_timings["restore_ms"] > 0.0
    assert resumed.build_timings["wal_replay_ms"] > 0.0
    plain = PORT.MarketService.from_economy(PORT.fleet_economy(40, 3, seed=2, device="cpu"))
    plain.tick()
    assert plain.last_tick_timings["record"] is None
    assert set(plain.build_timings) == {"restore_ms", "load_ms"}
