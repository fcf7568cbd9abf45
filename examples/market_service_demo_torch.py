"""Always-on market service on the PyTorch port (the twin of
``examples/market_service_demo.py``): stream bid deltas into a persistent
device book, settle on a tick (through ``sparse_bid_eval_partials`` on the
card), poll prices between auctions — durably.

The paper runs its clock auction "at regular time intervals"; this demo is
that loop in production shape — a :class:`repro_torch.serve.market.MarketService`
bridged from a fleet economy, absorbing a stream of re-priced bids, agent
churn (arrivals and departures routed through the economy's O(Δ) dirty-uid
bridge), explicit withdrawals, and fault-injected bid dropout, then
auctioning the book each tick with warm-started prices.  Midway through the
horizon the service is hard-dropped — no drain, no shutdown hook — and
resumed from its write-ahead log + latest checkpoint, after which the loop
continues as if nothing happened (the recovery suite proves bit-identical;
here the book's ``parity_check`` oracle and the continuing epoch counter
show it live).  The incremental book is checked bit-identical to a
from-scratch repack at the end.

    PYTHONPATH=src python examples/market_service_demo_torch.py \
        [--agents 800] [--ticks 4] [--churn 0.05] [--dropout 0.1] [--seed 0] [--device cpu]
"""
import argparse
import os
import tempfile
import time

import numpy as np

from repro_torch.core.faults import FaultModel
from repro_torch.core.markets import fleet_economy, fleet_population
from repro_torch.serve import ServiceConfig
from repro_torch.serve.market import BidDelta, MarketService


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--agents", type=int, default=800)
    ap.add_argument("--clusters", type=int, default=4)
    ap.add_argument("--ticks", type=int, default=4)
    ap.add_argument("--churn", type=float, default=0.05,
                    help="fraction of agents re-pricing per tick")
    ap.add_argument("--withdraw-frac", type=float, default=0.02,
                    help="fraction of agents withdrawing per tick")
    ap.add_argument("--dropout", type=float, default=0.1,
                    help="per-tick bid-stream dropout probability")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    eco = fleet_economy(args.agents, args.clusters, seed=args.seed, device=args.device)
    rng = np.random.default_rng(args.seed)
    faults = FaultModel(bid_dropout=args.dropout, seed=args.seed)
    tmp = tempfile.mkdtemp(prefix="market_demo_")
    cfg = ServiceConfig(
        wal_path=os.path.join(tmp, "market.wal"),
        checkpoint_dir=os.path.join(tmp, "ckpt"),
    )
    svc = MarketService.from_economy(eco, config=cfg, faults=faults)
    print(
        f"book: {svc.book.num_rows} rows ({svc.book.rows_cap} slots), "
        f"{eco.C} clusters x {eco.T} rtypes; durable in {tmp}"
    )
    p, epoch = svc.poll_prices()
    print(f"poll before any tick -> reserve curve (epoch {epoch})")

    keys, idx_rows, val_rows, mask_rows, pi_rows = eco.export_bid_rows()
    live = np.flatnonzero(mask_rows.any(axis=1))
    withdrawn: set = set()
    for t in range(args.ticks):
        # a) streamed re-pricing: a churn-fraction of agents nudge their pi
        pick = rng.choice(live, size=max(1, int(args.churn * live.size)),
                          replace=False)
        scale = rng.uniform(0.9, 1.1, size=pick.size).astype(np.float32)
        accepted = 0
        for j, i in enumerate(pick):
            bundles = [
                (idx_rows[i, b], val_rows[i, b])
                for b in np.flatnonzero(mask_rows[i])
            ]
            accepted += svc.submit(
                BidDelta(keys[i], bundles, pi_rows[i][mask_rows[i]] * scale[j])
            )
            withdrawn.discard(keys[i])  # a re-submission revives the bid
        # b) explicit withdrawals: some agents leave the market outright
        n_wd = int(args.withdraw_frac * live.size)
        for i in rng.choice(live, size=n_wd, replace=False):
            if keys[i] not in withdrawn and svc.withdraw(keys[i]):
                withdrawn.add(keys[i])
        # c) population churn rides the economy bridge in O(Δ)
        if t == 1:
            keep = np.ones(len(eco.pop), bool)
            keep[:: max(2, len(eco.pop) // 20)] = False
            keep[0] = True
            eco.remove_agents(~keep)
            eco.add_agents(
                fleet_population(8, eco.C, seed=args.seed + t, placed_frac=0.0)
            )
            ups, wd = svc.sync_from_economy(eco)
            print(f"tick {t}: churn synced — {ups} upserts, {wd} withdrawals")
            keys, idx_rows, val_rows, mask_rows, pi_rows = eco.export_bid_rows()
            live = np.flatnonzero(mask_rows.any(axis=1))
            withdrawn &= set(keys)
        # d) hard kill + resume mid-horizon: the pending queue survives in
        #    the WAL, committed state in the checkpoint — the loop continues
        if t == args.ticks // 2:
            pend = svc.pending
            del svc  # no drain, no checkpoint, no goodbye
            svc = MarketService.from_economy(eco, config=cfg, faults=faults)
            print(
                f"tick {t}: killed + resumed — epoch {svc.epoch}, "
                f"{svc.replayed_records} WAL records replayed, "
                f"{svc.pending}/{pend} pending bids reconstructed"
            )
        t0 = time.time()
        s = svc.tick()
        dt = (time.time() - t0) * 1e3
        print(
            f"tick {t}: {accepted} bids in, {s.bids_withdrawn} out, "
            f"{s.dropped_bids} dropped, {s.rounds} rounds, "
            f"converged={s.converged}, SYSTEM ok={s.system_ok}, "
            f"health={s.health}, pct_settled={s.pct_settled:.1f}%, "
            f"peak psi={s.psi.max():.2f}, {dt:.0f} ms"
        )
    p, epoch = svc.poll_prices()
    print(f"posted prices (epoch {epoch}): {np.round(p, 3).tolist()[:6]} ...")
    svc.book.parity_check()
    print("incremental book bit-identical to full repack: True")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
