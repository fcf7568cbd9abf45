#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written Hopper kernels from ``src/repro_torch/kernels/csrc``
(four sources, one ``nvcc`` each, in parallel), holds each against its plain
PyTorch version on the card, drives the port's main path at full size, and
checks the main path on the card against itself through the plain versions.
The main path is five paths, each driven with the launch counts set to 0
just before it and read just after: the 100k-agent §V economy (three binding
epochs warm-started, three with cold restarts) through
``sparse_bid_eval_partials``; the 100k x 1k standalone clock through
``sparse_bid_eval_csr_z`` (CSR book) and ``sparse_bid_eval_z`` (padded
book); the same market densified, the paper's §III encoding, through
``bid_eval``; and phase [5], ``rwkv6-7b`` at full width and depth (float32
weights from seed 0, bf16 activations) serving 4 requests of 500 prompt
tokens and 32 greedy new ones through ``serve.decode.generate``, its
chunked prefill running the WKV recurrence through ``wkv6`` once a layer.
Each kernel is then held against its plain version and timed at its path's
shapes on its path's inputs (for ``wkv6``, the tensors layer 0 and layer 31
hand it in the served prefill).  Phase [4] also provisions the quickstart
and elastic-training books to device grants through ``bid_eval`` and
through its plain version; phase [5] also runs the whole model with
``wkv6`` forced to its plain version, and the chunked prefill against
token-by-token decode.  Phase [2] also holds ``sparse_bid_eval_partials``
against its plain version bit for bit at edge books across every fold
regime (PARTIALS_EDGE_M rows a block, padded and not, 8 and 1 blocks, R in
PARTIALS_EDGE_R, repeated pools, -0.0, masked and priced-out users), and
phase [5] holds ``wkv6`` within WKV6_TOL at edge shapes (WKV6_EDGE_T
tokens, float32 and bf16, with and without an initial state, w down to
1e-30).  Any failed check raises; nothing is caught and carried on.

Output: progress lines, then the card's ``name, power.limit``, then one JSON
line ``{"kernels": [...]}`` with one entry per kernel entry point, then the
last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Without a visible GPU the script exits 2 and prints no result.

Kernel times are CUDA-event timings of a CUDA graph that replays the call 20
times (the dense plain version 5 times: each call allocates a 400 MB gather),
median of 20 replays after 3 warm-ups, with the book warm in L2 as the clock
loop re-reads it every round (the dense books, 1.2-1.6 GB, do not fit it).
Bounds use the H100 SXM's published 3.35 TB/s and 67 TFLOP/s float32
(non-tensor) peaks and, for ``wkv6``'s exponentials and logs, 16 SFU
operations a clock on each of the 132 SMs at the card's maximum SM clock.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
GRAPH_CALLS = 20  # calls captured in one timed graph
DENSE_PLAIN_CALLS = 5  # the dense plain version allocates a 400 MB (U, R) gather per call
REPLAYS = 20
WARMUPS = 3


def log(*args) -> None:
    print(*args, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# ---------------------------------------------------------------------------
# timing and bounds
# ---------------------------------------------------------------------------


def graph_ms(torch, fn, calls: int = GRAPH_CALLS) -> float:
    """Median device ms of one ``fn()`` call: a CUDA graph holding ``calls``
    calls, replayed REPLAYS times between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(WARMUPS):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(WARMUPS):
        graph.replay()
    times = []
    for _ in range(REPLAYS):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / calls)
    del graph
    return statistics.median(times)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(read_bytes: int, write_bytes: int, fp32_ops: int) -> tuple[float, str]:
    """(bound_ms, bound_by): the larger of bytes over HBM rate and float32
    operations over the float32 peak."""
    t_bytes = (read_bytes + write_bytes) / HBM_BYTES_PER_S * 1e3
    t_ops = fp32_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def padded_bound(idx, val, mask, pi, prices, out_bytes: int) -> tuple[float, str]:
    u, b, k = idx.shape
    # per bundle: K multiply-adds for the cost, one compare (and a subtract
    # for vector pi) for the selection
    ops = u * b * (2 * k + (2 if pi.ndim == 2 else 1))
    return bound(nbytes(idx, val, mask, pi, prices), out_bytes + 4 * u, ops)


def dense_bound(bundles, mask, pi, prices) -> tuple[float, str]:
    """Only valid rows need reading (a masked bundle's row is never priced);
    one multiply-add per valid (bundle, pool) and a compare per bundle."""
    u, b, r = bundles.shape
    valid = int(mask.sum())
    ops = 2 * valid * r + u * b
    return bound(4 * valid * r + nbytes(mask, pi, prices), 4 * u + 4 * r, ops)


def csr_bound(idx, val, offsets, mask, pi, prices, r) -> tuple[float, str]:
    u, b = mask.shape
    ops = 2 * idx.numel() + u * b * (2 if pi.ndim == 2 else 1)
    return bound(nbytes(idx, val, offsets, mask, pi, prices), 4 * u + 4 * r, ops)


# ---------------------------------------------------------------------------
# books
# ---------------------------------------------------------------------------


def synthetic_book(torch, np, dev, u, b, k, r, vector_pi, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, r, (u, b, k)).astype(np.int32)
    val = rng.uniform(-2, 4, (u, b, k)).astype(np.float32)
    mask = rng.random((u, b)) < 0.8
    pi = rng.uniform(-5, 40, (u, b) if vector_pi else u).astype(np.float32)
    prices = rng.random(r).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (idx, val, mask, pi, prices)]


def skewed_csr_book(torch, np, pt, dev, u, b, r, vector_pi, seed):
    """Bundle sizes K in 1..16, geometric with mean about 4."""
    rng = np.random.default_rng(seed)
    counts = np.clip(rng.geometric(0.25, u * b), 1, 16)
    offsets = np.zeros(u * b + 1, np.int32)
    offsets[1:] = np.cumsum(counts)
    nnz = int(offsets[-1])
    idx = rng.integers(0, r, nnz).astype(np.int32)
    val = rng.uniform(-2, 4, nnz).astype(np.float32)
    mask = rng.random((u, b)) < 0.8
    pi = rng.uniform(-5, 40, (u, b) if vector_pi else u).astype(np.float32)
    prob = pt.csr_problem_from_arrays(idx, val, offsets, mask, pi, np.ones(r, np.float32),
                                      device=dev)
    prices = torch.from_numpy(rng.random(r).astype(np.float32)).to(dev)
    return prob, prices


def provisioning_books(pt, np, dev) -> dict:
    """examples/quickstart.py's book (4 pools, three teams) and
    examples/elastic_train.py's two ``run_auction`` books, packed dense on
    ``dev``: label -> (problem, reserve prices, pools, user -> job, config)."""
    pools = [
        pt.ResourcePool("us-east", "tpu_chips", base_cost=10.0, utilization=0.93, supply=512),
        pt.ResourcePool("us-east", "hbm_gb", base_cost=0.05, utilization=0.90, supply=8192),
        pt.ResourcePool("eu-west", "tpu_chips", base_cost=10.0, utilization=0.35, supply=512),
        pt.ResourcePool("eu-west", "hbm_gb", base_cost=0.05, utilization=0.30, supply=8192),
    ]
    idx = pt.pool_index([p.name for p in pools])
    tilde_p = pt.reserve_prices(pools)
    bl, pis = pt.operator_supply_bids(pools, tilde_p, lots=4)
    jobs = [-1] * len(bl)

    def both(chips, hbm):
        return pt.OneOf(
            pt.All(pt.Res("us-east/tpu_chips", chips), pt.Res("us-east/hbm_gb", hbm)),
            pt.All(pt.Res("eu-west/tpu_chips", chips), pt.Res("eu-west/hbm_gb", hbm)))

    teams = [(both(256, 4096), 6000.0),
             (pt.All(pt.Res("us-east/tpu_chips", 128), pt.Res("us-east/hbm_gb", 2048)), 9000.0),
             (both(128, 1024), 1500.0)]
    for j, (tree, pi) in enumerate(teams):
        bl.append(pt.flatten(tree, idx))
        pis.append(pi)
        jobs.append(j)
    base = np.array([p.base_cost for p in pools])
    books = {"quickstart": (pt.pack_bids(bl, pis, base_cost=base, device=dev), tilde_p, pools,
                            jobs, pt.ClockConfig())}
    for util_east, job_chips in ((0.93, 128), (0.20, 64)):
        pools = [pt.ResourcePool("us-east", "tpu_chips", 10.0, util_east, supply=256),
                 pt.ResourcePool("eu-west", "tpu_chips", 10.0, 0.30, supply=256)]
        tilde_p = pt.reserve_prices(pools)
        bl, pis = pt.operator_supply_bids(pools, tilde_p, lots=4)
        jobs = [-1] * len(bl) + [0]
        bl.append([np.array([job_chips, 0], np.float32), np.array([0, job_chips], np.float32)])
        pis.append(job_chips * 10.0 * 4)
        books[f"elastic us-east util {util_east} job {job_chips} chips"] = (
            pt.pack_bids(bl, pis, base_cost=np.array([10.0, 10.0]), device=dev), tilde_p, pools,
            jobs, pt.ClockConfig())
    return books


def dense_round_book(torch, dev, u, b, r, seed):
    """The repo's ``bid_eval_round`` book (benchmarks/run.py): bundles
    normal, mask < 0.9, pi normal * 5, prices |normal|; drawn on the card."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn((u, b, r), generator=g, device=dev),
            torch.rand((u, b), generator=g, device=dev) < 0.9,
            torch.randn((u,), generator=g, device=dev) * 5,
            torch.randn((r,), generator=g, device=dev).abs())


def same_bits(torch, a, b) -> bool:
    """Bit for bit: NaN where the other is NaN, every other float32 with
    the same bits (so -0.0 and +0.0 differ)."""
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and bool(torch.equal(
        torch.where(nan, 0, a.view(torch.int32)), torch.where(nan, 0, b.view(torch.int32))))


def z_tolerance(torch, sel_idx_flat, sel_val_flat, r):
    """Per-pool bound on the atomics' reordering error: 1e-5 of the summed
    |contributions| (float32 eps is 6e-8; a pool sums up to 10^5 terms)."""
    absz = torch.zeros(r, dtype=torch.float32, device=sel_idx_flat.device)
    absz.index_add_(0, sel_idx_flat.long(), sel_val_flat.abs())
    return 1e-5 * absz + 1e-6


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def check_padded_kernel(torch, ops, ref, book, label):
    """z mode within tolerance, partials mode bit-identical, chosen exact
    → (max |z err|, max |partials err|)."""
    idx, val, mask, pi, prices = book
    r = prices.numel()
    z, chosen = ops.sparse_bid_eval(idx, val, mask, pi, prices, r)
    parts, chosen_p = ops.sparse_bid_eval(idx, val, mask, pi, prices, r, 8)
    torch.cuda.synchronize()
    z_ref, chosen_ref = ref.sparse_bid_eval(idx, val, mask, pi, prices, r)
    parts_ref, _ = ref.sparse_bid_eval(idx, val, mask, pi, prices, r, 8)
    sel_idx, sel_val, _, _ = ref.select_padded(idx, val, mask, pi, prices)
    tol = z_tolerance(torch, sel_idx.reshape(-1), sel_val.reshape(-1), r)
    z_err = float((z - z_ref).abs().max())
    parts_err = float((parts - parts_ref).abs().max())
    check(torch.equal(chosen, chosen_ref), f"{label}: z-mode chosen differs")
    check(torch.equal(chosen_p, chosen_ref), f"{label}: partials-mode chosen differs")
    check(bool(((z - z_ref).abs() <= tol).all()), f"{label}: z off by {z_err}")
    check(same_bits(torch, parts, parts_ref), f"{label}: partials off by {parts_err}")
    log(f"  sparse_bid_eval {label}: chosen exact, partials max|err| {parts_err} "
        f"(bit-identical), z max|err| {z_err:.3g} (max|z| {float(z_ref.abs().max()):.6g})")
    return z_err, parts_err


def check_csr_kernel(torch, ops, ref, prob, prices, label):
    r = prob.num_resources
    args = (prob.idx, prob.val, prob.offsets, prob.bundle_mask, prob.pi, prices, r, prob.k_bound)
    z, chosen = ops.sparse_bid_eval_csr(*args)
    torch.cuda.synchronize()
    z_ref, chosen_ref = ref.sparse_bid_eval_csr(*args)
    kept = chosen_ref.long()[prob.rows.long() // prob.num_bundles] == (
        prob.rows.long() % prob.num_bundles)
    tol = z_tolerance(torch, prob.idx, torch.where(kept, prob.val, 0.0), r)
    z_err = float((z - z_ref).abs().max())
    check(torch.equal(chosen, chosen_ref), f"{label}: csr chosen differs")
    check(bool(((z - z_ref).abs() <= tol).all()), f"{label}: csr z off by {z_err}")
    log(f"  sparse_bid_eval_csr {label}: chosen exact, z max|err| {z_err:.3g} "
        f"(max|z| {float(z_ref.abs().max()):.6g}), nnz {prob.nnz}, k_bound {prob.k_bound}")
    return z_err


def check_dense_kernel(torch, ops, ref, book, label) -> float:
    """bid_eval against its plain version: chosen exact, z bit-identical →
    max |z err|."""
    z, chosen = ops.bid_eval(*book)
    torch.cuda.synchronize()
    z_ref, chosen_ref = ref.bid_eval(*book)
    z_err = float((z - z_ref).abs().max())
    check(torch.equal(chosen, chosen_ref), f"{label}: bid_eval chosen differs")
    check(torch.equal(z, z_ref), f"{label}: bid_eval z off by {z_err}")
    log(f"  bid_eval {label}: chosen exact ({int((chosen >= 0).sum())} in), z bit-identical "
        f"(max|err| {z_err}, max|z| {float(z_ref.abs().max()):.6g})")
    return z_err


def time_at_check_shape(torch, kernel, fn, bound_) -> float:
    ms = graph_ms(torch, fn)
    log(f"    {kernel}: {ms:.4f} ms, bound {bound_[0]:.4f} ms ({bound_[1]})")
    return ms


PARTIALS_EDGE_M = (1, 15, 16, 20, 24, 31, 32, 33, 1_024, 1_025, 8_087)
PARTIALS_EDGE_R = (1, 24, 128, 129, 1_000)


def adversarial_book(torch, np, dev, u, r, vector_pi, seed, all_out=False, b=4, k=3):
    """A K-padded book (K >= 3) with repeated pools inside bundles, -0.0
    and +0.0 values, wholly masked users and users priced out."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, r, (u, b, k)).astype(np.int32)
    dup = rng.random((u, b)) < 0.3
    idx[dup, 1] = idx[dup, 0]
    dup = rng.random((u, b)) < 0.1
    idx[dup, 2] = idx[dup, 0]
    val = (rng.uniform(-2, 4, (u, b, k)) * 10.0 ** rng.integers(-3, 4, (u, b, k))).astype(np.float32)
    val[rng.random((u, b, k)) < 0.05] = -0.0
    val[rng.random((u, b, k)) < 0.05] = 0.0
    mask = rng.random((u, b)) < 0.8
    mask[rng.random(u) < 0.1] = False
    pi = rng.uniform(-5, 40, (u, b) if vector_pi else u).astype(np.float32)
    pi[rng.random(u) < 0.1] = -1e30
    if all_out:
        pi[:] = -np.inf
    prices = rng.random(r).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (idx, val, mask, pi, prices)]


def check_partials_edges(torch, np, ops, ref, dev) -> int:
    """Partials bit-identical and chosen exact across the fold regimes: m
    rows a block in PARTIALS_EDGE_M with and without padded users, 8 and 1
    blocks, R in PARTIALS_EDGE_R, scalar and vector pi, adversarial books;
    then books where every user is out, and two past the kernel's shared
    memory → the number of books checked."""
    cases = []
    for m in PARTIALS_EDGE_M:
        for nb, pad in ((8, 0), (8, 3), (1, 0)):
            for r in PARTIALS_EDGE_R:
                cases += [(nb * m - pad, nb, r, vector_pi, False) for vector_pi in (False, True)]
    cases += [(8 * m - 3, 8, 24, vector_pi, True) for m in (20, 8_087) for vector_pi in (False, True)]
    # past the kernel's shared memory: B*K = 1,024 pairs a user read from
    # device memory, and R = 60,000 window sums kept in the level buffer
    cases += [(2_000, 8, 24, True, False, 4, 256), (2_000, 8, 60_000, False, False, 2, 3)]
    for seed, (u, nb, r, vector_pi, all_out, *bk) in enumerate(cases):
        book = adversarial_book(torch, np, dev, u, r, vector_pi, seed, all_out, *bk)
        parts, chosen = ops.sparse_bid_eval(*book, r, nb)
        torch.cuda.synchronize()
        parts_ref, chosen_ref = ref.sparse_bid_eval(*book, r, nb)
        label = (f"partials U={u} blocks={nb} R={r} {'vector' if vector_pi else 'scalar'} pi"
                 f"{', every user out' if all_out else ''}")
        check(torch.equal(chosen, chosen_ref), f"{label}: chosen differs")
        check(same_bits(torch, parts, parts_ref), f"{label}: partials differ")
    log(f"  sparse_bid_eval_partials at {len(cases)} edge books (m rows a block in "
        f"{PARTIALS_EDGE_M}, padded and not, 8 and 1 blocks, R in {PARTIALS_EDGE_R}, scalar "
        f"and vector pi, repeated pools, -0.0, masked and priced-out users; every user out; "
        f"K = 256 and R = 60,000): chosen exact, partials bit-identical")
    return len(cases)


def recording(fn, last: dict):
    """``fn`` that also keeps the chosen bundles of its latest call."""

    def demand(*args):
        out = fn(*args)
        last["chosen"] = out[1]
        return out

    demand.__dict__.update(fn.__dict__)
    return demand


def market_paths(torch, np, dev) -> list[dict]:
    """Phases [2]-[4], the market's paths → their kernels' entries."""
    from repro_torch import core as pt
    from repro_torch.kernels import ops, ref

    # -- 2. kernels against their plain versions ----------------------------
    log("[2] kernels against their plain versions")
    synthetic = {}  # off the main path: the synthetic planet books' partials times
    for vector_pi in (False, True):
        book = synthetic_book(torch, np, dev, 100_000, 4, 8, 1_000, vector_pi, seed=1)
        label = f"100000x4x8 R=1000 {'vector' if vector_pi else 'scalar'} pi"
        check_padded_kernel(torch, ops, ref, book, label)
        time_at_check_shape(torch, "sparse_bid_eval z mode",
                            lambda: ops.sparse_bid_eval(*book, 1_000),
                            padded_bound(*book, out_bytes=4 * 1_000))
        s_bound = padded_bound(*book, out_bytes=4 * 8 * 1_000)
        synthetic[label] = {"ms": time_at_check_shape(
            torch, "sparse_bid_eval partials", lambda: ops.sparse_bid_eval(*book, 1_000, 8),
            s_bound), "bound_ms": s_bound[0]}
    check_partials_edges(torch, np, ops, ref, dev)
    round_book = dense_round_book(torch, dev, 100_000, 4, 1_000, seed=1)
    check_dense_kernel(torch, ops, ref, round_book, "bid_eval_round 100000x4 R=1000")
    bundles, mask, pi, prices = round_book
    small = (bundles[:4096], mask[:4096], pi[:4096], prices)
    check_dense_kernel(torch, ops, ref, (small[0], torch.zeros_like(small[1]), small[2], prices),
                       "4096x4 R=1000, every bundle masked")
    tied = small[0].clone()
    tied[:, 2] = tied[:, 1]
    tied[:, 0] = tied[:, 1]
    check_dense_kernel(torch, ops, ref, (tied, small[1], small[2], prices),
                       "4096x4 R=1000, bundles 0-2 tied")
    for r in (4, 40, 59, 60, 100):  # both cost folds and the fold-regime edges
        for u in (19, 20, 32, 33, 1000):  # every z-fold regime
            book = (bundles[:u, :3, :r].contiguous(), mask[:u, :3].contiguous(), pi[:u],
                    prices[:r].contiguous())
            z, chosen = ops.bid_eval(*book)
            z_ref, chosen_ref = ref.bid_eval(*book)
            check(torch.equal(chosen, chosen_ref) and torch.equal(z, z_ref),
                  f"bid_eval {u}x3 R={r} differs from its plain version")
    log("  bid_eval at U in {19, 20, 32, 33, 1000} x R in {4, 40, 59, 60, 100}: "
        "chosen exact, z bit-identical")
    # the first epoch's book at its start prices, the reserve curve
    probe = pt.fleet_economy(100_000, 8, seed=0, device=dev)
    eco_prob = probe.pack_bid_book().problem
    eco_idx, eco_val = pt.csr_padded_views(eco_prob)
    eco_prices = torch.from_numpy(
        np.asarray(pt.reserve_prices(probe.pools(), probe.weighting), np.float32)).to(dev)
    eco_args = (eco_idx, eco_val, eco_prob.bundle_mask, eco_prob.pi, eco_prices)
    check(eco_prob.pi.ndim == 2, "economy book has vector pi")
    u, b, k = eco_idx.shape
    _, parts_err = check_padded_kernel(
        torch, ops, ref, eco_args, f"economy round 1 {u}x{b}x{k} R={eco_prob.num_resources}")
    for vector_pi in (False, True):
        prob, prices = skewed_csr_book(torch, np, pt, dev, 100_000, 4, 1_000, vector_pi, seed=2)
        label = f"skewed K 1..16 100000x4 R=1000 {'vector' if vector_pi else 'scalar'} pi"
        check_csr_kernel(torch, ops, ref, prob, prices, label)
        args = (prob.idx, prob.val, prob.offsets, prob.bundle_mask, prob.pi, prices)
        time_at_check_shape(torch, "sparse_bid_eval_csr",
                            lambda: ops.sparse_bid_eval_csr(*args, 1_000, prob.k_bound),
                            csr_bound(*args, 1_000))

    # -- 3. the main path at full size: each path's launches counted alone ---
    log("[3] main path: fleet_economy(100_000, 8, seed=0), 3 binding epochs warm-started, "
        "3 with cold restarts; then the 100k x 1k standalone clock, CSR, padded and dense")
    planet = pt.random_market(100_000, 1_000, seed=0, device=dev)
    planet_csr = pt.csr_from_padded(planet)
    planet_dense = pt.densify(planet)
    # warm_start=True: each clock starts at max(p_prev, reserve), the
    # production setting (cold, then two warm epochs).  The default cold
    # restart re-seeds every clock from the reserve curve (the paper's
    # baseline) and runs the long clocks of later epochs.
    economies = {
        "warm-started": pt.fleet_economy(100_000, 8, seed=0, warm_start=True, device=dev),
        "cold restarts": pt.fleet_economy(100_000, 8, seed=0, device=dev),
    }
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    epoch_rounds = {}
    for label, eco in economies.items():
        epoch_rounds[label] = []
        for epoch in range(3):
            before = ops.launch_counts()["sparse_bid_eval_partials"]
            t0 = time.perf_counter()
            st = eco.run_epoch()
            wall = time.perf_counter() - t0
            grew = ops.launch_counts()["sparse_bid_eval_partials"] - before
            log(f"  {label} epoch {epoch} ({'warm' if st.warm_started else 'cold'}): "
                f"{st.rounds} rounds, {wall * 1e3:.1f} ms, converged {st.converged}, "
                f"system_ok {st.system_ok}, migrations {st.migrations}, "
                f"sparse_bid_eval_partials launches {grew}")
            check(st.converged and st.system_ok, f"{label} epoch {epoch} not converged/feasible")
            check(np.isfinite(st.prices).all() and st.prices.shape == (eco.R,), "epoch prices")
            check(grew >= st.rounds + 1, f"epoch {epoch}: {grew} launches for {st.rounds} rounds")
            epoch_rounds[label].append(st.rounds)
    torch.cuda.synchronize()
    path_launches = {"economy": ops.launch_counts()}
    check(path_launches["economy"]["sparse_bid_eval_partials"] > 0,
          "the economy never launched sparse_bid_eval_partials")

    cfg = pt.ClockConfig(alpha=0.6, delta=0.25)
    p0 = torch.full((1_000,), 0.1, device=dev)
    clock_prices = {}
    clock_rounds_of = {}
    for name, problem, kernel in (
        ("csr", planet_csr, "sparse_bid_eval_csr_z"),
        ("padded", planet, "sparse_bid_eval_z"),
        ("dense", planet_dense, "bid_eval"),
    ):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = pt.clock_auction(problem, p0, cfg)  # the default demand fn: the kernel
        rounds, converged = int(res.rounds), bool(res.converged)
        wall = time.perf_counter() - t0
        flags = pt.verify_system(problem, res)
        torch.cuda.synchronize()
        path_launches[name] = ops.launch_counts()
        log(f"  standalone clock 100000x1000 ({name}): {rounds} rounds, {wall * 1e3:.1f} ms, "
            f"converged {converged}, SYSTEM {all(flags.values())}, {kernel} launches "
            f"{path_launches[name][kernel]}")
        check(converged and all(flags.values()), f"standalone {name}: {flags}")
        check(bool(torch.isfinite(res.prices).all()), f"standalone {name}: prices")
        check(path_launches[name][kernel] > rounds, f"standalone {name}: {kernel} not launched")
        clock_prices[name] = res.prices
        clock_rounds_of[name] = (rounds, wall * 1e3)
    log(f"  launches per path: {path_launches}")
    log("  planet clock rounds (ms): " + ", ".join(
        f"{name} {rounds} ({ms:.1f})" for name, (rounds, ms) in clock_rounds_of.items()))

    # -- the kernels at the main path's shapes, on the path's own inputs ------
    log("[timing] kernels against their plain versions at the main path's shapes (CUDA graphs)")
    r = eco_prob.num_resources
    k_ms = graph_ms(torch, lambda: ops.sparse_bid_eval(*eco_args, r, 8))
    p_ms = graph_ms(torch, lambda: ops.sparse_bid_eval(*eco_args, r, 8, plain=True))
    b_ms, b_by = padded_bound(*eco_args, out_bytes=4 * 8 * r)
    log(f"  sparse_bid_eval_partials {u}x{b}x{k} R={r}: {k_ms:.4f} ms, plain {p_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by})")
    pu, pb, pk = planet.idx.shape
    z_err = 0.0
    for at, prices in (("start", p0), ("cleared", clock_prices["padded"])):
        book = (planet.idx, planet.val, planet.bundle_mask, planet.pi, prices.contiguous())
        err, _ = check_padded_kernel(
            torch, ops, ref, book, f"planet {pu}x{pb}x{pk} R=1000 at {at} prices")
        z_err = max(z_err, err)
    planet_args = (planet.idx, planet.val, planet.bundle_mask, planet.pi, p0)
    z_ms = graph_ms(torch, lambda: ops.sparse_bid_eval(*planet_args, 1_000))
    zp_ms = graph_ms(torch, lambda: ops.sparse_bid_eval(*planet_args, 1_000, plain=True))
    zb_ms, zb_by = padded_bound(*planet_args, out_bytes=4 * 1_000)
    log(f"  sparse_bid_eval_z {pu}x{pb}x{pk} R=1000: {z_ms:.4f} ms, plain {zp_ms:.4f} ms, "
        f"bound {zb_ms:.4f} ms ({zb_by})")
    csr_err = 0.0
    for at, prices in (("start", p0), ("cleared", clock_prices["csr"])):
        csr_err = max(csr_err, check_csr_kernel(
            torch, ops, ref, planet_csr, prices.contiguous(), f"planet 100000x1000 at {at} prices"))
    c_args = (planet_csr.idx, planet_csr.val, planet_csr.offsets, planet_csr.bundle_mask,
              planet_csr.pi, p0, 1_000, planet_csr.k_bound)
    c_ms = graph_ms(torch, lambda: ops.sparse_bid_eval_csr(*c_args))
    cp_ms = graph_ms(torch, lambda: ops.sparse_bid_eval_csr(*c_args, plain=True))
    cb_ms, cb_by = csr_bound(*c_args[:6], 1_000)
    log(f"  sparse_bid_eval_csr_z {planet_csr.num_users}x{planet_csr.num_bundles} "
        f"nnz={planet_csr.nnz}: {c_ms:.4f} ms, plain {cp_ms:.4f} ms, bound {cb_ms:.4f} ms ({cb_by})")
    du, db, dr = planet_dense.bundles.shape
    dense_args = (planet_dense.bundles, planet_dense.bundle_mask, planet_dense.pi)
    dense_err = max(
        check_dense_kernel(torch, ops, ref, (*dense_args, prices.contiguous()),
                           f"dense planet {du}x{db} R={dr} at {at} prices")
        for at, prices in (("start", p0), ("cleared", clock_prices["dense"])))
    d_ms = graph_ms(torch, lambda: ops.bid_eval(*dense_args, p0))
    dp_ms = graph_ms(torch, lambda: ops.bid_eval(*dense_args, p0, plain=True), DENSE_PLAIN_CALLS)
    db_ms, db_by = dense_bound(*dense_args, p0)
    flat = planet_dense.bundles.reshape(du * db, dr)
    mv_ms = graph_ms(torch, lambda: torch.mv(flat, p0))
    log(f"  bid_eval dense planet {du}x{db} R={dr}: {d_ms:.4f} ms, plain {dp_ms:.4f} ms "
        f"({DENSE_PLAIN_CALLS}-call graphs), bound {db_ms:.4f} ms ({db_by}); "
        f"torch.mv of the cost product alone {mv_ms:.4f} ms")
    r_ms = graph_ms(torch, lambda: ops.bid_eval(*round_book))
    rp_ms = graph_ms(torch, lambda: ops.bid_eval(*round_book, plain=True), DENSE_PLAIN_CALLS)
    rb_ms, rb_by = dense_bound(*round_book)
    log(f"  bid_eval bid_eval_round 100000x4 R=1000: {r_ms:.4f} ms, plain {rp_ms:.4f} ms "
        f"({DENSE_PLAIN_CALLS}-call graphs), bound {rb_ms:.4f} ms ({rb_by})")
    # the warm-started economy's cold epoch 0, its clock alone: the rest of
    # the epoch's wall-clock is host work
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = pt.clock_auction(eco_prob, eco_prices, probe.clock,
                           demand_fn=ops.blocked_bid_demand_fn(probe.settle_blocks))
    clock_rounds = int(res.rounds)
    eco_clock_ms = (time.perf_counter() - t0) * 1e3
    check(clock_rounds == epoch_rounds["warm-started"][0], "epoch 0's book replays its rounds")
    log(f"  economy epoch 0 clock alone: {clock_rounds} rounds in {eco_clock_ms:.1f} ms "
        f"({eco_clock_ms / clock_rounds * 1e3:.1f} us a round)")

    # -- 4. the main path on the card, against itself -------------------------
    log("[4] fleet_economy(10_000, 8, seed=0), 2 epochs: kernels vs plain versions on the card")
    last_k: dict = {}
    last_p: dict = {}
    eco_k = pt.fleet_economy(10_000, 8, seed=0, warm_start=True, device=dev)
    eco_p = pt.fleet_economy(10_000, 8, seed=0, warm_start=True, device=dev)
    eco_k.demand_fn = recording(eco_k.demand_fn, last_k)
    eco_p.demand_fn = recording(
        ops.blocked_bid_demand_fn(eco_p.settle_blocks, plain=True), last_p)
    for epoch in range(2):
        sk, sp_ = eco_k.run_epoch(), eco_p.run_epoch()
        check(np.array_equal(sk.prices, sp_.prices), f"10k epoch {epoch}: prices differ")
        check(sk.rounds == sp_.rounds, f"10k epoch {epoch}: rounds {sk.rounds} vs {sp_.rounds}")
        check(torch.equal(last_k["chosen"], last_p["chosen"]), f"10k epoch {epoch}: chosen")
        check(sk.converged and sk.system_ok, f"10k epoch {epoch} not converged/feasible")
        log(f"  epoch {epoch}: {sk.rounds} rounds, prices and chosen bit-identical")
    check(np.array_equal(eco_k.pop.placed, eco_p.pop.placed), "10k placement differs")
    log("[4] provisioning: quickstart and elastic-training books to device grants, "
        "bid_eval vs its plain version on the card")
    for label, book in provisioning_books(pt, np, dev).items():
        prob, tilde_p, pools, user_jobs, config = book
        start = torch.from_numpy(np.asarray(tilde_p, np.float32)).to(dev)
        results = {
            plain: pt.clock_auction(prob, start, config, ops.bid_demand_fn(plain=plain))
            for plain in (False, True)
        }
        grants = {
            plain: pt.grants_from_allocation(
                res, ["team-A", "team-B", "team-C"], [p.cluster for p in pools],
                [p.rtype for p in pools], user_jobs)
            for plain, res in results.items()
        }
        rk, rp = results[False], results[True]
        check(torch.equal(rk.prices, rp.prices) and int(rk.rounds) == int(rp.rounds)
              and torch.equal(rk.chosen_bundle, rp.chosen_bundle), f"{label}: kernel vs plain")
        check(grants[False] == grants[True] and len(grants[False]) > 0, f"{label}: grants differ")
        flags = pt.verify_system(prob, rk)
        check(all(flags.values()), f"{label}: SYSTEM {flags}")
        log(f"  {label}: {int(rk.rounds)} rounds, prices {rk.prices.tolist()}, grants "
            f"{[(g.job, g.cluster, g.chips, round(g.unit_price, 4)) for g in grants[False]]}; "
            f"prices, rounds, chosen and grants bit-identical, SYSTEM feasible")

    padded_src = {"route": "cuda", "source": "src/repro_torch/kernels/csrc/sparse_bid_eval.cu",
                  "replaces": "src/repro/kernels/sparse_bid_eval.py:124", "library_ms": None}
    kernels = [
        {"name": "bid_eval", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/clock_bid_eval.cu",
         "replaces": "src/repro/kernels/clock_bid_eval.py:91", "library_ms": None,
         "launches": path_launches["dense"]["bid_eval"], "max_abs_err": dense_err, "ms": d_ms,
         "plain_ms": dp_ms, "bound_ms": db_ms, "bound_by": db_by,
         "path": "standalone clock, dense book",
         "shape": f"U={du} B={db} R={dr} scalar pi", "torch_mv_ms": mv_ms,
         "bid_eval_round": {"shape": "U=100000 B=4 R=1000", "ms": r_ms, "plain_ms": rp_ms,
                            "bound_ms": rb_ms}},
        {"name": "sparse_bid_eval_partials", **padded_src,
         "launches": path_launches["economy"]["sparse_bid_eval_partials"],
         "max_abs_err": parts_err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
         "bound_by": b_by, "path": "fleet economy, 6 epochs",
         "shape": f"U={u} B={b} K={k} R={r} vector pi, num_blocks=8",
         "synthetic_planet_books": synthetic},
        {"name": "sparse_bid_eval_z", **padded_src,
         "launches": path_launches["padded"]["sparse_bid_eval_z"],
         "max_abs_err": z_err, "ms": z_ms, "plain_ms": zp_ms, "bound_ms": zb_ms,
         "bound_by": zb_by, "path": "standalone clock, padded book",
         "shape": f"U={pu} B={pb} K={pk} R=1000 scalar pi"},
        {"name": "sparse_bid_eval_csr_z", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sparse_bid_eval_csr.cu",
         "replaces": "src/repro/kernels/sparse_bid_eval_csr.py:126", "library_ms": None,
         "launches": path_launches["csr"]["sparse_bid_eval_csr_z"],
         "max_abs_err": csr_err, "ms": c_ms, "plain_ms": cp_ms, "bound_ms": cb_ms,
         "bound_by": cb_by, "path": "standalone clock, CSR book",
         "shape": f"U={planet_csr.num_users} B={planet_csr.num_bundles} nnz={planet_csr.nnz} "
                  f"k_bound={planet_csr.k_bound} R=1000 scalar pi"},
    ]
    return kernels


# ---------------------------------------------------------------------------
# [5] rwkv6-7b serving through wkv6
# ---------------------------------------------------------------------------

MUFU_PER_CLOCK_PER_SM = 16  # H100 SFU throughput (exp2, log2) a clock on one SM
H100_SMS = 132
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 500, 32
WKV6_TOL = 1e-4  # max|kernel - plain| <= WKV6_TOL * max|plain|, for o and the state
LOGITS_TOL = 1e-3  # float32 model: max|delta logits| <= LOGITS_TOL * max|logits|
DECODE_GRAPH_CALLS = 2  # decode steps captured in one timed graph (each reads 30 GB)


@contextlib.contextmanager
def wkv6_calls(ops, wrap):
    """While active, the model's ``ops.wkv6`` calls go through
    ``wrap(kernel_wrapper, *args)``: to record their inputs, or to force the
    plain version."""
    kernel_wrapper = ops.wkv6
    ops.wkv6 = functools.partial(wrap, kernel_wrapper)
    try:
        yield
    finally:
        ops.wkv6 = kernel_wrapper


def force_plain(fn, *args, **kwargs):
    return fn(*args, plain=True, **kwargs)


def sm_clock_hz() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout
    return float(out.strip().splitlines()[0]) * 1e6


def wkv6_bound(r, k, v, w, u, state, chunk) -> tuple[float, str, dict]:
    """(bound_ms, bound_by, parts) of one wkv6 call: the largest of bytes
    (r, k, v at their dtype, w, u and the initial state read; o and the
    final state written in float32) over the HBM rate; the exponentials and
    logs the chunked algebra needs over the SFU rate; its float32 FMAs (two
    operations each) over the float32 peak."""
    b, t, h, kd = r.shape
    vd = v.shape[-1]
    L = min(chunk, t)
    n_chunks = -(-t // L)
    read = nbytes(r, k, v, w, u) + (0 if state is None else nbytes(state))
    write = 4 * b * t * h * vd + 4 * b * h * kd * vd
    sfu = b * h * n_chunks * (L * (L - 1) // 2 * kd + 2 * L * kd + kd) + b * h * t * kd
    fmas = b * h * n_chunks * (2 * L * kd * vd + L * (L - 1) // 2 * (kd + vd) + L * vd)
    parts = {"bytes": (read + write) / HBM_BYTES_PER_S * 1e3,
             "sfu": sfu / (MUFU_PER_CLOCK_PER_SM * H100_SMS * sm_clock_hz()) * 1e3,
             "fma": 2 * fmas / FP32_OPS_PER_S * 1e3}
    by = max(parts, key=parts.get)
    return parts[by], "bytes" if by == "bytes" else "operations", parts


def check_wkv6(torch, ops, args, label, quiet=False) -> float:
    """The kernel against its plain version on one call's inputs → max|o err|."""
    o, s = ops.wkv6(*args)
    torch.cuda.synchronize()
    o_ref, s_ref = ops.wkv6(*args, plain=True)
    errs = {}
    for name, got, want in (("o", o, o_ref), ("state", s, s_ref)):
        errs[name] = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(bool(torch.isfinite(got).all()) and errs[name] <= WKV6_TOL * scale,
              f"wkv6 {label}: {name} off by {errs[name]} (max|{name}| {scale})")
    if not quiet:
        log(f"  wkv6 {label}: max|o err| {errs['o']:.3g} (max|o| {float(o_ref.abs().max()):.4g}), "
            f"max|state err| {errs['state']:.3g} (max|state| {float(s_ref.abs().max()):.4g})")
    return errs["o"]


WKV6_EDGE_T = (1, 31, 32, 33, 500)
WKV6_EDGE_KV = ((64, 64), (16, 96), (12, 20))  # served; padded K and a ragged V block; unaligned rows


def check_wkv6_edges(torch, ops, dev) -> float:
    """wkv6 within WKV6_TOL at T in WKV6_EDGE_T, float32 and bf16 r/k/v,
    with and without an initial state, strong decay (w down to 1e-30), B = 2
    and H = 4 at each (K, V) of WKV6_EDGE_KV → the largest max|o err|."""
    g = torch.Generator(device=dev).manual_seed(3)
    worst = 0.0
    n = 0
    for kd, vd in WKV6_EDGE_KV:
        for t in WKV6_EDGE_T:
            for dtype in (torch.float32, torch.bfloat16):
                for with_state in (False, True):
                    def rand(*shape, scale=1.0):
                        return torch.randn(shape, generator=g, device=dev) * scale

                    w = torch.exp(-torch.exp(rand(2, t, 4, kd)))
                    w[..., : kd // 4] = 1e-30  # strong decay: log w = -69
                    args = (rand(2, t, 4, kd).to(dtype), rand(2, t, 4, kd, scale=0.5).to(dtype),
                            rand(2, t, 4, vd).to(dtype), w, rand(4, kd, scale=0.3),
                            rand(2, 4, kd, vd, scale=0.2) if with_state else None, 32)
                    label = f"T={t} K={kd} V={vd} {dtype} {'with' if with_state else 'no'} state"
                    worst = max(worst, check_wkv6(torch, ops, args, label, quiet=True))
                    n += 1
    log(f"  wkv6 at {n} edge shapes (T in {WKV6_EDGE_T}, (K, V) in {WKV6_EDGE_KV}, float32 and "
        f"bf16, with and without s0, w down to 1e-30): within {WKV6_TOL} x max|plain|, "
        f"max|o err| {worst:.3g}")
    return worst


def serving(torch, dev) -> dict:
    """Phase [5]: rwkv6-7b at full width and depth serves 4 requests of 500
    prompt tokens and 32 greedy new ones; its prefill runs the recurrence
    through ``wkv6`` → the kernel's entry."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import get_api
    from repro_torch.models.params import count_params, init_params
    from repro_torch.serve.decode import generate

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    cfg = get_config("rwkv6-7b")
    api = get_api(cfg)
    log(f"[5] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.d_model // cfg.rwkv.head_size} heads of {cfg.rwkv.head_size}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, activations {cfg.act_dtype}, "
        f"{count_params(api.decls(cfg)):,} float32 parameters from seed 0")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(0), api.decls(cfg),
                         torch.float32, dev)
    torch.cuda.synchronize()
    log(f"  init {time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 1e9:.2f} GB "
        f"on the card")
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))

    # -- the main path: its launches counted alone; layer 0's and the last
    #    layer's wkv6 inputs recorded for the checks below
    calls = []

    def record(fn, *args):
        calls.append(args if len(calls) in (0, cfg.num_layers - 1) else None)
        return fn(*args)

    with wkv6_calls(ops, record):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = generate(params, cfg, prompt, SERVE_NEW)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = ops.launch_counts()
    log(f"  generate {SERVE_BATCH} x ({SERVE_PROMPT} prompt + {SERVE_NEW} new) greedy: "
        f"{serve_s * 1e3:.1f} ms, {SERVE_BATCH * SERVE_NEW / serve_s:.1f} new tok/s; launches "
        f"{launches}")
    check(launches["wkv6"] == cfg.num_layers,
          f"wkv6 launched {launches['wkv6']} times, not once a layer ({cfg.num_layers})")
    check(sum(launches.values()) == launches["wkv6"], "another kernel ran on the serving path")
    check(tuple(out.shape) == (SERVE_BATCH, SERVE_PROMPT + SERVE_NEW)
          and torch.equal(out[:, :SERVE_PROMPT], prompt.to(torch.int32))
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()), "generated tokens")
    log(f"  request 0 continues with {out[0, SERVE_PROMPT:].tolist()}")

    # -- the same requests again, prefill and decode timed apart: the same
    #    tokens come out
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache = api.init_cache(cfg, SERVE_BATCH, SERVE_PROMPT + SERVE_NEW, device=dev)
    with torch.inference_mode():
        logits, cache = api.decode_step(params, cache, prompt, 0, cfg)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_logits = logits
        cur = logits[:, -1].float().argmax(-1, keepdim=True).to(torch.int32)
        toks = [cur]
        t0 = time.perf_counter()
        for i in range(SERVE_PROMPT, SERVE_PROMPT + SERVE_NEW - 1):
            logits, cache = api.decode_step(params, cache, cur, i, cfg)
            cur = logits[:, -1].float().argmax(-1, keepdim=True).to(torch.int32)
            toks.append(cur)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / (SERVE_NEW - 1)
    check(torch.equal(torch.cat(toks, 1), out[:, SERVE_PROMPT:]), "a second run gives other tokens")
    # device time of one decode step, replayed from a CUDA graph: the rest of
    # the host-clock step is the card waiting for the host
    with torch.inference_mode():
        step_ms = graph_ms(torch, lambda: api.decode_step(params, cache, cur, SERVE_PROMPT, cfg),
                           DECODE_GRAPH_CALLS)
    check(bool(torch.isfinite(prefill_logits.float()).all())
          and tuple(prefill_logits.shape) == (SERVE_BATCH, SERVE_PROMPT, cfg.vocab_size),
          "prefill logits")
    log(f"  prefill {SERVE_BATCH} x {SERVE_PROMPT}: {prefill_ms:.1f} ms "
        f"({SERVE_BATCH * SERVE_PROMPT / prefill_ms * 1e3:.0f} prompt tok/s); decode "
        f"{decode_ms:.2f} ms a step of {SERVE_BATCH} tokens "
        f"({SERVE_BATCH / decode_ms * 1e3:.1f} tok/s), of which {step_ms:.2f} ms on the card "
        f"(a CUDA graph of the step; idle {1 - step_ms / decode_ms:.1%}); peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # -- the kernel against its plain version on the served tensors ----------
    first, last = calls[0], calls[cfg.num_layers - 1]
    err = max(check_wkv6(torch, ops, first, "layer 0 of the served prefill"),
              check_wkv6(torch, ops, last, f"layer {cfg.num_layers - 1} of the served prefill"))
    _, s_first = ops.wkv6(*first, plain=True)
    ragged = tuple(a[:, :37].contiguous() for a in first[:4]) + (first[4], s_first, first[6])
    err = max(err, check_wkv6(torch, ops, ragged, "T=37 from a non-zero state"))
    check_wkv6_edges(torch, ops, dev)
    k_ms = graph_ms(torch, lambda: ops.wkv6(*first))
    p_ms = graph_ms(torch, lambda: ops.wkv6(*first, plain=True), DENSE_PLAIN_CALLS)
    b_ms, b_by, parts = wkv6_bound(*first)
    r = first[0]
    shape = (f"B={r.shape[0]} T={r.shape[1]} H={r.shape[2]} K={r.shape[3]} "
             f"V={first[2].shape[3]} L={min(first[6], r.shape[1])}, r/k/v {r.dtype}")
    log(f"  wkv6 {shape}: {k_ms:.4f} ms, plain {p_ms:.4f} ms ({DENSE_PLAIN_CALLS}-call graphs), "
        f"bound {b_ms:.4f} ms ({b_by}; bytes {parts['bytes']:.4f}, exp/log {parts['sfu']:.4f}, "
        f"FMAs {parts['fma']:.4f})")
    del calls, first, last, ragged, s_first

    # -- the whole model, kernel against plain ------------------------------
    cfg32 = cfg.replace(act_dtype="float32")
    with torch.inference_mode():
        def prefill(c, tokens):
            return api.decode_step(params, api.init_cache(c, tokens.shape[0], tokens.shape[1],
                                                          device=dev), tokens, 0, c)[0]

        short = prompt[:, :128]
        got = prefill(cfg32, short)
        with wkv6_calls(ops, force_plain):
            want = prefill(cfg32, short)
        d32 = float((got - want).abs().max())
        scale = float(want.abs().max())
        check(d32 <= LOGITS_TOL * scale, f"float32 model: logits off by {d32} (max {scale})")
        with wkv6_calls(ops, force_plain):
            want16 = prefill(cfg, prompt).float()
        got16 = prefill_logits.float()
        d16 = float((got16 - want16).abs().max())
        mean16 = float((got16 - want16).abs().mean())
        agree = int((got16.argmax(-1) == want16.argmax(-1)).sum())
        # the bf16 model's own rounding, for scale: the same prompt with
        # float32 activations, both through the kernel
        del want16
        full32 = prefill(cfg32, prompt)
        d_act = float((got16 - full32).abs().max())
        mean_act = float((got16 - full32).abs().mean())
        agree_act = int((got16.argmax(-1) == full32.argmax(-1)).sum())
        del full32
        positions = got16.shape[0] * got16.shape[1]
        log(f"  whole model, wkv6 kernel vs plain: float32 activations, {SERVE_BATCH} x "
            f"{short.shape[1]}: "
            f"max|d logits| {d32:.3g} of max|logits| {scale:.4g} (limit {LOGITS_TOL} x); "
            f"bf16, {SERVE_BATCH} x {SERVE_PROMPT}: max|d logits| {d16:.3g} (mean {mean16:.3g}) of "
            f"{float(got16.abs().max()):.4g}, greedy tokens agree at {agree} of {positions} "
            f"positions")
        log(f"  bf16 against float32 activations, both through wkv6, {SERVE_BATCH} x "
            f"{SERVE_PROMPT}: max|d logits| {d_act:.3g} (mean {mean_act:.3g}), greedy tokens "
            f"agree at {agree_act} of {positions} positions")
        del got, want, got16, prefill_logits

        # -- chunked prefill (the kernel) against token-by-token decode (the
        #    closed form), float32 activations, request 0's first 64 tokens
        one = prompt[:1, :64]
        chunked = prefill(cfg32, one)
        cache = api.init_cache(cfg32, 1, 64, device=dev)
        steps = []
        for i in range(one.shape[1]):
            logits, cache = api.decode_step(params, cache, one[:, i:i + 1], i, cfg32)
            steps.append(logits[:, 0])
        stepped = torch.stack(steps, dim=1)
        per_pos = (chunked - stepped).abs().amax(dim=(0, 2))
        scale = float(stepped.abs().max())
        check(float(per_pos.max()) <= LOGITS_TOL * scale,
              f"chunked prefill vs decode: max|d| {float(per_pos.max())} (max {scale})")
        log(f"  chunked prefill vs token-by-token decode, float32, {one.shape[1]} positions: "
            f"max|d logits| "
            f"{float(per_pos.max()):.3g} (worst position {int(per_pos.argmax())}) of "
            f"max|logits| {scale:.4g} (limit {LOGITS_TOL} x)")
    del params, cache
    torch.cuda.empty_cache()
    return {"name": "wkv6", "route": "cuda", "source": "src/repro_torch/kernels/csrc/wkv6.cu",
            "replaces": "src/repro/kernels/wkv6.py:93", "launches": launches["wkv6"],
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "path": f"{cfg.name} serving, chunked prefill of {SERVE_BATCH} x {SERVE_PROMPT}",
            "shape": shape, "prefill_ms": prefill_ms, "decode_ms_per_step": decode_ms,
            "decode_device_ms_per_step": step_ms,
            "serve_ms": serve_s * 1e3}


def run(torch, np) -> dict:
    from repro_torch.kernels import build

    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    # -- 1. build -------------------------------------------------------------
    build_s = build.build_all()
    log(f"[1] built {', '.join(build.SOURCES)} with nvcc for sm_90a in {build_s:.2f} s")

    dev = torch.device("cuda")
    kernels = market_paths(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()  # the dense books leave the card before the model comes
    kernels.append(serving(torch, dev))
    log(smi)
    log(json.dumps({"kernels": kernels}))
    return {"ok": True, "device": {"platform": "gpu", "kind": kind,
                                   "count": torch.cuda.device_count()}}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    result = run(torch, np)
    log(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
