#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written Hopper kernels from ``src/repro_torch/kernels/csrc``,
holds each against its plain PyTorch version on the card, drives the port's
main path at full size, and checks the main path on the card against itself
through the plain versions.  The main path is four paths, each driven with
the launch counts set to 0 just before it and read just after: the
100k-agent §V economy (three binding epochs warm-started, three with cold
restarts) through ``sparse_bid_eval_partials``; the 100k x 1k standalone
clock through ``sparse_bid_eval_csr_z`` (CSR book) and ``sparse_bid_eval_z``
(padded book); and the same market densified, the paper's §III encoding,
through ``bid_eval``.  Each kernel is then held against its plain version and
timed at its path's shapes on its path's inputs.  Phase [4] also provisions
the quickstart and elastic-training books to device grants through
``bid_eval`` and through its plain version.  Any failed check raises; nothing
is caught and carried on.

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
(non-tensor) peaks.
"""
from __future__ import annotations

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
    check(torch.equal(parts, parts_ref), f"{label}: partials off by {parts_err}")
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


def time_at_check_shape(torch, kernel, fn, bound_) -> None:
    ms = graph_ms(torch, fn)
    log(f"    {kernel}: {ms:.4f} ms, bound {bound_[0]:.4f} ms ({bound_[1]})")


def recording(fn, last: dict):
    """``fn`` that also keeps the chosen bundles of its latest call."""

    def demand(*args):
        out = fn(*args)
        last["chosen"] = out[1]
        return out

    demand.__dict__.update(fn.__dict__)
    return demand


def run(torch, np) -> dict:
    from repro_torch import core as pt
    from repro_torch.kernels import build, ops, ref

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {kind}")

    # -- 1. build -------------------------------------------------------------
    build_s = build.build_all()
    log(f"[1] built {', '.join(build.SOURCES)} with nvcc for sm_90a in {build_s:.2f} s")

    # -- 2. kernels against their plain versions ----------------------------
    log("[2] kernels against their plain versions")
    for vector_pi in (False, True):
        book = synthetic_book(torch, np, dev, 100_000, 4, 8, 1_000, vector_pi, seed=1)
        label = f"100000x4x8 R=1000 {'vector' if vector_pi else 'scalar'} pi"
        check_padded_kernel(torch, ops, ref, book, label)
        time_at_check_shape(torch, "sparse_bid_eval z mode",
                            lambda: ops.sparse_bid_eval(*book, 1_000),
                            padded_bound(*book, out_bytes=4 * 1_000))
        time_at_check_shape(torch, "sparse_bid_eval partials",
                            lambda: ops.sparse_bid_eval(*book, 1_000, 8),
                            padded_bound(*book, out_bytes=4 * 8 * 1_000))
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
         "shape": f"U={u} B={b} K={k} R={r} vector pi, num_blocks=8"},
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
