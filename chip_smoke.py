#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written Hopper kernels from ``src/repro_torch/kernels/csrc``
(six sources, one ``nvcc`` each, in parallel), holds each against its plain
PyTorch version on the card, drives the port's main path at full size, and
checks the main path on the card against itself through the plain versions.
The main path is its paths, each driven with the launch counts set to 0
just before it and read just after: the 100k-agent §V economy (three binding
epochs warm-started, three with cold restarts) through
``sparse_bid_eval_partials``, its epochs held bit for bit against the JAX
reference's run recorded in ``tools/fleet_100k_reference.json``; phase [6],
the same economy as one fused epoch program (``fused=True``: pack, clock,
settle, apply on the card as CUDA graphs) through ``sparse_bid_eval_partials``
and ``ordered_scatter_add``, held against the same recording; the 100k x 1k
standalone clock through
``sparse_bid_eval_csr_z`` (CSR book) and ``sparse_bid_eval_z`` (padded
book); the same market densified, the paper's §III encoding, through
``bid_eval``; and phase [5], ``rwkv6-7b`` at full width and depth (float32
weights from seed 0, bf16 activations) serving 4 requests of 500 prompt
tokens and 32 greedy new ones through ``serve.decode.generate``, its
chunked prefill running the WKV recurrence through ``wkv6`` once a layer;
and phase [7], the always-on market service: the port's service CLI
(``repro_torch.serve.market.main``) bridged from the same 100k economy into a
131,072-row ``MarketBook``, six ticks at 1% churn with a WAL and checkpoints
under a temporary directory and the CLI's in-process kill and resume after
tick 3, every tick settled through ``sparse_bid_eval_partials`` and held
against the JAX reference's run of the same CLI recorded in
``tools/service_100k_reference.json`` (prices, psi, rounds, flags,
counters, health and the sha256 of every book array bit for bit; the
payment-derived stats to rtol 1e-5), with each tick's stages timed;
and phase [8], the scenario engine: the nine library scenarios
(``SCENARIOS[name](seed=3)``, their own epochs) and two scenarios on the
100k economy (``flash_crowd``'s event stream, ``region_loss``'s fault model)
through ``run_scenario``, every epoch settled through
``sparse_bid_eval_partials`` and held against the JAX reference's runs
recorded in ``tools/scenario_reference.json``, then the clock sharded over
a one-rank NCCL process group (``sharded_clock_auction``, the collective
captured in the clock's CUDA graph) held bit for bit against the unsharded
clock and the 100k economy with ``settle_mesh`` against
``tools/fleet_100k_reference.json``;
and phase [9], the dense family and training: ``qwen3-1.7b`` at full width
and depth (float32 weights from seed 0, bf16 activations) serving 4
requests of 128 prompt tokens and 32 greedy new ones, trained through
``launch/train`` for 6 steps at batch 4 x 512 and again with checkpoints
every 3 steps, killed by ``--fault-step`` and resumed, its steps timed by
part; one train step at full width and 2 layers on the card against the
CPU; and the example twins on the card (``elastic_train_torch.py
--production``, its two auctions through ``bid_eval``; ``quickstart_torch.py``
through ``bid_eval``; ``market_sim_torch.py`` and
``market_service_demo_torch.py`` through ``sparse_bid_eval_partials``);
its training's embedding gradients go through ``ordered_rows_add``, and
the resumed losses are held bit for bit;
and phase [10], MoE with MLA and deterministic training:
``deepseek-v3-671b`` at full width cut to 4 layers (3 dense, 1 routed of
256 experts; float32 weights from seed 0, bf16 activations) serving 4
requests of 128 prompt tokens and 16 greedy new ones, every step's MoE
combine through ``ordered_rows_add``, held against itself with the kernel
forced plain (logits bit for bit) and its chunked prefill (absorbed MLA)
against ``lm_forward`` (expanded MLA); the deepseek-v3 and kimi-k2 smoke
configs trained through ``launch/train``, killed and resumed bit for bit,
and one step card against CPU; ``run_supervised`` restarting the trainer
on the card after a ``FAULT_STEP`` crash, bit for bit; and one step of
``qwen3-1.7b`` at 2 layers and of the deepseek smoke config under
``torch.use_deterministic_algorithms(True)`` in a process of its own, two
steps' gradients equal.  ``ordered_rows_add`` is held bit for bit
(``same_bits``, eager and replayed from a CUDA graph) at the prefill's and
a decode step's combine, the qwen3 embedding gradient, and edge shapes on
each of its three routes (``rows_edges``); each call's route and the
kernels it launches (``torch.profiler``) are logged, and at the path's
calls it is timed whole and as its partition and its fold;
and phase [11], the hybrid, audio and VLM families at full width and depth
(float32 weights from seed 0, bf16 activations): ``recurrentgemma-2b``
serving 4 requests of 64 prompt tokens warmed token by token and 32 greedy
new ones, ``lm_forward`` prefills at 4 x 2,048 and 1 x 8,192 (blockwise
attention, window 2,048), token-by-token decode against ``lm_forward``,
the RG-LRU scan timed alone; ``whisper-medium``'s ``whisper_prefill`` of
2 x 1,500 frames, 32 greedy steps against its cross cache held against
the teacher-forced decoder, and ``generate`` as the reference runs it;
``pixtral-12b`` prefilling 2 x (256 patches + 256 text) and generating 32
greedy tokens; the three trained through ``launch/train`` (``pixtral-12b``
cut to 6 layers) twice in a process of its own under
``torch.use_deterministic_algorithms(True)``, every loss bit for bit, their
embedding gradients through ``ordered_rows_add``, which is then held and
timed at those three shapes, and their smoke configs killed after a
checkpoint and resumed, every loss bit for bit; and each smoke config on
the card against the CPU;
and phase [12], sharding: ``launch/train --mesh 1x1`` (2 steps of
``qwen3-1.7b`` at 4 x 512) and ``launch/serve --mesh 1x1`` (4 x (128 + 32)
greedy), the plain path, their losses and every request's ids held to
phase [9]'s bit for bit; then the ``qwen3-1.7b`` smoke train state saved on
the card after step 1 and restored by ``elastic_restore`` onto a 2-rank
gloo world on the CPU that the script spawns, as 1x2 and 2x1: every leaf
bit for bit, the next step's loss held to the card's (rtol 1e-5), with the
restore, gather and save walls;
and phase [13], the dry run and roofline, in a process of its own: phase
[9]'s ``qwen3-1.7b`` train step (4 x 512, float32 weights, AdamW) and serve
decode step counted on a 1x1 ``cuda`` mesh of fake tensors
(``launch.dryrun.count_cell``), each as a roofline with the H100's float32
peak beside phase [9]'s measured step and peak memory (the train step must
take at least its counted bound, its counted parameter and AdamW-state bytes
must equal the live state's, and one real step on the card counted by the
same mode must give the same flops, bytes and collectives); then
``python -m repro_torch.launch.dryrun --arch qwen3-1.7b`` for ``decode_32k``
and ``train_4k`` on the 16x16 mesh of a fake 256-rank world, both ``ok``.
Fake tensors launch no kernel.
Each kernel is then held against its plain version and timed at its path's
shapes on its path's inputs (for ``wkv6``, the tensors layer 0 and layer 31
hand it in the served prefill).  Phase [4] also provisions the quickstart
and elastic-training books to device grants through ``bid_eval`` and
through its plain version; phase [5] also runs the whole model with
``wkv6`` forced to its plain version, and the chunked prefill against
token-by-token decode; phase [6] also runs the fused economy pipelined
against sequential epochs, the protocol economies fused on the card against
the same on the CPU, a 10k fused economy through the kernels against their
plain versions, and the 100k fused economy with the z-mode in-loop z.  Every
clock replays one captured chunk of ``CHECK_EVERY`` rounds as a CUDA graph,
and launch counts include the replays.  Phase [2] also holds ``sparse_bid_eval_partials``
against its plain version bit for bit at edge books across every fold
regime (PARTIALS_EDGE_M rows a block, padded and not, 8 and 1 blocks, R in
PARTIALS_EDGE_R, repeated pools, -0.0, masked and priced-out users), and
phase [5] holds ``wkv6`` within WKV6_TOL at edge shapes (WKV6_EDGE_T
tokens, float32 and bf16, with and without an initial state, w down to
1e-30).  Phase [2] also holds both z-mode kernels against their plain
versions (chosen exact, z within ``z_tolerance``) at edge books: U around
the span plan's span and at 101,000, R in Z_EDGE_R (4,097 past the staged
prices), every user out, a padded book read in place, CSR empty bundles and
a CSR user longer than the staging budget, whose CTA takes the kernel's
branch that reads its elements from device memory.  Phase [6] also holds
``ordered_scatter_add`` against its plain version bit for bit at the
pack's supply call, the settle's usage call rebuilt from warm epoch 1 and
cold epoch 0, 100,000 placed rows and the edge streams of
``scatter_edges`` (1M rows into one target, 255 targets with an int64
index past int32, float64 rows of 8, every row dropped), and times each
whole and as its partition and its fold.  Any failed check raises;
nothing is caught and carried on.

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
``ordered_scatter_add``'s and ``ordered_rows_add``'s bounds are the larger
of their bytes and their chain: the longest target's kept rows times the
dependent add latency that ``add_chain_probe`` measures on the card in the
same run.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import gc
import hashlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

REFERENCE = ROOT / "tools" / "fleet_100k_reference.json"  # tools/record_reference.py
SERVICE_REFERENCE = ROOT / "tools" / "service_100k_reference.json"  # tools/record_service_reference.py
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


def live_bound(idx, val, mask, pi, prices, out_bytes: int) -> tuple[float, str]:
    """A K-padded book where only valid bundles need their K (idx, val) pairs
    and their pi read (a masked bundle is never priced); the mask is read for
    every slot.  2K operations a valid bundle for the cost, and the selection
    as in ``padded_bound``."""
    u, b, k = idx.shape
    valid = int(mask.sum())
    pi_bytes = 4 * valid if pi.ndim == 2 else nbytes(pi)
    ops = 2 * k * valid + u * b * (2 if pi.ndim == 2 else 1)
    return bound(8 * k * valid + pi_bytes + nbytes(mask, prices), out_bytes + 4 * u, ops)


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
    """Bit for bit: NaN where the other is NaN, every other bfloat16,
    float32 or float64 with the same bits (so -0.0 and +0.0 differ)."""
    if a.dtype != b.dtype:
        return False
    ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
    nan = torch.isnan(a)
    return bool(torch.equal(nan, torch.isnan(b))) and bool(torch.equal(
        torch.where(nan, 0, a.view(ints)), torch.where(nan, 0, b.view(ints))))


def z_tolerance(torch, sel_idx_flat, sel_val_flat, r):
    """Per-pool bound on the atomics' reordering error: 1e-5 of the summed
    |contributions| (float32 eps is 6e-8; a pool sums up to 10^5 terms)."""
    absz = torch.zeros(r, dtype=torch.float32, device=sel_idx_flat.device)
    absz.index_add_(0, sel_idx_flat.long(), sel_val_flat.abs())
    return 1e-5 * absz + 1e-6


def exact_z(torch, sel_idx_flat, sel_val_flat, r):
    """The chosen terms summed in float64: the plain version's z without its
    own float32 rounding.  On one pool of 3·10^5 terms spanning 1e-3..4e3
    (an edge book with R = 1) the float32 plain z strays past z_tolerance of
    this sum, so the edge books hold the kernel to it."""
    z = torch.zeros(r, dtype=torch.float64, device=sel_idx_flat.device)
    return z.index_add_(0, sel_idx_flat.long(), sel_val_flat.double())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def check_padded_kernel(torch, ops, ref, book, label, partials=True, quiet=False, edge=False):
    """z mode within tolerance, partials mode bit-identical, chosen exact
    → (max |z err|, max |partials err|).  z is held to z_tolerance of the
    plain version's chosen terms summed exactly and, except on an edge book,
    of the plain version's float32 z."""
    idx, val, mask, pi, prices = book
    r = prices.numel()
    z, chosen = ops.sparse_bid_eval(idx, val, mask, pi, prices, r)
    torch.cuda.synchronize()
    z_ref, chosen_ref = ref.sparse_bid_eval(idx, val, mask, pi, prices, r)
    sel_idx, sel_val, _, _ = ref.select_padded(idx, val, mask, pi, prices)
    tol = z_tolerance(torch, sel_idx.reshape(-1), sel_val.reshape(-1), r)
    z64 = exact_z(torch, sel_idx.reshape(-1), sel_val.reshape(-1), r)
    z_err = float((z - z_ref).abs().max())
    exact_err = float((z.double() - z64).abs().max())
    check(torch.equal(chosen, chosen_ref), f"{label}: z-mode chosen differs")
    check(bool(((z.double() - z64).abs() <= tol).all()), f"{label}: z off the exact sum by "
          f"{exact_err}")
    check(edge or bool(((z - z_ref).abs() <= tol).all()), f"{label}: z off by {z_err}")
    parts_err = None
    if partials:
        parts, chosen_p = ops.sparse_bid_eval(idx, val, mask, pi, prices, r, 8)
        torch.cuda.synchronize()
        parts_ref, _ = ref.sparse_bid_eval(idx, val, mask, pi, prices, r, 8)
        parts_err = float((parts - parts_ref).abs().max())
        check(torch.equal(chosen_p, chosen_ref), f"{label}: partials-mode chosen differs")
        check(same_bits(torch, parts, parts_ref), f"{label}: partials off by {parts_err}")
    if not quiet:
        log(f"  sparse_bid_eval {label}: chosen exact, partials max|err| {parts_err} "
            f"(bit-identical), z max|err| {z_err:.3g}, off the exact sum {exact_err:.3g} "
            f"(max|z| {float(z_ref.abs().max()):.6g})")
    return z_err, parts_err


def check_csr_kernel(torch, ops, ref, prob, prices, label):
    args = (prob.idx, prob.val, prob.offsets, prob.bundle_mask, prob.pi, prices)
    return check_csr_args(torch, ops, ref, args, prob.num_resources, prob.k_bound, label)


def check_csr_args(torch, ops, ref, args, r, k_bound, label, quiet=False, edge=False):
    """sparse_bid_eval_csr_z against its plain version: chosen exact, z
    within z_tolerance of the chosen terms summed exactly and, except on an
    edge book, of the plain float32 z → max |z err|."""
    idx, val, offsets, mask = args[:4]
    z, chosen = ops.sparse_bid_eval_csr(*args, r, k_bound)
    torch.cuda.synchronize()
    z_ref, chosen_ref = ref.sparse_bid_eval_csr(*args, r, k_bound)
    u, b = mask.shape
    rows = torch.repeat_interleave(torch.arange(u * b, device=idx.device),
                                   (offsets[1:] - offsets[:-1]).long())
    kept = chosen_ref.long()[rows // b] == rows % b
    terms = torch.where(kept, val, 0.0)
    tol = z_tolerance(torch, idx, terms, r)
    z64 = exact_z(torch, idx, terms, r)
    z_err = float((z - z_ref).abs().max())
    exact_err = float((z.double() - z64).abs().max())
    check(torch.equal(chosen, chosen_ref), f"{label}: csr chosen differs")
    check(bool(((z.double() - z64).abs() <= tol).all()), f"{label}: csr z off the exact sum "
          f"by {exact_err}")
    check(edge or bool(((z - z_ref).abs() <= tol).all()), f"{label}: csr z off by {z_err}")
    if not quiet:
        log(f"  sparse_bid_eval_csr {label}: chosen exact, z max|err| {z_err:.3g}, off the exact "
            f"sum {exact_err:.3g} (max|z| {float(z_ref.abs().max()):.6g}), nnz {idx.numel()}, "
            f"k_bound {k_bound}")
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


Z_EDGE_R = (1, 24, 128, 129, 1_000, 4_097)  # 4,097: the prices and z past shared memory


def z_edge_users(span: int) -> tuple[int, ...]:
    return (1, 31, span - 1, span, span + 1, 101_000)


def csr_edge_book(torch, np, dev, u, r, vector_pi, seed, all_out=False, long_user=0, b=4,
                  per_user=8):
    """Flat CSR streams: each user holds exactly ``per_user`` elements over
    ``b`` bundles (so the span plan does not move with U), empty bundles
    included, pools repeated inside bundles, masked and priced-out users;
    ``long_user`` > 0 gives user u // 2 that many elements more in bundle 0
    → (args, k_bound)."""
    rng = np.random.default_rng(seed)
    cuts = np.sort(rng.integers(0, per_user + 1, (u, b - 1)), axis=1)
    counts = np.diff(np.concatenate([np.zeros((u, 1), np.int64), cuts,
                                     np.full((u, 1), per_user)], axis=1), axis=1)
    counts[u // 2, 0] += long_user
    offsets = np.zeros(u * b + 1, np.int64)
    offsets[1:] = np.cumsum(counts.ravel())
    nnz = int(offsets[-1])
    idx = rng.integers(0, r, nnz).astype(np.int32)
    rep = rng.random(nnz) < 0.3
    rep[offsets[:-1][counts.ravel() > 0]] = False  # a bundle's first element
    idx[rep] = idx[np.flatnonzero(rep) - 1]
    val = (rng.uniform(-2, 4, nnz) * 10.0 ** rng.integers(-3, 4, nnz)).astype(np.float32)
    mask = rng.random((u, b)) < 0.8
    mask[rng.random(u) < 0.1] = False
    pi = rng.uniform(-5, 40, (u, b) if vector_pi else u).astype(np.float32)
    pi[rng.random(u) < 0.1] = -1e30
    if all_out:
        pi[:] = -np.inf
    prices = rng.random(r).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in
            (idx, val, offsets.astype(np.int32), mask, pi, prices)]
    return args, max(int(counts.max()), 1)


def csr_ctas_past_cap(ops, args, r, vector_pi) -> int:
    """CTAs of the CSR plan whose stretch is longer than its cap: they read
    their elements from device memory."""
    idx, offsets, mask = args[0], args[2], args[3]
    u, b = mask.shape
    plan = ops.csr_z_plan(u, b, idx.numel(), r, vector_pi)
    ends = offsets[::plan.span * b].tolist() + [int(offsets[-1])]
    return sum(e - s > plan.cap for s, e in zip(ends[:-1], ends[1:]))


def check_z_edges(torch, np, ops, ref, dev) -> int:
    """Both z kernels against their plain versions, chosen exact and z within
    z_tolerance of the plain selection's exact sum (``exact_z``): U in
    z_edge_users(span) x R in Z_EDGE_R x scalar and vector pi on adversarial
    books (repeated pools, masked and priced-out users, for CSR empty
    bundles); books where every user is out; a padded book whose B*K does
    not fit in shared memory; CSR books with one user longer than the
    staging budget → the number of books checked."""
    n = 0
    for r in Z_EDGE_R:
        for vector_pi in (False, True):
            span = ops.z_plan(4, 3, r, vector_pi).span
            for u in z_edge_users(span):
                book = adversarial_book(torch, np, dev, u, r, vector_pi, seed=n)
                check_padded_kernel(torch, ops, ref, book, f"z U={u} R={r} pi {vector_pi}",
                                    partials=False, quiet=True, edge=True)
                n += 1
            span = ops.csr_z_plan(1_000, 4, 8_000, r, vector_pi).span
            for u in z_edge_users(span):
                args, k_bound = csr_edge_book(torch, np, dev, u, r, vector_pi, seed=n)
                check(ops.csr_z_plan(u, 4, args[0].numel(), r, vector_pi).span == span,
                      "csr edge book: the span moved with U")
                check_csr_args(torch, ops, ref, args, r, k_bound,
                               f"csr z U={u} R={r} pi {vector_pi}", quiet=True, edge=True)
                n += 1
    for vector_pi in (False, True):
        book = adversarial_book(torch, np, dev, 5_000, 24, vector_pi, seed=n, all_out=True)
        check_padded_kernel(torch, ops, ref, book, "z every user out", partials=False,
                            quiet=True, edge=True)
        args, k_bound = csr_edge_book(torch, np, dev, 5_000, 1_000, vector_pi, seed=n,
                                      all_out=True)
        check_csr_args(torch, ops, ref, args, 1_000, k_bound, "csr z every user out", quiet=True,
                       edge=True)
        # B*K = 8,192 pairs a user: 32 users do not fit, the book is read in place
        book = adversarial_book(torch, np, dev, 2_000, 24, vector_pi, seed=n, k=2_048)
        check(not ops.z_plan(4, 2_048, 24, vector_pi).stage_book, "K = 2,048 staged")
        check_padded_kernel(torch, ops, ref, book, "z K=2048", partials=False, quiet=True,
                            edge=True)
        n += 3
    long_ctas = 0
    for r, vector_pi in ((1_000, False), (24, True)):
        cap = ops.csr_z_plan(20_000, 4, 160_000, r, vector_pi).cap
        args, k_bound = csr_edge_book(torch, np, dev, 20_000, r, vector_pi, seed=n,
                                      long_user=2 * cap)
        past = csr_ctas_past_cap(ops, args, r, vector_pi)
        check(past == 1, f"csr long user: {past} CTAs past the staging budget")
        check_csr_args(torch, ops, ref, args, r, k_bound,
                       f"csr z one user of {k_bound} elements, R={r}", quiet=True, edge=True)
        long_ctas += past
        n += 1
    log(f"  sparse_bid_eval_z and sparse_bid_eval_csr_z at {n} edge books (U in "
        f"{{1, 31, span-1, span, span+1, 101000}} x R in {Z_EDGE_R} x scalar and vector pi, "
        f"repeated pools, masked and priced-out users, CSR empty bundles; every user out; "
        f"K = 2,048 read in place; {long_ctas} CSR CTAs past the staging budget read from "
        f"device memory): chosen exact, z within z_tolerance")
    return n


def epoch_record(np, stats, eco) -> dict:
    """The bitwise fields of one epoch, as tools/record_reference.py records
    them: prices and reserves as bytes, rounds, migrations, flags and the
    sha256 of the population's placements after the epoch."""
    placed = np.ascontiguousarray(np.asarray(eco.pop.placed, np.int64))
    return {
        "prices": np.asarray(stats.prices).tobytes().hex(),
        "prices_dtype": str(np.asarray(stats.prices).dtype),
        "reserve": np.asarray(stats.reserve).tobytes().hex(),
        "reserve_dtype": str(np.asarray(stats.reserve).dtype),
        "rounds": int(stats.rounds), "migrations": int(stats.migrations),
        "converged": bool(stats.converged), "system_ok": bool(stats.system_ok),
        "placed_sha256": hashlib.sha256(placed.tobytes()).hexdigest(),
    }


def check_reference(run: str, got: list[dict]) -> None:
    """The card's epochs against the recorded JAX run ``run``, field by field."""
    want = json.loads(REFERENCE.read_text())["runs"][run]
    bad = [f"epoch {e} {k}" for e, (w, g) in enumerate(zip(want, got)) for k in w if g[k] != w[k]]
    check(len(got) == len(want) and not bad, f"{run}: differs from the recorded reference: {bad}")
    log(f"  {run}: {len(got)} epochs bit for bit as the recorded JAX reference (rounds "
        f"{[g['rounds'] for g in got]}, prices, reserves, migrations, flags, placed sha256)")


def recording(fn, last: dict):
    """``fn`` that also keeps the chosen bundles of its latest call.  The
    clock's rounds replay a CUDA graph, which calls no Python, so the latest
    call is the eager settle evaluation after the clock."""

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
    # off the main path: the synthetic planet books' partials and z times,
    # and the skewed CSR books'
    synthetic, synthetic_z, skewed = {}, {}, {}
    for vector_pi in (False, True):
        book = synthetic_book(torch, np, dev, 100_000, 4, 8, 1_000, vector_pi, seed=1)
        label = f"100000x4x8 R=1000 {'vector' if vector_pi else 'scalar'} pi"
        check_padded_kernel(torch, ops, ref, book, label)
        z_bound = padded_bound(*book, out_bytes=4 * 1_000)
        synthetic_z[label] = {"ms": time_at_check_shape(
            torch, "sparse_bid_eval z mode", lambda: ops.sparse_bid_eval(*book, 1_000), z_bound),
            "bound_ms": z_bound[0]}
        s_bound = padded_bound(*book, out_bytes=4 * 8 * 1_000)
        synthetic[label] = {"ms": time_at_check_shape(
            torch, "sparse_bid_eval partials", lambda: ops.sparse_bid_eval(*book, 1_000, 8),
            s_bound), "bound_ms": s_bound[0]}
    check_partials_edges(torch, np, ops, ref, dev)
    check_z_edges(torch, np, ops, ref, dev)
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
        c_bound = csr_bound(*args, 1_000)
        skewed[label] = {"ms": time_at_check_shape(
            torch, "sparse_bid_eval_csr",
            lambda: ops.sparse_bid_eval_csr(*args, 1_000, prob.k_bound), c_bound),
            "bound_ms": c_bound[0], "nnz": prob.nnz}

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
        records = []
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
            records.append(epoch_record(np, st, eco))
        check_reference(f"staged {label}", records)
    torch.cuda.synchronize()
    path_launches = {"economy": ops.launch_counts()}
    log(f"  CUDA graphs captured: {ops.capture_stats()}")
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
        captured = ops.capture_stats()
        log(f"  standalone clock 100000x1000 ({name}): {rounds} rounds, {wall * 1e3:.1f} ms "
            f"(of which capturing {captured['graphs']} graph {captured['seconds'] * 1e3:.1f} ms), "
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
    # z mode at the economy book: the fused epoch's in-loop z
    ez_ms = graph_ms(torch, lambda: ops.sparse_bid_eval(*eco_args, r))
    ez_bound = padded_bound(*eco_args, out_bytes=4 * r)
    log(f"  sparse_bid_eval_z {u}x{b}x{k} R={r} vector pi: {ez_ms:.4f} ms, "
        f"bound {ez_bound[0]:.4f} ms ({ez_bound[1]})")
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
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = pt.clock_auction(eco_prob, eco_prices, probe.clock,
                           demand_fn=ops.blocked_bid_demand_fn(probe.settle_blocks))
    clock_rounds = int(res.rounds)
    eco_clock_ms = (time.perf_counter() - t0) * 1e3
    capture_ms = ops.capture_stats()["seconds"] * 1e3
    check(clock_rounds == epoch_rounds["warm-started"][0], "epoch 0's book replays its rounds")
    log(f"  economy epoch 0 clock alone (staged): {clock_rounds} rounds in {eco_clock_ms:.1f} ms, "
        f"of which capturing the chunk graph {capture_ms:.1f} ms; "
        f"{(eco_clock_ms - capture_ms) / clock_rounds * 1e3:.1f} us a replayed round "
        f"(was 201.6 / 219.1 ms before the graphs)")

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
         "shape": f"U={pu} B={pb} K={pk} R=1000 scalar pi",
         "economy_book": {"shape": f"U={u} B={b} K={k} R={r} vector pi", "ms": ez_ms,
                          "bound_ms": ez_bound[0]},
         "synthetic_planet_books": synthetic_z},
        {"name": "sparse_bid_eval_csr_z", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/sparse_bid_eval_csr.cu",
         "replaces": "src/repro/kernels/sparse_bid_eval_csr.py:126", "library_ms": None,
         "launches": path_launches["csr"]["sparse_bid_eval_csr_z"],
         "max_abs_err": csr_err, "ms": c_ms, "plain_ms": cp_ms, "bound_ms": cb_ms,
         "bound_by": cb_by, "path": "standalone clock, CSR book",
         "shape": f"U={planet_csr.num_users} B={planet_csr.num_bundles} nnz={planet_csr.nnz} "
                  f"k_bound={planet_csr.k_bound} R=1000 scalar pi",
         "skewed_books": skewed},
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


# ---------------------------------------------------------------------------
# [6] the fused epoch program
# ---------------------------------------------------------------------------


def stats_bit_identical(np, sa, sb) -> bool:
    """Every EpochStats field the same, arrays bit for bit (NaN is NaN)."""
    da, db = dataclasses.asdict(sa), dataclasses.asdict(sb)
    for k, va in da.items():
        vb = db[k]
        if isinstance(va, np.ndarray):
            if va.dtype != vb.dtype or va.tobytes() != vb.tobytes():
                return False
        elif not (va == vb or (va != va and vb != vb)):
            return False
    return True


EXACT_FIELDS = ("prices", "reserve", "psi", "rounds", "migrations", "converged", "system_ok",
                "pct_settled", "clock_escalations", "rationed_rows")


def same_state(np, a, b) -> bool:
    return all(np.array_equal(getattr(a.pop, f), getattr(b.pop, f))
               for f in ("placed", "home", "fill_rate", "epoch")) and \
        np.array_equal(a.usage, b.usage) and np.array_equal(a.belief, b.belief)


def timed(torch, obj, name: str, sink: dict) -> None:
    """Wrap method ``name`` of ``obj``: each call's host ms, between device
    synchronisations, and the CUDA-graph capture ms inside it, go to
    ``sink[name]`` (for a fused program's ``_run``, to ``sink[stage]``)."""
    from repro_torch.kernels import ops

    inner = getattr(obj, name)

    def call(*args, **kw):
        torch.cuda.synchronize()
        cap0, t0 = ops.capture_stats()["seconds"], time.perf_counter()
        out = inner(*args, **kw)
        torch.cuda.synchronize()
        key = args[0] if name == "_run" else name
        sink.setdefault(key, []).append(((time.perf_counter() - t0) * 1e3,
                                         (ops.capture_stats()["seconds"] - cap0) * 1e3))
        return out

    setattr(obj, name, call)


def epoch_breakdown(torch, eco) -> dict:
    """Time a fused economy's epochs by part: the host's prepare (reserves,
    randomness, overlays), the device stages (pack, clock, settle, each
    from a synchronised start), the host's adopt (the copies back) and
    finalize (the stats)."""
    sink: dict = {}
    prog = eco._fused_program()
    for name in ("_fused_prepare", "_fused_adopt", "_fused_finalize"):
        timed(torch, eco, name, sink)
    timed(torch, prog, "_run", sink)
    timed(torch, prog, "_clock", sink)
    return sink


# ---------------------------------------------------------------------------
# ordered_scatter_add: its calls, their two bounds, the card's add latency
# ---------------------------------------------------------------------------

PROBE_ADDS = 2**20  # dependent adds the latency is read over


def add_latency_ns(torch) -> dict:
    """The card's dependent add latency (ns), float32 and float64:
    ``add_chain_probe`` (one thread, one chain of ``__fadd_rn`` or
    ``__dadd_rn``) timed with CUDA events at 2·PROBE_ADDS and PROBE_ADDS
    adds; their difference over PROBE_ADDS, so the launch cancels out."""
    from repro_torch.kernels import build

    probe = build.library("ordered_scatter").add_chain_probe
    probe.restype = ctypes.c_int
    probe.argtypes = (ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p)
    latency = {}
    for name, dtype in (("f32", torch.float32), ("f64", torch.float64)):
        out = torch.zeros(1, dtype=dtype, device="cuda")

        def chain(adds, out=out, is_double=int(dtype == torch.float64)):
            err = probe(adds, is_double, out.data_ptr(), torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"add_chain_probe: cudaError {err}")

        ms = {a: event_ms(torch, lambda a=a: chain(a), calls=5)
              for a in (PROBE_ADDS, 2 * PROBE_ADDS)}
        check(float(out) == 2 * PROBE_ADDS + 1, f"add_chain_probe {name}: sum {float(out)}")
        latency[name] = (ms[2 * PROBE_ADDS] - ms[PROBE_ADDS]) * 1e6 / PROBE_ADDS
    return latency


def scatter_halves(ops):
    """The kernel's two halves, ``ordered_scatter_partition`` (count, scan,
    place) and ``ordered_scatter_fold``, with ``ordered_scatter_add``'s
    arguments."""
    from repro_torch.kernels import build

    lib = build.library("ordered_scatter")
    halves = {}
    for half in ("partition", "fold"):
        f = getattr(lib, f"ordered_scatter_{half}")
        f.restype = ctypes.c_int
        f.argtypes = ops._SIGNATURES[("ordered_scatter", "ordered_scatter_add")]
        halves[half] = f
    return halves


def scatter_call(torch, ops, label, out, index, source, latency, halves) -> dict:
    """One ``ordered_scatter_add`` call held bit for bit against its plain
    version, then timed whole, as its partition and its fold alone, as
    ``index_add_`` of its kept rows (atomics, unordered) and as the plain
    version; with its kept rows, its longest chain and its two bounds: the
    byte bound (the index read once, the kept rows' values read once, out
    read and written once) and the chain bound (the longest chain × the
    dependent add latency)."""
    got = ops.ordered_scatter_add(out.clone(), index, source)
    want = ops.ordered_scatter_add(out.clone(), index, source, plain=True)
    check(same_bits(torch, got, want), f"ordered_scatter_add {label}: differs from the plain "
          f"version by up to {float((got - want).abs().max())}")
    n, width = out.shape[0], out[0].numel()
    keep = (index >= 0) & (index < n)
    kept_i, kept_s = index[keep], source[keep].to(out.dtype)
    kept, longest = int(keep.sum()), int(torch.bincount(kept_i.long(), minlength=n).max())
    buf = out.clone()
    ms = graph_ms(torch, lambda: ops.ordered_scatter_add(buf, index, source))
    args, held = ops.scatter_args(buf, index, source)

    def half(name):  # on the stream current at the call: graph_ms captures on its own
        err = halves[name](*args[:-1], torch.cuda.current_stream().cuda_stream)
        check(err == 0, f"ordered_scatter_{name}: cudaError {err}")

    half("partition")  # the fold alone folds this partition
    part_ms = graph_ms(torch, lambda: half("partition"))
    fold_ms = graph_ms(torch, lambda: half("fold"))
    lib_buf = out.clone()
    lib_ms = graph_ms(torch, lambda: lib_buf.index_add_(0, kept_i, kept_s)) if kept else None
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        ops.ordered_scatter_add(out.clone(), index, source, plain=True)
    plain_ms = (time.perf_counter() - t0) * 1e3 / 3
    byte_ms = (nbytes(index) + kept * width * source.element_size() + 2 * nbytes(out)) \
        / HBM_BYTES_PER_S * 1e3
    chain_ms = longest * latency["f64" if out.dtype == torch.float64 else "f32"] * 1e-6
    row = {
        "call": label, "rows": index.numel(), "kept": kept, "targets": n, "width": width,
        "dtype": str(out.dtype).removeprefix("torch."),
        "index_dtype": str(index.dtype).removeprefix("torch."), "longest_chain": longest,
        "ms": ms, "partition_ms": part_ms, "fold_ms": fold_ms, "byte_bound_ms": byte_ms,
        "chain_bound_ms": chain_ms, "bound_ms": max(byte_ms, chain_ms),
        "bound_by": "operations" if chain_ms > byte_ms else "bytes", "library_ms": lib_ms,
        "plain_ms": plain_ms, "max_abs_err": 0.0}
    log(f"  ordered_scatter_add {label}: {row['rows']} rows ({kept} kept, longest chain "
        f"{longest}) into {n} x {width} {row['dtype']}, {row['index_dtype']} index: {ms:.4f} ms "
        f"(partition {part_ms:.4f}, fold {fold_ms:.4f}); bounds: bytes {byte_ms:.4f}, chain "
        f"{chain_ms:.4f} ms; index_add_ (atomics, unordered) "
        f"{'-' if lib_ms is None else f'{lib_ms:.4f}'} ms; plain {plain_ms:.3f} ms; "
        "bit-identical to the plain version")
    return row


def keep_settle_inputs(torch, eco, sink: list) -> None:
    """Wrap ``eco._fused_adopt``: each epoch's copies of what the settle's
    usage call was built from (the placements and usage it started from,
    the winners, the bought clusters) and of the usage it ended with go to
    ``sink``; nothing is rebuilt until :func:`settle_usage_call`."""
    inner = eco._fused_adopt

    def adopt(prep, out):
        sink.append({"placed": prep["placed_eff"].copy(), "usage": eco.usage.copy(),
                     "cap_eff": prep["cap_eff"].copy(),
                     **{k: out[k].clone() for k in ("won_sell", "won_buy", "buy_cluster",
                                                    "usage_new")}})
        return inner(prep, out)

    eco._fused_adopt = adopt


def settle_usage_call(torch, ops, eco, kept: dict):
    """(out, index, source) of the settle's usage commit
    (``core/fused.py``, ``ration_fallback`` off): the sell, buy and move
    rows of every agent, 3N rows of T into C, only the winners' in range;
    checked to give the usage the epoch adopted."""
    dev = kept["won_buy"].device
    C = eco.C
    placed = torch.from_numpy(kept["placed"]).to(dev)
    won_sell, won_buy, bc = kept["won_sell"], kept["won_buy"], kept["buy_cluster"]
    old = torch.where(won_sell, -1, placed)
    move = won_buy & (old >= 0) & (old != bc)
    index = torch.cat([torch.where(won_sell, placed, C), torch.where(won_buy, bc, C),
                       torch.where(move, old, C)])
    req = torch.from_numpy(eco.pop.req).to(dev)
    source = torch.cat([-req, req, -req])
    usage = torch.from_numpy(kept["usage"]).to(dev)
    cap = torch.from_numpy(kept["cap_eff"]).to(dev)
    u = ops.ordered_scatter_add(usage.clone(), index, source)
    check(torch.equal(torch.minimum(torch.clamp_min(u, 0.0), cap), kept["usage_new"]),
          "the rebuilt usage call does not give the epoch's usage")
    return usage, index, source


def scatter_edges(torch, dev) -> list:
    """(label, out, index, source) streams at the edges of the kernel's
    plan, made from seed 18 on the card, every 97th value ±0.0 or
    subnormal."""
    g = torch.Generator(device=dev).manual_seed(18)

    def values(e, width, dtype):
        v = (torch.rand((e, width), generator=g, device=dev, dtype=torch.float64) * 8 - 3) \
            * 10.0 ** torch.randint(-4, 5, (e, 1), generator=g, device=dev)
        tiny = torch.tensor([0.0, -0.0, 5e-324, -4e-320] if dtype == torch.float64 else
                            [0.0, -0.0, 1e-45, -3e-41], dtype=torch.float64, device=dev)
        v[::97] = tiny[torch.arange(v[::97].shape[0], device=dev) % 4][:, None]
        return v.to(dtype).squeeze(1) if width == 1 else v.to(dtype)

    def targets(e, n, dtype, drop):
        t = torch.randint(0, n, (e,), generator=g, device=dev)
        gone = torch.rand(e, generator=g, device=dev) < drop
        t = torch.where(gone, torch.where(t % 2 == 0, -1, n + t), t)
        return t.to(dtype)

    mega = 1_000_000
    far = targets(mega, 255, torch.int64, 0.05)
    far = torch.where(torch.rand(mega, generator=g, device=dev) < 0.01, far + 2**33, far)
    return [
        ("1M rows into one target (the longest chain)",
         torch.zeros(1, device=dev), torch.zeros(mega, dtype=torch.int32, device=dev),
         values(mega, 1, torch.float32)),
        ("255 targets, 5% dropped, 1% past int32 (int64 index)",
         torch.zeros(255, device=dev), far, values(mega, 1, torch.float32)),
        ("W=8 float64, 300k rows into 8",
         torch.zeros((8, 8), dtype=torch.float64, device=dev),
         targets(300_000, 8, torch.int64, 0.05), values(300_000, 8, torch.float64)),
        ("every row dropped", torch.zeros(24, device=dev),
         targets(mega, 24, torch.int32, 1.0), values(mega, 1, torch.float32)),
    ]


def fused_paths(torch, np, dev, kernels: list) -> None:
    """Phase [6]: the fused epoch program → the partials entry gains the
    fused path's launches and its blocked book's time; the
    ``ordered_scatter_add`` entry is appended."""
    from repro_torch import core as pt
    from repro_torch.core.fused import build_fused_epoch
    from repro_torch.kernels import ops, ref

    log("[6] fused epochs: fleet_economy(100_000, 8, seed=0, fused=True), 3 binding epochs "
        "warm-started, 3 with cold restarts, on CUDA graphs")
    economies = {label: pt.fleet_economy(100_000, 8, seed=0, warm_start=warm, fused=True,
                                         device=dev)
                 for label, warm in (("warm-started", True), ("cold restarts", False))}
    by_part = epoch_breakdown(torch, economies["cold restarts"])
    settle_kept = {label: [] for label in economies}
    for label, eco in economies.items():
        keep_settle_inputs(torch, eco, settle_kept[label])
    warm_stats, walls = [], {}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for label, eco in economies.items():
        records, walls[label] = [], []
        for epoch in range(3):
            before = ops.launch_counts()["sparse_bid_eval_partials"]
            cap0 = ops.capture_stats()["seconds"]
            t0 = time.perf_counter()
            st = eco.run_epoch()
            wall = (time.perf_counter() - t0) * 1e3
            grew = ops.launch_counts()["sparse_bid_eval_partials"] - before
            cap = (ops.capture_stats()["seconds"] - cap0) * 1e3
            walls[label].append(wall)
            log(f"  fused {label} epoch {epoch}: {st.rounds} rounds, {wall:.1f} ms (capturing "
                f"{cap:.1f} ms), converged {st.converged}, system_ok {st.system_ok}, "
                f"migrations {st.migrations}, sparse_bid_eval_partials launches {grew}")
            check(st.converged and st.system_ok, f"fused {label} epoch {epoch}")
            check(grew >= st.rounds + 1,
                  f"fused epoch {epoch}: {grew} launches, {st.rounds} rounds")
            records.append(epoch_record(np, st, eco))
            if label == "warm-started":
                warm_stats.append(st)
        check_reference(f"fused {label}", records)
    torch.cuda.synchronize()
    fused_launches = ops.launch_counts()
    captured = ops.capture_stats()
    log(f"  launches {fused_launches}; CUDA graphs captured {captured['graphs']} in "
        f"{captured['seconds'] * 1e3:.1f} ms")
    check(fused_launches["ordered_scatter_add"] > 0, "the fused path never ran ordered_scatter_add")
    (clock_ms, clock_cap), rounds0 = by_part["_clock"][0], int(warm_stats[0].rounds)  # both cold
    for e in range(3):
        split = {k: v[e][0] for k, v in by_part.items() if k != "clock0" and len(v) > e}
        log(f"  fused cold restarts epoch {e} by part (ms, synchronised): "
            + ", ".join(f"{k.lstrip('_')} {v:.1f}" for k, v in split.items()))
    log(f"  fused epoch 0 clock alone: {rounds0} rounds in {clock_ms:.1f} ms, of which capturing "
        f"its chunk graph {clock_cap:.1f} ms; {(clock_ms - clock_cap) / rounds0 * 1e3:.1f} us a "
        f"replayed round (the staged clock before the graphs: 201.6 / 219.1 ms)")

    # -- pipeline=True against sequential epochs: two new economies, past
    #    their first epoch (and its captures), timed alike -----------------------
    seq = pt.fleet_economy(100_000, 8, seed=0, warm_start=True, fused=True, device=dev)
    pipe = pt.fleet_economy(100_000, 8, seed=0, warm_start=True, fused=True, pipeline=True,
                            device=dev)
    check(stats_bit_identical(np, seq.run_epoch(), pipe.run_horizon(1)[0]), "pipelined epoch 0")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    seq_stats = [seq.run_epoch() for _ in range(3)]
    seq_ms = (time.perf_counter() - t0) * 1e3
    finalize_ms = []
    inner_finalize = pipe._fused_finalize

    def finalize(*args, **kw):
        t0 = time.perf_counter()
        out = inner_finalize(*args, **kw)
        finalize_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    pipe._fused_finalize = finalize
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    piped = pipe.run_horizon(3)
    pipe_ms = (time.perf_counter() - t0) * 1e3
    check(all(stats_bit_identical(np, a, b) for a, b in zip(seq_stats, piped))
          and all(stats_bit_identical(np, a, b) for a, b in zip(warm_stats[1:], piped))
          and same_state(np, seq, pipe), "pipelined horizon differs")
    log(f"  pipeline=True run_horizon(3), epochs 1-3: every EpochStats field and the end state "
        f"bit for bit as 3 sequential run_epoch calls; {pipe_ms:.1f} ms against {seq_ms:.1f} "
        f"ms sequential; the stats assembly of the first two "
        f"({', '.join(f'{t:.1f}' for t in finalize_ms[:-1])} ms) runs while the next epoch's "
        f"settle stage is on the card, the last ({finalize_ms[-1]:.1f} ms) after it")
    pipeline = {"sequential_ms": seq_ms, "pipelined_ms": pipe_ms, "finalize_ms": finalize_ms}
    del pipe, seq

    # -- the protocol economies: the card against the CPU, and staged -----------
    for seed in (0, 3, 7):
        card = pt.make_fleet_economy(seed=seed, fused=True, device=dev)
        cpu = pt.make_fleet_economy(seed=seed, fused=True, device="cpu")
        staged = pt.make_fleet_economy(seed=seed, device=dev)
        rounds = []
        for epoch in range(4):
            sc, sh, ss = card.run_epoch(), cpu.run_epoch(), staged.run_epoch()
            check(stats_bit_identical(np, sc, sh), f"protocol seed {seed} epoch {epoch}: card "
                  "and CPU fused epochs differ")
            if epoch == 0:
                check(all(np.array_equal(getattr(sc, f), getattr(ss, f)) for f in EXACT_FIELDS),
                      f"protocol seed {seed}: fused and staged epoch 0 differ")
            rounds.append(sc.rounds)
        check(same_state(np, card, cpu), f"protocol seed {seed}: end state")
        log(f"  protocol economy seed {seed} (U_cap {card.R + 2 * len(card.pop)}): 4 fused epochs "
            f"on the card bit for bit as on the CPU (every field, end state), rounds {rounds}; "
            f"epoch 0 as the staged path's")

    # -- 10k: the kernels against their plain versions, eagerly -------------------
    eco_k = pt.fleet_economy(10_000, 8, seed=0, warm_start=True, fused=True, device=dev)
    eco_p = pt.fleet_economy(10_000, 8, seed=0, warm_start=True, fused=True, device=dev)
    eco_p._fused_fn = build_fused_epoch(
        num_agents=10_000, num_clusters=eco_p.C, num_rtypes=eco_p.T, clock=eco_p.clock,
        settle_blocks=eco_p.settle_blocks, plain=True)
    eco_p._fused_n = 10_000
    for epoch in range(2):
        sk, sp_ = eco_k.run_epoch(), eco_p.run_epoch()
        check(stats_bit_identical(np, sk, sp_), f"10k fused epoch {epoch}: kernels vs plain")
        log(f"  fused 10k epoch {epoch}: {sk.rounds} rounds; kernels (graphs) and plain versions "
            "(eager) bit for bit, every field")
    check(same_state(np, eco_k, eco_p), "10k fused end state")
    del eco_k, eco_p

    # -- fused_backend="z": the z-mode kernel's in-loop z -------------------------
    eco_z = pt.fleet_economy(100_000, 8, seed=0, warm_start=True, fused=True,
                             fused_backend="z", device=dev)
    z_parts: dict = {}
    timed(torch, eco_z._fused_program(), "_clock", z_parts)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    z_rounds = []
    for epoch in range(3):
        t0 = time.perf_counter()
        st = eco_z.run_epoch()
        wall = (time.perf_counter() - t0) * 1e3
        check(st.converged and st.system_ok and np.isfinite(st.prices).all(),
              f"fused z epoch {epoch}")
        z_rounds.append(st.rounds)
        exact = warm_stats[epoch].prices
        rel = float(np.max(np.abs(st.prices - exact) / exact))
        log(f"  fused_backend='z' epoch {epoch}: {st.rounds} rounds, {wall:.1f} ms (its clock "
            f"{z_parts['_clock'][-1][0]:.1f} ms, capturing {z_parts['_clock'][-1][1]:.1f}), "
            f"converged, SYSTEM-feasible; max |p - p_exact| / p_exact {rel:.3g}")
    z_launches = ops.launch_counts()
    check(z_launches["sparse_bid_eval_z"] >= sum(z_rounds), "z backend: sparse_bid_eval_z")
    del eco_z

    # -- the kernels at the fused path's shapes ----------------------------------
    log("[timing] fused path kernels (CUDA graphs)")
    prog = economies["cold restarts"]._fused_fn
    b = prog._book
    blocked = (b["b_idx"], b["b_val"], b["b_mask"], b["b_pi"], prog._prices)
    r = prog.R
    parts, chosen = ops.sparse_bid_eval(*blocked, r, prog.nb, standalone_fold=True)
    parts_ref, chosen_ref = ops.sparse_bid_eval(*blocked, r, prog.nb, standalone_fold=True,
                                                plain=True)
    check(same_bits(torch, parts, parts_ref) and torch.equal(chosen, chosen_ref),
          "fused blocked book: partials differ from the plain version")
    fb_ms = graph_ms(torch, lambda: ops.sparse_bid_eval(*blocked, r, prog.nb,
                                                        standalone_fold=True))
    fb_plain = graph_ms(torch, lambda: ops.sparse_bid_eval(*blocked, r, prog.nb,
                                                           standalone_fold=True, plain=True))
    fb_bound = padded_bound(*blocked, out_bytes=4 * prog.nb * r)
    shape = (f"U={b['b_idx'].shape[0]} B={prog.C} K={prog.K} R={r} vector pi, "
             f"8 blocks of {prog.m_cap}")
    log(f"  sparse_bid_eval_partials, the fused blocked book {shape}: {fb_ms:.4f} ms, plain "
        f"{fb_plain:.4f} ms, bound {fb_bound[0]:.4f} ms ({fb_bound[1]}); partials bit-identical")
    partials_entry = next(k for k in kernels if k["name"] == "sparse_bid_eval_partials")
    partials_entry["launches_staged_economy"] = partials_entry["launches"]
    partials_entry["launches_fused_economy"] = fused_launches["sparse_bid_eval_partials"]
    partials_entry["launches"] += fused_launches["sparse_bid_eval_partials"]
    partials_entry["path"] = "fleet economy, 6 epochs staged and 6 fused"
    partials_entry["fused_book"] = {"shape": shape, "ms": fb_ms, "plain_ms": fb_plain,
                                    "bound_ms": fb_bound[0]}
    partials_entry["fused_epochs"] = {
        "walls_ms": walls, "epoch0_clock_ms": clock_ms, "epoch0_clock_capture_ms": clock_cap,
        "cold_epoch_parts_ms": {k: [t for t, _ in v] for k, v in by_part.items()},
        "us_per_replayed_round": (clock_ms - clock_cap) / rounds0 * 1e3, "pipeline": pipeline,
        "z_backend_rounds": z_rounds}

    # ordered_scatter_add at the fused path's calls: the pack's supply
    # normaliser (every (row, bundle, term) of the slot book, dead terms
    # dropped, the int32 index as core/fused.py passes it); the settle's
    # usage commit rebuilt from a warm epoch and from cold epoch 0; the
    # 100,000 placed rows into 8 (the densest chain); the edge streams
    latency = add_latency_ns(torch)
    log(f"  dependent add latency (add_chain_probe, {PROBE_ADDS} adds): float32 "
        f"{latency['f32']:.4f} ns, float64 {latency['f64']:.4f} ns")
    halves = scatter_halves(ops)
    flat_val = b["val"].reshape(-1)
    index = torch.where(flat_val != 0, b["idx"].reshape(-1), -1)
    supply = scatter_call(torch, ops, "supply (the fused pack)",
                          torch.zeros(r, dtype=torch.float32, device=dev), index, flat_val.abs(),
                          latency, halves)
    eco_w, eco_c = economies["warm-started"], economies["cold restarts"]
    usage_calls = [("usage (the settle, warm epoch 1)", eco_w, settle_kept["warm-started"][1]),
                   ("usage (the settle, cold epoch 0)", eco_c, settle_kept["cold restarts"][0])]
    calls = [scatter_call(torch, ops, label, *settle_usage_call(torch, ops, eco, kept), latency,
                          halves) for label, eco, kept in usage_calls]
    req = torch.from_numpy(eco_c.pop.req).to(dev)
    rows_at = torch.from_numpy(np.where(eco_c.pop.placed >= 0, eco_c.pop.placed, eco_c.C)).to(dev)
    calls.append(scatter_call(torch, ops, "usage, 100,000 placed rows (the densest chain)",
                              torch.from_numpy(eco_c.usage).to(dev), rows_at, -req, latency,
                              halves))
    calls += [scatter_call(torch, ops, f"edge: {label}", *stream, latency, halves)
              for label, *stream in scatter_edges(torch, dev)]
    kernels.append({
        "name": "ordered_scatter_add", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ordered_scatter.cu",
        "replaces": "src/repro/core/fused.py:361 (XLA scatter-add on the CPU, no pallas_call)",
        "launches": fused_launches["ordered_scatter_add"], "max_abs_err": 0.0,
        "ms": supply["ms"], "plain_ms": supply["plain_ms"], "bound_ms": supply["bound_ms"],
        "bound_by": supply["bound_by"], "library_ms": supply["library_ms"],
        "chain_bound_ms": supply["chain_bound_ms"], "byte_bound_ms": supply["byte_bound_ms"],
        "add_latency_ns": latency, "longest_chain": supply["longest_chain"],
        "kept": supply["kept"], "partition_ms": supply["partition_ms"],
        "fold_ms": supply["fold_ms"], "path": "fused fleet economy, 6 epochs",
        "shape": f"E={supply['rows']} ({supply['kept']} kept) into R={r}, float32, int32 index",
        "calls": calls})
    del economies, prog, b, blocked


# ---------------------------------------------------------------------------
# [7] the always-on market service
# ---------------------------------------------------------------------------


def event_ms(torch, fn, calls: int = REPLAYS) -> float:
    """Median device ms of one eager ``fn()`` call between CUDA events."""
    for _ in range(WARMUPS):
        fn()
    times = []
    for _ in range(calls):
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def service_path(torch, np, dev, kernels: list) -> None:
    """Phase [7]: the reference's service stream (tools/service_100k_reference.json)
    through the port's ``MarketService`` CLI on the card, bridged from the
    100k economy, with a WAL and checkpoints under a temporary directory and
    the CLI's in-process kill and resume; every tick held against the
    recording → the partials entry gains the service book's shape, time,
    bound and launches."""
    import tempfile

    sys.path.insert(0, str(ROOT / "tools"))
    import record_service_reference as rsr

    from repro_torch import core as pt
    from repro_torch.kernels import ops, ref
    from repro_torch.serve import market

    want = json.loads(SERVICE_REFERENCE.read_text())
    c = want["config"]
    log(f"[7] service: fleet_economy({c['agents']:_}, {c['clusters']}, seed={c['seed']}) bridged "
        f"into MarketService on the card, {c['ticks']} ticks at churn {c['churn']} and withdraw "
        f"{c['withdraw_frac']}, WAL + checkpoints, killed and resumed after tick "
        f"{c['ticks'] // 2}")
    # each service's own stage timings (MarketService.last_tick_timings and
    # .build_timings), read after each tick and each build; a strong
    # reference only to the resumed service: the killed one must go
    stages, built, resumed = [], [], []

    def on_build(svc):
        built.append(dict(svc.build_timings))
        if svc.restored_step is not None:
            resumed.append(svc)

    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        builds, ticks = rsr.run_cli(market, rsr.cli_argv(
            c["agents"], c["clusters"], c["ticks"], c["churn"], c["withdraw_frac"], c["seed"], d)
            + ["--device", "cuda"], on_build=on_build,
            on_tick=lambda svc: stages.append(dict(svc.last_tick_timings)))
        torch.cuda.synchronize()
        stream_s = time.perf_counter() - t0
        launches = ops.launch_counts()
        captured = ops.capture_stats()
    bad = rsr.mismatches(want, {"builds": builds, "ticks": ticks})
    check(not bad, f"service: differs from the recorded reference: {bad}")
    rounds = [t["rounds"] for t in ticks]
    log(f"  {len(ticks)} ticks bit for bit as the recorded JAX reference across the kill and "
        f"resume (rounds {rounds}, prices, psi, pct_settled, flags, counters, health, the "
        f"sha256 of every book array; gamma, surplus, value of trade within rtol 1e-5); "
        f"builds {builds}; the CLI's parity_check passed; {stream_s:.1f} s in all")
    check(launches["sparse_bid_eval_partials"] >= sum(rounds) + len(rounds),
          f"service: {launches['sparse_bid_eval_partials']} partials launches for rounds {rounds}")
    check(sum(launches.values()) == launches["sparse_bid_eval_partials"],
          f"another kernel ran on the service path: {launches}")
    log(f"  launches {launches}; CUDA graphs captured {captured['graphs']} in "
        f"{captured['seconds'] * 1e3:.1f} ms")
    check(len(stages) == len(ticks) and len(built) == len(resumed) + 1 == 2,
          "service: a tick or a build without its timings")
    for t, st in enumerate(stages):
        log(f"  tick {t}: drain {st['drain_ms']:.2f} ms, device sync {st['sync_ms']:.2f} ms "
            f"({st['sync_rows']} rows written), clock {st['settle_ms']:.1f} ms for "
            f"{rounds[t]} rounds (capturing {st['capture_ms']:.1f} ms), commit "
            f"{st['commit_ms']:.1f} ms (a {st['record']} record), tick {st['tick_ms']:.1f} ms")
    bridge, recovery = built
    log(f"  bridge: bulk load of {builds[0]['rows']} rows {bridge['load_ms']:.1f} ms, bootstrap "
        f"full record {bridge['bootstrap_ms']:.1f} ms; resume: restore (full + deltas, "
        f"parity_check) {recovery['restore_ms']:.1f} ms, WAL replay of "
        f"{builds[1]['replayed_records']} records {recovery['wal_replay_ms']:.1f} ms")

    # -- the partials kernel at the service book, on the last tick's prices --
    svc = resumed[0]
    book = svc.book.device_padded_problem()
    prices = torch.from_numpy(svc.price_history[-1]).to(dev)
    r = book.num_resources
    args = (book.idx, book.val, book.bundle_mask, book.pi, prices)
    nb = svc.settle_blocks
    parts_k, chosen = ops.sparse_bid_eval(*args, r, nb)
    torch.cuda.synchronize()
    parts_p, chosen_p = ref.sparse_bid_eval(*args, r, nb)
    err = float((parts_k - parts_p).abs().max())
    check(torch.equal(chosen, chosen_p) and same_bits(torch, parts_k, parts_p),
          f"service book: partials off their plain version by {err}")
    u, b, k = book.idx.shape
    k_ms = graph_ms(torch, lambda: ops.sparse_bid_eval(*args, r, nb))
    p_ms = graph_ms(torch, lambda: ops.sparse_bid_eval(*args, r, nb, plain=True))
    b_ms, b_by = live_bound(*args, out_bytes=4 * nb * r)
    # the reference's view of the same mirror: CSR, offsets the fixed-K ladder
    csr = pt.CSRAuctionProblem(
        idx=book.idx.reshape(-1), val=book.val.reshape(-1),
        rows=torch.arange(u * b, dtype=torch.int32, device=dev).repeat_interleave(k),
        offsets=torch.arange(u * b + 1, dtype=torch.int32, device=dev) * k,
        bundle_mask=book.bundle_mask, pi=book.pi, base_cost=book.base_cost,
        supply_scale=book.supply_scale, num_resources=r, k_bound=k)
    gathered = pt.csr_padded_views(csr)
    check(torch.equal(gathered[0], book.idx) and torch.equal(gathered[1], book.val),
          "service book: the padded view is not the CSR gather")
    gather_ms = event_ms(torch, lambda: pt.csr_padded_views(csr))
    shape = f"U={u} B={b} K={k} R={r} vector pi, {nb} blocks of {u // nb} (vectorized fold)"
    log(f"  sparse_bid_eval_partials, the service book {shape}: {k_ms:.4f} ms, plain "
        f"{p_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}); partials bit-identical, chosen exact; "
        f"the CSR gather the in-place padded view avoids: {gather_ms:.4f} ms a call")
    entry = next(e for e in kernels if e["name"] == "sparse_bid_eval_partials")
    entry["launches_service"] = launches["sparse_bid_eval_partials"]
    entry["launches"] += launches["sparse_bid_eval_partials"]
    entry["max_abs_err"] = max(entry["max_abs_err"], err)
    entry["path"] += f", and {len(ticks)} service ticks"
    entry["service_book"] = {
        "shape": shape, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "launches": launches["sparse_bid_eval_partials"], "rounds": rounds,
        "csr_gather_ms": gather_ms, "stream_s": stream_s,
        "ticks": stages, "bridge": bridge, "resume": recovery}
    del svc, resumed, book, args, csr, gathered


# ---------------------------------------------------------------------------
# [8] the scenario engine and sharded settlement
# ---------------------------------------------------------------------------

SCENARIO_REFERENCE = ROOT / "tools" / "scenario_reference.json"  # record_scenario_reference.py


def scenario_paths(torch, np, dev, kernels: list, backend: str = "nccl") -> None:
    """Phase [8]: (a) the nine library scenarios and (b) the two 100k
    scenarios through the port's ``run_scenario`` on the card, each held
    against ``tools/scenario_reference.json``; (c) the clock sharded over a
    one-rank ``backend`` process group (a FileStore in a temporary
    directory), held bit for bit against the unsharded clock and the 100k
    recording → the partials entry gains both paths' launches."""
    import os
    import tempfile

    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "tools"))
    import record_scenario_reference as rsr

    from repro_torch import core as pt
    from repro_torch.kernels import ops

    want = json.loads(SCENARIO_REFERENCE.read_text())["runs"]
    log(f"[8] scenarios: {', '.join(rsr.LIBRARY)} (seed 3, their own epochs) and "
        f"{', '.join(rsr.AT_SCALE)} (fleet_economy(100_000, 8, seed=0), 6 epochs), staged, "
        f"each held against the recorded JAX run")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    summary = {}
    for name in rsr.CASES:
        epochs = []
        base = ops.launch_counts()["sparse_bid_eval_partials"]
        captured = [ops.capture_stats()["seconds"]]

        def on_epoch(eco, st, timing):
            grew = (ops.launch_counts()["sparse_bid_eval_partials"] - base
                    - sum(e[3] for e in epochs))
            check(grew >= st.rounds + 1, f"{name}: {grew} launches for {st.rounds} rounds")
            captured.append(ops.capture_stats()["seconds"])
            epochs.append((timing["wall_ms"], timing["clock_ms"], st.rounds, grew,
                           (captured[-1] - captured[-2]) * 1e3))

        got = rsr.run_case(pt, name, sync=torch.cuda.synchronize, on_epoch=on_epoch, device=dev)
        bad = rsr.mismatches(want[name], got)
        check(not bad, f"scenario {name}: differs from the recorded reference: {bad}")
        check(all(e["system_ok"] for e in got["epochs"]), f"scenario {name}: SYSTEM")
        log(f"  {name}: {len(epochs)} epochs as recorded (prices, reserves, psi, chosen, "
            f"placed, rounds, migrations, flags, util_spread, events bit for bit; payments "
            f"within rtol 1e-5); epoch wall / clock ms (of which capturing), rounds, partials "
            f"launches: " + "; ".join(f"{w:.1f} / {c:.1f} ({cap:.1f}), {r}, {n}"
                                      for w, c, r, n, cap in epochs))
        summary[name] = epochs
        check(ops.launch_counts()["sparse_bid_eval_partials"] - base
              == sum(e[3] for e in epochs), f"{name}: launches outside the epochs")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check(sum(launches.values()) == launches["sparse_bid_eval_partials"] > 0,
          f"scenarios: the partials kernel did not carry every epoch: {launches}")
    log(f"  launches {launches}; CUDA graphs captured {ops.capture_stats()}")

    log(f"[8] sharded settlement: a one-rank {backend} process group, the clock sharded over "
        f"users (8 blocks), against the unsharded clock and the 100k recording")
    with tempfile.TemporaryDirectory() as d:
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")  # one rank: no network
        kw = ({"device_id": torch.device("cuda", torch.cuda.current_device())}
              if backend == "nccl" else {})
        dist.init_process_group(backend, store=dist.FileStore(os.path.join(d, "store"), 1),
                                world_size=1, rank=0, **kw)
        try:
            mesh = pt.users_mesh()
            check((mesh.size, mesh.rank) == (1, 0) and mesh.group is not None, f"mesh {mesh}")
            probe = pt.fleet_economy(100_000, 8, seed=0, device=dev)
            book = probe.pack_bid_book().problem
            start = torch.from_numpy(np.asarray(
                pt.reserve_prices(probe.pools(), probe.weighting), np.float32)).to(dev)

            def clock(sharded):
                torch.cuda.synchronize()
                cap0, t0 = ops.capture_stats()["seconds"], time.perf_counter()
                if sharded:
                    res = pt.sharded_clock_auction(book, start, probe.clock, mesh=mesh)
                else:
                    res = pt.clock_auction(book, start, probe.clock,
                                           demand_fn=ops.blocked_bid_demand_fn(8))
                torch.cuda.synchronize()
                return res, ((time.perf_counter() - t0) * 1e3,
                             (ops.capture_stats()["seconds"] - cap0) * 1e3)

            ops.reset_launch_counts()
            turns = (False, True, True, False) * 3
            runs = [clock(s) for s in turns]
            clock_launches = ops.launch_counts()
            (ru, _), (rs, _) = runs[0], runs[1]
            for f in ("prices", "alloc_idx", "alloc_val", "chosen_bundle", "won", "payments",
                      "excess_demand", "rounds", "converged"):
                a, b = getattr(ru, f), getattr(rs, f)
                same = same_bits(torch, a, b) if a.is_floating_point() else torch.equal(a, b)
                check(same and a.shape == b.shape, f"sharded clock: {f} differs from unsharded")
            rounds = int(rs.rounds)
            for res, _ in runs[2:]:
                check(torch.equal(res.prices, ru.prices), "a clock in turns moved its prices")
            check(clock_launches["sparse_bid_eval_partials"] >= len(turns) * (rounds + 1),
                  f"sharded clock: {clock_launches}")
            times = [{"sharded": s, "ms": ms, "capture_ms": cap}
                     for s, (_, (ms, cap)) in zip(turns, runs)]
            per_round = {s: statistics.median((t["ms"] - t["capture_ms"]) / rounds * 1e3
                                              for t in times if t["sharded"] == s)
                         for s in (False, True)}
            log(f"  epoch 0's book ({book.num_users} users): sharded clock bit-identical to the "
                f"unsharded one (prices, allocations, chosen, won, payments, z, {rounds} rounds); "
                f"in turns (U, S, S, U) x 3: "
                + ", ".join(f"{'S' if t['sharded'] else 'U'} {t['ms']:.1f} ms "
                            f"(capturing {t['capture_ms']:.1f})" for t in times)
                + f"; median us a replayed round: unsharded {per_round[False]:.1f}, "
                f"sharded {per_round[True]:.1f}")

            eco = pt.fleet_economy(100_000, 8, seed=0, warm_start=True, settle_mesh=mesh,
                                   device=dev)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            records, sharded_epochs = [], []
            for epoch in range(3):
                before = ops.launch_counts()["sparse_bid_eval_partials"]
                t0 = time.perf_counter()
                st = eco.run_epoch()
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
                grew = ops.launch_counts()["sparse_bid_eval_partials"] - before
                check(grew >= st.rounds + 1, f"sharded epoch {epoch}: {grew} launches")
                records.append(epoch_record(np, st, eco))
                sharded_epochs.append((wall, st.rounds, grew))
            check_reference("staged warm-started", records)
            economy_launches = ops.launch_counts()
            log(f"  fleet_economy(100_000, 8, seed=0, warm_start=True, settle_mesh=users_mesh()): "
                f"epoch wall ms, rounds, partials launches: "
                + "; ".join(f"{w:.1f}, {r}, {n}" for w, r, n in sharded_epochs)
                + f"; launches {economy_launches}")
        finally:
            dist.destroy_process_group()
    log("  NCCL is proven at one rank only: a world size above 1 needs a machine with "
        "several GPUs")

    entry = next(e for e in kernels if e["name"] == "sparse_bid_eval_partials")
    sharded_launches = economy_launches["sparse_bid_eval_partials"]
    entry["launches_scenarios"] = launches["sparse_bid_eval_partials"]
    entry["launches_sharded_economy"] = sharded_launches
    entry["launches"] += launches["sparse_bid_eval_partials"] + sharded_launches
    entry["path"] += f", {len(rsr.CASES)} scenarios and the sharded economy (3 epochs)"
    entry["scenarios"] = summary
    entry["sharded"] = {"backend": backend, "world_size": 1, "clock_rounds": rounds,
                        "clock_in_turns": times, "us_a_round": per_round,
                        "economy_epochs": sharded_epochs}


# ---------------------------------------------------------------------------
# [9] the dense family and training
# ---------------------------------------------------------------------------

DENSE_ARCH = "qwen3-1.7b"
DENSE_BATCH, DENSE_PROMPT, DENSE_NEW = 4, 128, 32
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_EVERY, TRAIN_FAULT = 4, 512, 6, 3, 4
START_RTOL = 1e-5  # the CLI's first loss against the model's loss of the same weights and batch
CARD_CPU_BATCH, CARD_CPU_SEQ, CARD_CPU_LR = 2, 64, 3e-4
CARD_CPU_LOSS_RTOL = 1e-3  # bf16 activations: a product rounds the other way now and then
CARD_CPU_NORM_RTOL = 1e-2
CARD_CPU_FLIP_SHARE = 1e-2  # parameters whose first Adam step took the other sign


def captured(fn, *args):
    """``fn(*args)``'s return value and its standard output, each line
    echoed to ours."""
    import io

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = fn(*args)
    lines = out.getvalue().splitlines()
    for line in lines:
        log(f"  | {line}")
    return rc, lines


def dense_serving(torch, dev) -> dict:
    """(a) qwen3-1.7b at full width and depth serves DENSE_BATCH requests of
    DENSE_PROMPT tokens and DENSE_NEW greedy new ones."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import get_api
    from repro_torch.models.params import count_params, init_params, tree_bytes
    from repro_torch.serve.decode import generate

    cfg = get_config(DENSE_ARCH)
    api = get_api(cfg)
    n_params = count_params(api.decls(cfg))
    log(f"[9a] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, {cfg.num_heads} "
        f"query / {cfg.num_kv_heads} KV heads of {cfg.hd()}, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, tied {cfg.tie_embeddings}, activations {cfg.act_dtype}, "
        f"{n_params:,} float32 parameters from seed 0")
    torch.cuda.reset_peak_memory_stats()
    params = init_params(torch.Generator(device=dev).manual_seed(0), api.decls(cfg),
                         torch.float32, dev)
    weight_bytes = tree_bytes(params)
    prompt = torch.randint(0, cfg.vocab_size, (DENSE_BATCH, DENSE_PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = generate(params, cfg, prompt, DENSE_NEW)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    launches = ops.launch_counts()
    check(tuple(out.shape) == (DENSE_BATCH, DENSE_PROMPT + DENSE_NEW)
          and torch.equal(out[:, :DENSE_PROMPT], prompt.to(torch.int32))
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()), "generated tokens")
    check(sum(launches.values()) == 0, f"a market kernel ran on the serving path: {launches}")
    log(f"  generate {DENSE_BATCH} x ({DENSE_PROMPT} prompt + {DENSE_NEW} new) greedy: "
        f"{serve_s * 1e3:.1f} ms ({DENSE_BATCH * DENSE_NEW / serve_s:.1f} new tok/s, the first "
        f"call's warm-up included); request 0 continues with {out[0, DENSE_PROMPT:].tolist()}")

    # prefill and decode timed apart: the same tokens come out
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = api.init_cache(cfg, DENSE_BATCH, DENSE_PROMPT + DENSE_NEW, device=dev)
        logits, cache = api.decode_step(params, cache, prompt, 0, cfg)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        check(bool(torch.isfinite(logits.float()).all())
              and tuple(logits.shape) == (DENSE_BATCH, DENSE_PROMPT, cfg.vocab_size),
              "prefill logits")
        cur = logits[:, -1].float().argmax(-1, keepdim=True).to(torch.int32)
        toks = [cur]
        t0 = time.perf_counter()
        for i in range(DENSE_PROMPT, DENSE_PROMPT + DENSE_NEW - 1):
            logits, cache = api.decode_step(params, cache, cur, i, cfg)
            cur = logits[:, -1].float().argmax(-1, keepdim=True).to(torch.int32)
            toks.append(cur)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3 / (DENSE_NEW - 1)
        check(torch.equal(torch.cat(toks, 1), out[:, DENSE_PROMPT:]),
              "a second run gives other tokens")
        step_ms = graph_ms(torch, lambda: api.decode_step(params, cache, cur, DENSE_PROMPT, cfg),
                           DECODE_GRAPH_CALLS)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    prefill_bound_ms = 2 * n_params * DENSE_BATCH * DENSE_PROMPT / FP32_OPS_PER_S * 1e3
    log(f"  prefill {DENSE_BATCH} x {DENSE_PROMPT}: {prefill_ms:.1f} ms "
        f"({DENSE_BATCH * DENSE_PROMPT / prefill_ms * 1e3:.0f} prompt tok/s; float32 product "
        f"bound {prefill_bound_ms:.1f} ms); decode {decode_ms:.2f} ms a step of {DENSE_BATCH} "
        f"tokens ({DENSE_BATCH / decode_ms * 1e3:.1f} tok/s), of which {step_ms:.2f} ms on the "
        f"card (a CUDA graph of the step; idle {1 - step_ms / decode_ms:.1%}); weight-read bound "
        f"{decode_bound_ms:.2f} ms ({weight_bytes / 1e9:.2f} GB); peak {peak_gb:.2f} GB")

    # chunked prefill against a token-by-token warm-up, float32 activations,
    # request 0: every position's logits
    cfg32 = cfg.replace(act_dtype="float32")
    with torch.inference_mode():
        one = prompt[:1]
        chunked, _ = api.decode_step(params, api.init_cache(cfg32, 1, DENSE_PROMPT, device=dev),
                                     one, 0, cfg32)
        cache = api.init_cache(cfg32, 1, DENSE_PROMPT, device=dev)
        steps = []
        for i in range(DENSE_PROMPT):
            step_logits, cache = api.decode_step(params, cache, one[:, i:i + 1], i, cfg32)
            steps.append(step_logits[:, 0])
        stepped = torch.stack(steps, dim=1)
        per_pos = (chunked - stepped).abs().amax(dim=(0, 2))
        scale = float(stepped.abs().max())
        last = float(per_pos[-1])
    check(float(per_pos.max()) <= LOGITS_TOL * scale,
          f"chunked prefill vs token-by-token: max|d| {float(per_pos.max())} (max {scale})")
    log(f"  chunked prefill vs token-by-token warm-up, float32 activations, {DENSE_PROMPT} "
        f"positions: last position's max|d logits| {last:.3g}, worst {float(per_pos.max()):.3g} "
        f"(position {int(per_pos.argmax())}) of max|logits| {scale:.4g} (limit {LOGITS_TOL} x)")
    del params, cache, chunked, stepped, logits
    return {"params": n_params, "weight_gb": weight_bytes / 1e9, "serve_ms": serve_s * 1e3,
            "prefill_ms": prefill_ms, "prefill_bound_ms": prefill_bound_ms,
            "decode_ms_per_step": decode_ms, "decode_device_ms_per_step": step_ms,
            "decode_bound_ms": decode_bound_ms, "decode_tok_s": DENSE_BATCH / decode_ms * 1e3,
            "peak_gb": peak_gb, "chunked_vs_stepped_last": last, "logits_scale": scale,
            "launches": launches, "ids": out[:, DENSE_PROMPT:].tolist()}


def dense_training(torch, dev) -> dict:
    """(b) qwen3-1.7b at full width and depth trained through
    ``launch/train``: TRAIN_STEPS steps uninterrupted, then the same run with
    checkpoints every TRAIN_EVERY steps killed at TRAIN_FAULT by
    ``--fault-step`` and resumed from its latest checkpoint."""
    import math
    import os
    import shutil
    import tempfile
    import threading

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import get_api
    from repro_torch.models.params import init_params

    log(f"[9b] {DENSE_ARCH} trained through launch/train: batch {TRAIN_BATCH} x seq "
        f"{TRAIN_SEQ}, {TRAIN_STEPS} steps, AdamW, float32 weights and moments")
    base = ["--arch", DENSE_ARCH, "--steps", str(TRAIN_STEPS), "--batch", str(TRAIN_BATCH),
            "--seq", str(TRAIN_SEQ), "--seed", "0", "--device", str(dev)]

    def metrics(path):
        with open(path) as f:
            return [json.loads(line) for line in f]

    with tempfile.TemporaryDirectory() as d:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        rc, _ = captured(train.main, base + ["--metrics", f"{d}/plain.jsonl"])
        launches = ops.launch_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(rc == 0, f"launch/train returned {rc}")
        plain = metrics(f"{d}/plain.jsonl")
        losses = [m["loss"] for m in plain]
        check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses),
              f"losses {losses}")
        # the CLI's first loss is the model's loss of seed 0's weights on
        # step 0's batch, computed here apart from the CLI
        cfg = get_config(DENSE_ARCH)
        api = get_api(cfg)
        with torch.no_grad():
            params = init_params(torch.Generator(device=dev).manual_seed(0), api.decls(cfg),
                                 torch.float32, dev)
            batch = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)(0)
            start = float(api.loss(params, {k: torch.from_numpy(v).to(dev)
                                            for k, v in batch.items()}, cfg)[0])
        del params
        check(abs(losses[0] - start) <= START_RTOL * start,
              f"first loss {losses[0]}, the model's own {start}")
        step_ms = statistics.median(m["step_ms"] for m in plain[2:])

        # the same run with checkpoints, killed at TRAIN_FAULT, then resumed
        ck = ["--ckpt-dir", f"{d}/ckpt", "--ckpt-every", str(TRAIN_EVERY)]
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        try:
            captured(train.main, base + ck + ["--fault-step", str(TRAIN_FAULT),
                                             "--metrics", f"{d}/killed.jsonl"])
        except RuntimeError as e:  # the injected fault, and nothing else
            if f"injected fault at step {TRAIN_FAULT}" not in str(e):
                raise
        else:
            check(False, "the injected fault did not fire")
        # a killed process would lose a checkpoint still being written; here
        # the killed run's writer finishes first, so the resume point is the
        # last checkpoint the run started
        for t in threading.enumerate():
            if t.name.startswith("ckpt-write-"):
                t.join()
        killed_s = time.perf_counter() - t0
        saved = sorted(os.listdir(f"{d}/ckpt"))
        shutil.rmtree(f"{d}/ckpt/{saved[0]}")  # the resume reads only the latest
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        rc, lines = captured(train.main, base + ck + ["--metrics", f"{d}/resumed.jsonl"])
        resumed_s = time.perf_counter() - t0
        check(rc == 0, f"the resumed launch/train returned {rc}")
        resumed_from = int(next(x for x in lines if "resumed from step" in x).split()[-1])
        resumed = metrics(f"{d}/resumed.jsonl")
        killed = metrics(f"{d}/killed.jsonl")
        check([m["step"] for m in killed] == list(range(TRAIN_FAULT)), f"killed run {killed}")
        check([m["step"] for m in resumed] == list(range(resumed_from + 1, TRAIN_STEPS)),
              f"resumed steps {resumed}")
        for m in killed + resumed:  # the embedding's backward adds in operand order
            check(m["loss"] == losses[m["step"]], f"step {m['step']}: loss {m['loss']} against "
                                                  f"{losses[m['step']]} uninterrupted")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    log(f"  losses {losses} (the first as the model computes it apart: {start:.6f}; ln V = "
        f"{math.log(cfg.vocab_size):.4f}); median step {step_ms:.1f} ms over steps 2-"
        f"{TRAIN_STEPS - 1} "
        f"({tokens / step_ms * 1e3:.0f} tok/s), peak {peak_gb:.2f} GB allocated")
    log(f"  checkpoints {saved} before the fault at step {TRAIN_FAULT} ({killed_s:.1f} s, the "
        f"writes included); resumed from step {resumed_from} in {resumed_s:.1f} s; steps "
        f"{[m['step'] for m in killed + resumed]} repeat the uninterrupted losses bit for bit; "
        f"the uninterrupted run's launches {launches}")
    return {"losses": losses, "first_loss_apart": start, "step_ms": step_ms, "tok_s": tokens / step_ms * 1e3,
            "peak_gb": peak_gb, "step_ms_all": [m["step_ms"] for m in plain],
            "checkpoints": saved, "resumed_from": resumed_from, "launches": launches,
            "killed_run_s": killed_s, "resumed_run_s": resumed_s}


def train_breakdown(torch, dev) -> dict:
    """Where a train step's time goes (batch TRAIN_BATCH x TRAIN_SEQ, full
    width and depth): the forward pass with the loss, the backward pass and
    the AdamW update, each timed alone on the host clock between device
    synchronisations, medians of 3 after a warm-up, beside its bound."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import get_api
    from repro_torch.models.params import count_params, init_params, tree_bytes, tree_leaves
    from repro_torch.models.params import tree_map
    from repro_torch.train.optimizer import AdamW

    cfg = get_config(DENSE_ARCH)
    api = get_api(cfg)
    n = count_params(api.decls(cfg))
    params = init_params(torch.Generator(device=dev).manual_seed(0), api.decls(cfg),
                         torch.float32, dev)
    adamw = AdamW()
    state = adamw.init(params)
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)(0).items()}
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    live = tree_map(lambda _: next(it), params)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    times = {"forward and loss": [], "backward": [], "AdamW": []}
    for rep in range(4):
        loss, f_ms = timed(lambda: api.loss(live, batch, cfg)[0])
        grads, b_ms = timed(lambda: torch.autograd.grad(loss, leaves))
        it = iter(grads)
        g_tree = tree_map(lambda _: next(it), params)
        _, o_ms = timed(lambda: adamw.update(g_tree, state, params))
        del loss, grads, g_tree
        if rep:
            for key, ms in zip(times, (f_ms, b_ms, o_ms)):
                times[key].append(ms)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # products: 2·N·tokens forward, 4·N·tokens backward; AdamW reads p, g,
    # m, v and writes p, m, v once
    bounds = {"forward and loss": 2 * n * tokens / FP32_OPS_PER_S * 1e3,
              "backward": 4 * n * tokens / FP32_OPS_PER_S * 1e3,
              "AdamW": 7 * tree_bytes(params) / HBM_BYTES_PER_S * 1e3}
    out = {key: {"ms": statistics.median(v), "bound_ms": bounds[key]} for key, v in times.items()}
    log("[9b] a train step by part: " + "; ".join(
        f"{key} {v['ms']:.1f} ms (bound {v['bound_ms']:.1f})" for key, v in out.items()))
    del params, state, live, leaves
    return out


def card_against_cpu(torch, np, dev) -> dict:
    """(c) one train step of qwen3-1.7b at full width and 2 layers, the same
    weights and SyntheticLM batch on the card and on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import get_api
    from repro_torch.models.params import init_params, tree_leaves, tree_map
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import init_train_state, make_train_step

    cfg = get_config(DENSE_ARCH).replace(num_layers=2)
    api = get_api(cfg)
    log(f"[9c] {cfg.name} at full width, {cfg.num_layers} layers: one AdamW step (lr "
        f"{CARD_CPU_LR}) on the card and on the CPU, batch {CARD_CPU_BATCH} x {CARD_CPU_SEQ}")
    cpu = torch.device("cpu")
    params = init_params(torch.Generator().manual_seed(0), api.decls(cfg), torch.float32, cpu)
    batch = SyntheticLM(cfg, CARD_CPU_BATCH, CARD_CPU_SEQ, seed=0)(0)
    opt = AdamW(lr=CARD_CPU_LR)
    step = make_train_step(cfg, opt)
    runs = []
    for where in (dev, cpu):
        p = tree_map(lambda a: a.to(where, copy=True), params)
        state = init_train_state(cfg, opt, p)
        t0 = time.perf_counter()
        p, state, m = step(p, state, {k: torch.from_numpy(v).to(where) for k, v in batch.items()})
        runs.append((tree_map(lambda a: a.cpu(), p), float(m["loss"]), float(m["grad_norm"]),
                     time.perf_counter() - t0))
    (pg, lg, ng, sg), (pc, lc, nc, sc) = runs
    moved = flips = total = 0
    worst = 0.0
    for a, b in zip(tree_leaves(pg), tree_leaves(pc)):
        diff = (a - b).abs()
        worst = max(worst, float(diff.max()))
        flips += int((diff > CARD_CPU_LR).sum())
        total += diff.numel()
    loss_rel, norm_rel = abs(lg - lc) / abs(lc), abs(ng - nc) / abs(nc)
    # an Adam step moves a parameter by lr·(±1 + wd·p) at step 1, so two runs
    # whose gradient signs agree land within float32 rounding of each other
    check(loss_rel <= CARD_CPU_LOSS_RTOL, f"loss card {lg} vs CPU {lc}")
    check(norm_rel <= CARD_CPU_NORM_RTOL, f"grad_norm card {ng} vs CPU {nc}")
    check(flips <= CARD_CPU_FLIP_SHARE * total and worst <= 2.2 * CARD_CPU_LR,
          f"updated parameters: {flips} of {total} moved apart, max |d| {worst}")
    log(f"  loss card {lg:.6f} / CPU {lc:.6f} (rel {loss_rel:.3g}, limit {CARD_CPU_LOSS_RTOL}); "
        f"grad_norm {ng:.6f} / {nc:.6f} (rel {norm_rel:.3g}, limit {CARD_CPU_NORM_RTOL}); "
        f"updated parameters: {flips} of {total:,} differ by more than lr (limit "
        f"{CARD_CPU_FLIP_SHARE:.0%}), max |d| {worst:.3g}; step {sg:.2f} s card (first call), "
        f"{sc:.2f} s CPU")
    return {"loss_card": lg, "loss_cpu": lc, "grad_norm_card": ng, "grad_norm_cpu": nc,
            "param_flips": flips, "params": total, "param_max_abs_diff": worst}


def example_twins(torch, dev, kernels: list) -> dict:
    """(d) the example twins on the card, each path's launches counted alone:
    elastic_train_torch.py --production (both auctions through bid_eval),
    quickstart_torch.py, market_sim_torch.py (6 epochs) and
    market_service_demo_torch.py --agents 400 --ticks 4, each ending with the
    reference's last line → the bid_eval and partials entries gain their
    launches."""
    import math
    import re

    from repro_torch.kernels import ops

    sys.path.insert(0, str(ROOT / "examples"))
    import elastic_train_torch
    import market_service_demo_torch
    import market_sim_torch
    import quickstart_torch

    runs = {
        "elastic_train_torch.py --production": (elastic_train_torch.main, ["--production"],
                                                "[done] final loss"),
        "quickstart_torch.py": (quickstart_torch.main, [], "realized surplus"),
        "market_sim_torch.py": (market_sim_torch.main, [], "all epochs SYSTEM-feasible: True"),
        "market_service_demo_torch.py --agents 400 --ticks 4": (
            market_service_demo_torch.main, ["--agents", "400", "--ticks", "4"],
            "incremental book bit-identical to full repack: True"),
    }
    out = {}
    for label, (fn, argv, last) in runs.items():
        log(f"[9d] examples/{label}")
        gc.collect()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        _, lines = captured(fn, argv + ["--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        check(lines and lines[-1].startswith(last), f"{label} ends with {lines[-1:]}")
        out[label] = {"s": wall, "launches": launches, "last": lines[-1]}
        log(f"  {wall:.1f} s; launches {launches}")
        if label.startswith("elastic"):
            grants = [x for x in lines if x.startswith("[market] grant")]
            losses = [float(m.group(1)) for x in lines
                      if (m := re.search(r"^\[train/.*\] step \d+ loss ([0-9.]+)", x))]
            resumed = int(next(x for x in lines if x.startswith("[elastic]")).split()[3])
            check(len(grants) == 2 and launches["bid_eval"] > 0,
                  f"elastic: grants {grants}, launches {launches}")
            check(len(losses) > 2 and all(math.isfinite(x) for x in losses),
                  f"elastic losses {losses}")
            out[label].update(grants=grants, losses=losses, resumed_step=resumed)
        if label.startswith("quickstart"):
            check(any("SYSTEM feasible: True" in x for x in lines) and launches["bid_eval"] > 0,
                  f"quickstart: {launches}")
        if label.startswith(("market_sim", "market_service")):
            check(launches["sparse_bid_eval_partials"] > 0, f"{label}: {launches}")
            if label.startswith("market_service"):
                check(all("SYSTEM ok=True" in x for x in lines if x.startswith("tick")
                          and "rounds" in x), f"{label}: a tick not SYSTEM-feasible")
    for name, paths in (("bid_eval", ("elastic", "quickstart")),
                        ("sparse_bid_eval_partials", ("market_sim", "market_service"))):
        entry = next(e for e in kernels if e["name"] == name)
        grew = {label: r["launches"][name] for label, r in out.items() if label.startswith(paths)}
        entry["launches"] += sum(grew.values())
        entry["path"] += ", " + ", ".join(f"examples/{label}" for label in grew)
        entry["launches_examples"] = grew
    return out


def dense_paths(torch, np, dev, kernels: list) -> dict:
    """Phase [9]: the dense family served and trained on the card, the card
    against the CPU, and the example twins."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    summary = {"serve": dense_serving(torch, dev)}
    gc.collect()
    torch.cuda.empty_cache()
    summary["train"] = dense_training(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    summary["train_by_part"] = train_breakdown(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    summary["card_vs_cpu"] = card_against_cpu(torch, np, dev)
    gc.collect()
    torch.cuda.empty_cache()
    summary["examples"] = example_twins(torch, dev, kernels)
    log("[9] " + json.dumps(summary, default=str))
    return summary


# ---------------------------------------------------------------------------
# [10] MoE with MLA, and deterministic training
# ---------------------------------------------------------------------------

MOE_ARCH = "deepseek-v3-671b"
MOE_LAYERS = 4  # 3 dense layers (MLA, d_ff 18,432) and 1 routed layer of 256 experts
MOE_BATCH, MOE_PROMPT, MOE_NEW = 4, 128, 16
# absorbed (latent cache) against expanded MLA, bf16 activations: the relative
# RMS of the logits' difference; a few tokens may take another expert where two
# router probabilities lie within bf16 rounding of each other
LATENT_VS_EXPANDED_RMS = 5e-2
ROWS_EDGE_WIDTHS = (7_168, 2_048, 1, 33)
ROWS_EDGE_E, ROWS_EDGE_N, ROWS_EDGE_CHAIN = 12_000, 64, 10_000
ROWS_EDGE_SCAN = 4_096  # rows of the scan route's one-target books
MOE_TRAIN = {"deepseek-v3-671b": 1, "kimi-k2-1t-a32b": 0}  # smoke configs, their mtp_depth
MOE_TRAIN_ARGS = ["--smoke", "--steps", "6", "--batch", "4", "--seq", "64", "--seed", "0"]
MOE_CARD_CPU_RTOL = 1e-4  # float32 smoke: products summed in another order on the card
SUPERVISED_FAULT = 4


@contextlib.contextmanager
def rows_calls(ops, wrap):
    """While active, ``ops.ordered_rows_add`` calls (the MoE combine, the
    backward of ``ordered_gather``) go through ``wrap(kernel_wrapper,
    *args)``: to record their inputs, or to force the plain version."""
    kernel_wrapper = ops.ordered_rows_add
    ops.ordered_rows_add = functools.partial(wrap, kernel_wrapper)
    try:
        yield
    finally:
        ops.ordered_rows_add = kernel_wrapper


def rows_bound(torch, out, index, source, latency) -> dict:
    """``ordered_rows_add``'s work on these inputs: the kept rows, the
    targets they touch, the longest chain; the byte bound (the index read
    once, the kept rows read once, each touched target row read and written
    once) and the chain bound (the longest chain × the float32 dependent
    add latency; a bfloat16 add is that add and two conversions)."""
    n = out.shape[0]
    width = out[0].numel()
    keep = (index >= 0) & (index < n)
    counts = torch.bincount(index[keep].long(), minlength=n)
    kept, touched, longest = int(keep.sum()), int((counts > 0).sum()), int(counts.max())
    size = out.element_size()
    byte_ms = (nbytes(index) + (kept + 2 * touched) * width * size) / HBM_BYTES_PER_S * 1e3
    chain_ms = longest * latency["f64" if out.dtype == torch.float64 else "f32"] * 1e-6
    return {"rows": index.numel(), "kept": kept, "targets": n, "touched": touched,
            "width": width, "longest_chain": longest, "byte_bound_ms": byte_ms,
            "chain_bound_ms": chain_ms, "bound_ms": max(byte_ms, chain_ms),
            "bound_by": "operations" if chain_ms > byte_ms else "bytes"}


def rows_halves(ops):
    """``ordered_rows_partition`` and ``ordered_rows_fold``, with
    ``ordered_rows_add``'s arguments."""
    from repro_torch.kernels import build

    lib = build.library("ordered_rows")
    halves = {}
    for half in ("partition", "fold"):
        f = getattr(lib, f"ordered_rows_{half}")
        f.restype = ctypes.c_int
        f.argtypes = ops._SIGNATURES[("ordered_rows", "ordered_rows_add")]
        halves[half] = f
    return halves


# the kernels a call launches on each route (the sort route's partition is
# torch's); PROFILE_CALLS calls are profiled in one window
ROWS_ROUTE_KERNELS = {"scan": {"scan_kernel"}, "smem": {"partition_kernel", "fold_kernel"},
                      "sort": {"fold_kernel"}}
PROFILE_CALLS, PROFILE_TRIES = 3, 3


def kernel_name(name: str) -> str:
    """A profiled kernel's name without its namespace and arguments."""
    m = re.search(r"(\w+<[^(]*)\(", name) or re.search(r"(\w+)\(", name)
    return m[1] if m else name


def rows_launched(torch, ops, out, index, source, want: set) -> list:
    """The kernels (and copies, memsets) that PROFILE_CALLS
    ``ordered_rows_add`` calls put on the card, by name, from
    ``torch.profiler``'s CUDA activity in one window.  The profiler drops a
    device event now and then (about one window in 30 on the card), so a
    window that misses one of the kernels in ``want`` is profiled again, at
    most PROFILE_TRIES times."""
    from torch.profiler import ProfilerActivity, profile

    buf = out.clone()
    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILE_CALLS):
                ops.ordered_rows_add(buf, index, source)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if want <= {kernel_name(k).split("<")[0] for k in names}:
            break
    return names


def rows_call(torch, ops, label, out, index, source, latency, timed=True, route=None) -> dict:
    """One ``ordered_rows_add`` call held bit for bit against its plain
    version, eager and replayed from a CUDA graph, on the route ``route``
    when given (``ops.rows_plan``'s); the kernels PROFILE_CALLS calls
    launch, listed by the profiler: the route's own (ROWS_ROUTE_KERNELS),
    each at most once a call, and nothing else unless the route is "sort".
    When ``timed``, timed whole, as its partition
    (none on the scan route; ``ops.rows_sort_partition`` on the sort route)
    and its fold alone, beside ``index_add_`` of the kept rows (atomics,
    unordered), the plain version and its bounds."""
    got = ops.ordered_rows_add(out.clone(), index, source)
    want = ops.ordered_rows_add(out.clone(), index, source, plain=True)
    torch.cuda.synchronize()
    check(same_bits(torch, got, want), f"ordered_rows_add {label}: differs from the plain "
          f"version by up to {float((got.double() - want.double()).abs().max())}")
    replayed = out.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()  # captured without the graph context's gc and cache flush
    with torch.cuda.stream(side):
        graph.capture_begin()
        try:
            ops.ordered_rows_add(replayed, index, source)
        finally:
            graph.capture_end()
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    del graph
    check(same_bits(torch, replayed, want), f"ordered_rows_add {label}: a CUDA graph's replay "
          "differs from the plain version")
    plan = ops.rows_args(out.clone(), index, source)[0]
    check(route is None or plan.route == route, f"ordered_rows_add {label}: route {plan.route}, "
          f"expected {route}")
    want = ROWS_ROUTE_KERNELS[plan.route]
    names = rows_launched(torch, ops, out, index, source, want)
    seen = [kernel_name(k).split("<")[0] for k in names]
    check(want <= set(seen), f"ordered_rows_add {label} ({plan.route}): the profiler saw "
          f"{names}")
    if plan.route != "sort":  # only its own kernels, each once a call
        check(set(seen) == want and len(names) <= PROFILE_CALLS * len(want),
              f"ordered_rows_add {label} ({plan.route}): launches other than its own "
              f"kernels: {names}")
    row = {"call": label, "dtype": str(out.dtype).removeprefix("torch."),
           "index_dtype": str(index.dtype).removeprefix("torch."),
           **rows_bound(torch, out, index, source, latency), "max_abs_err": 0.0,
           "rows_route": plan.route,
           **{k: v for k, v in plan._asdict().items() if k not in ("route", "smem_bytes")},
           "kernels_launched": list(dict.fromkeys(kernel_name(k) for k in names)),
           "profiled_calls": PROFILE_CALLS, "profiled_events": len(names)}
    if timed:
        buf = out.clone()
        row["ms"] = graph_ms(torch, lambda: ops.ordered_rows_add(buf, index, source))
        halves = rows_halves(ops)
        _, args, held = ops.rows_args(buf, index, source)

        def half(name):  # on the stream current at the call: graph_ms captures on its own
            err = halves[name](*args[:-1], torch.cuda.current_stream().cuda_stream)
            check(err == 0, f"ordered_rows_{name}: cudaError {err}")

        partition = (functools.partial(ops.rows_sort_partition, held[0], out.shape[0], held[2])
                     if plan.route == "sort" else functools.partial(half, "partition"))
        partition()  # the fold alone folds this partition
        row["partition_ms"] = 0.0 if plan.route == "scan" else graph_ms(torch, partition)
        row["fold_ms"] = graph_ms(torch, functools.partial(half, "fold"))
        keep = (index >= 0) & (index < out.shape[0])
        kept_i, kept_s = index[keep], source[keep]
        lib = out.clone()
        row["library_ms"] = graph_ms(torch, lambda: lib.index_add_(0, kept_i, kept_s))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(3):
            ops.ordered_rows_add(out.clone(), index, source, plain=True)
        torch.cuda.synchronize()
        row["plain_ms"] = (time.perf_counter() - t0) * 1e3 / 3
    log(f"  ordered_rows_add {label}: {row['rows']} rows ({row['kept']} kept, {row['touched']} "
        f"targets touched, longest chain {row['longest_chain']}) into {row['targets']} x "
        f"{row['width']} {row['dtype']}, {row['index_dtype']} index; route {plan.route} (vec "
        f"{plan.vec}, {plan.threads} threads x {plan.tiles} tiles, grid {plan.grid}"
        + (f", {plan.passes} pass(es) of {plan.bits} bits" if plan.route == "smem" else "")
        + f"); launches {row['kernels_launched']} ({len(names)} events in "
        f"{PROFILE_CALLS} calls)"
        + (f": {row['ms']:.4f} ms (partition {row['partition_ms']:.4f}, fold "
           f"{row['fold_ms']:.4f}); bounds: bytes {row['byte_bound_ms']:.4f}, chain "
           f"{row['chain_bound_ms']:.4f} ms; index_add_ (atomics, unordered) "
           f"{row['library_ms']:.4f} ms; plain {row['plain_ms']:.2f} ms" if timed else "")
        + "; bit-identical to the plain version, eager and replayed")
    return row


def rows_edge_book(torch, dev, g, e, n, width, dtype, index_dtype, chain=0, offset=0):
    """(out, index, source): ``e`` rows into ``n`` targets, the first
    ``chain`` of a random permutation of the rows on target 0, target 1
    none (when n > 2), 1% of the indices out of range (negative, past n,
    and for an int64 index past int32); ``source`` starts ``offset``
    elements into its storage."""
    index = torch.randint(min(2, n - 1), n, (e,), generator=g, device=dev)
    if chain:
        index[torch.randperm(e, generator=g, device=dev)[:chain]] = 0
    bad = torch.randperm(e, generator=g, device=dev)[:max(e // 100, 1)]
    index[bad[0::3]] = -1
    index[bad[1::3]] = n + 3
    index[bad[2::3]] = 2**33 + 1 if index_dtype == torch.int64 else -(2**31)
    storage = torch.randn((e * width + offset,), generator=g, device=dev).to(dtype)
    source = storage[offset:].view(e, width)
    out = torch.randn((n, width), generator=g, device=dev).to(dtype)
    return out, index.to(index_dtype), source


def rows_edges(torch, ops, dev, latency) -> list:
    """``ordered_rows_add`` at edge shapes, each bit for bit against its
    plain version on the route it is meant to take (``rows_edge_book``
    books; every book has indices out of range on both sides):
    bfloat16, float32 and float64 rows of ROWS_EDGE_WIDTHS columns,
    ROWS_EDGE_E rows into ROWS_EDGE_N targets with a chain of
    ROWS_EDGE_CHAIN (smem); 2,000 rows into 100,000 targets, int32 (smem,
    two passes); ROWS_EDGE_SCAN rows all on one target (scan); the
    one-CTA limit and one past it (smem, sort), int32 and int64; and
    sources one element off alignment (vec 1) on the scan and smem
    routes."""
    g = torch.Generator(device=dev).manual_seed(10)
    limit = ops.ROWS_SMEM_MAX
    cases = [(f"{str(dtype)[6:]} width {width}, a chain of {ROWS_EDGE_CHAIN:,}", "smem",
              (ROWS_EDGE_E, ROWS_EDGE_N, width, dtype, torch.int64, ROWS_EDGE_CHAIN))
             for dtype in (torch.bfloat16, torch.float32, torch.float64)
             for width in ROWS_EDGE_WIDTHS]
    cases += [
        ("2,000 rows into 100,000 targets", "smem",
         (2_000, 100_000, 33, torch.float32, torch.int32)),
        (f"{ROWS_EDGE_SCAN:,} rows on one target, bfloat16 width 7,168", "scan",
         (ROWS_EDGE_SCAN, 1, 7_168, torch.bfloat16, torch.int64, ROWS_EDGE_SCAN)),
        (f"{ROWS_EDGE_SCAN:,} rows on one target, float64 width 33, int32", "scan",
         (ROWS_EDGE_SCAN, 1, 33, torch.float64, torch.int32, ROWS_EDGE_SCAN)),
        (f"the limit, {limit:,} rows into 300, float32 width 2,048, int64", "smem",
         (limit, 300, 2_048, torch.float32, torch.int64, 4_000)),
        (f"the limit, {limit:,} rows into 300, bfloat16 width 1, int32", "smem",
         (limit, 300, 1, torch.bfloat16, torch.int32, 4_000)),
        (f"past the limit, {limit + 1:,} rows into 300, float32 width 2,048, int64", "sort",
         (limit + 1, 300, 2_048, torch.float32, torch.int64, 4_000)),
        (f"past the limit, {limit + 1:,} rows into 300, bfloat16 width 33, int32", "sort",
         (limit + 1, 300, 33, torch.bfloat16, torch.int32, 4_000)),
    ]
    cases += [(f"{str(dtype)[6:]} source one element off alignment, {route}", route,
               (e, n, 2_048, dtype, torch.int64, 0, 1))
              for dtype in (torch.bfloat16, torch.float32, torch.float64)
              for route, e, n in (("scan", 1_024, 4), ("smem", 5_120, 512))]
    rows = []
    for label, route, book in cases:
        out, index, source = rows_edge_book(torch, dev, g, *book)
        rows.append(rows_call(torch, ops, f"edge: {label}", out, index, source, latency,
                              timed=False, route=route))
    check(all(r["vec"] == 1 for r in rows if "alignment" in r["call"]),
          "an unaligned source took vectors")
    return rows


def moe_serving(torch, dev, latency) -> tuple[dict, list]:
    """(a) deepseek-v3-671b at full width, MOE_LAYERS layers: MOE_BATCH
    requests of MOE_PROMPT tokens and MOE_NEW greedy new ones through
    ``serve.decode.generate``; the combine's ``ordered_rows_add`` calls of
    the prefill and of a decode step recorded for the kernel checks."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import get_api
    from repro_torch.models.moe import capacity
    from repro_torch.models.params import count_params, init_params, tree_bytes
    from repro_torch.models.transformer import lm_forward
    from repro_torch.serve.decode import generate

    full = get_config(MOE_ARCH)
    cfg = full.replace(num_layers=MOE_LAYERS)
    api = get_api(cfg)
    decls = api.decls(cfg)
    n_params = count_params(decls)
    m, mla = cfg.moe, cfg.mla
    log(f"[10a] {cfg.name}: reduced: num_layers {full.num_layers}→{cfg.num_layers} "
        f"({m.first_dense_layers} dense layers of d_ff {m.dense_ff}, "
        f"{cfg.num_layers - m.first_dense_layers} routed of {m.num_experts} experts top "
        f"{m.top_k} of d_ff {m.expert_ff} and a shared expert); d_model {cfg.d_model}, "
        f"{cfg.num_heads} MLA heads (q_lora {mla.q_lora}, kv_lora {mla.kv_lora}, rope "
        f"{mla.rope_dim}, nope {mla.nope_dim}, v {mla.v_dim}), vocab {cfg.vocab_size}, "
        f"untied; activations {cfg.act_dtype}; {n_params:,} float32 parameters from seed 0")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(0), decls, torch.float32, dev)
    torch.cuda.synchronize()
    weight_bytes = tree_bytes(params)
    log(f"  init {time.perf_counter() - t0:.2f} s, {weight_bytes / 2**30:.1f} GiB of weights")
    prompt = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))

    calls = []
    routed = cfg.num_layers - m.first_dense_layers
    seen = [0]

    def record(fn, out, index, source, **kw):
        if seen[0] in (0, routed):  # the prefill's first combine, the first decode step's
            calls.append((out.clone(), index.clone(), source.clone()))
        seen[0] += 1
        return fn(out, index, source, **kw)

    with rows_calls(ops, record):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        out = generate(params, cfg, prompt, MOE_NEW)
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t0
        launches = ops.launch_counts()
    check(launches["ordered_rows_add"] == routed * MOE_NEW,
          f"ordered_rows_add launched {launches['ordered_rows_add']} times, not once a routed "
          f"layer a step ({routed} x {MOE_NEW})")
    check(sum(launches.values()) == launches["ordered_rows_add"],
          f"another kernel ran on the serving path: {launches}")
    check(tuple(out.shape) == (MOE_BATCH, MOE_PROMPT + MOE_NEW)
          and torch.equal(out[:, :MOE_PROMPT], prompt.to(torch.int32))
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()), "generated tokens")
    log(f"  generate {MOE_BATCH} x ({MOE_PROMPT} prompt + {MOE_NEW} new) greedy: "
        f"{serve_s * 1e3:.1f} ms (the first call's warm-up included); launches {launches}; "
        f"request 0 continues with {out[0, MOE_PROMPT:].tolist()}")

    def serve_again():
        """Prefill and decode timed apart; every step's logits."""
        with torch.inference_mode():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            cache = api.init_cache(cfg, MOE_BATCH, MOE_PROMPT + MOE_NEW, device=dev)
            logits, cache = api.decode_step(params, cache, prompt, 0, cfg)
            torch.cuda.synchronize()
            prefill_ms = (time.perf_counter() - t0) * 1e3
            steps = [logits]
            cur = logits[:, -1].float().argmax(-1, keepdim=True).to(torch.int32)
            toks = [cur]
            t0 = time.perf_counter()
            for i in range(MOE_PROMPT, MOE_PROMPT + MOE_NEW - 1):
                logits, cache = api.decode_step(params, cache, cur, i, cfg)
                cur = logits[:, -1].float().argmax(-1, keepdim=True).to(torch.int32)
                steps.append(logits)
                toks.append(cur)
            torch.cuda.synchronize()
            decode_ms = (time.perf_counter() - t0) * 1e3 / (MOE_NEW - 1)
        return torch.cat(toks, 1), steps, cache, cur, prefill_ms, decode_ms

    toks, steps, cache, cur, prefill_ms, decode_ms = serve_again()
    check(torch.equal(toks, out[:, MOE_PROMPT:]), "a second run gives other tokens")
    with torch.inference_mode():
        step_ms = graph_ms(torch, lambda: api.decode_step(params, cache, cur, MOE_PROMPT, cfg),
                           DECODE_GRAPH_CALLS)
    del cache
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # the whole model with ordered_rows_add forced plain: the same tokens,
    # every step's logits bit for bit
    with rows_calls(ops, force_plain):
        plain_toks, plain_steps, cache, _, _, _ = serve_again()
    del cache
    check(torch.equal(plain_toks, toks) and all(
        same_bits(torch, a, b) for a, b in zip(steps, plain_steps)),
        "the plain ordered_rows_add gives other logits")

    # the chunked prefill (absorbed MLA through the latent cache) against
    # lm_forward (MLA expanded from the latent)
    with torch.inference_mode():
        expanded, aux, _ = lm_forward(params, prompt, cfg)
    diff = (steps[0].float() - expanded.float())
    rel_rms = float(diff.norm() / expanded.float().norm())
    max_d, scale = float(diff.abs().max()), float(expanded.float().abs().max())
    agree = float((steps[0].argmax(-1) == expanded.argmax(-1)).float().mean())
    check(rel_rms <= LATENT_VS_EXPANDED_RMS and bool(torch.isfinite(expanded.float()).all()),
          f"absorbed vs expanded MLA: relative RMS {rel_rms} (max |d| {max_d} of {scale})")
    del expanded, plain_steps, steps

    # bounds: the prefill's float32 products (every other weight once a
    # token; each expert's three over its capacity slots), a decode step's
    # weight read (every expert runs over its slots; the embedding table is
    # read a row a token)
    tokens = MOE_BATCH * MOE_PROMPT
    expert = 3 * cfg.d_model * m.expert_ff * m.num_experts * routed
    rest = n_params - expert - cfg.vocab_size * cfg.d_model
    prefill_ops = 2 * tokens * rest + 2 * capacity(tokens, cfg) * expert
    prefill_bound_ms = prefill_ops / FP32_OPS_PER_S * 1e3
    decode_bytes = weight_bytes - cfg.vocab_size * cfg.d_model * 4
    decode_bound_ms = decode_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  prefill {MOE_BATCH} x {MOE_PROMPT}: {prefill_ms:.1f} ms (bound "
        f"{prefill_ops / 1e12:.2f} TFLOP float32 at 67 TFLOP/s = {prefill_bound_ms:.1f} ms); "
        f"decode {decode_ms:.2f} ms a step of {MOE_BATCH} tokens on the host clock, "
        f"{step_ms:.2f} ms on the card (a CUDA graph of the step; idle "
        f"{1 - step_ms / decode_ms:.1%}); weight-read bound {decode_bytes / 1e9:.1f} GB at "
        f"3.35 TB/s = {decode_bound_ms:.2f} ms; peak {peak_gb:.2f} GB allocated")
    log(f"  the same requests with ordered_rows_add forced plain: the same tokens, every "
        f"step's logits bit for bit; chunked prefill (absorbed MLA) vs lm_forward (expanded): "
        f"relative RMS {rel_rms:.3g} (limit {LATENT_VS_EXPANDED_RMS}), max |d| {max_d:.3g} of "
        f"max |logits| {scale:.4g}, argmax agrees at {agree:.1%} of positions; aux "
        f"{float(aux):.4f}")
    del params
    summary = {"params": n_params, "weight_gib": weight_bytes / 2**30, "serve_ms": serve_s * 1e3,
               "prefill_ms": prefill_ms, "prefill_bound_ms": prefill_bound_ms,
               "decode_ms_per_step": decode_ms, "decode_device_ms_per_step": step_ms,
               "decode_bound_ms": decode_bound_ms, "peak_gb": peak_gb,
               "absorbed_vs_expanded_rel_rms": rel_rms, "absorbed_vs_expanded_max": max_d,
               "argmax_agree": agree, "launches": launches}
    return summary, calls


def moe_training(torch, dev) -> dict:
    """(b) the MoE smoke configs (deepseek-v3 with mtp_depth 1, kimi-k2)
    trained through ``launch/train`` on the card: MOE_TRAIN_ARGS steps
    uninterrupted, then with checkpoints every 3 steps killed at step 4 by
    ``--fault-step`` and resumed; the resumed losses equal the uninterrupted
    ones bit for bit.  One step of each card against CPU."""
    import math
    import tempfile
    import threading

    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import get_api
    from repro_torch.models.params import init_params, tree_leaves, tree_map
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import init_train_state, make_train_step

    out = {}
    for arch, mtp in MOE_TRAIN.items():
        cfg = get_smoke(arch).replace(mtp_depth=mtp)
        log(f"[10b] {cfg.name} (mtp_depth {mtp}) trained through launch/train: "
            + " ".join(MOE_TRAIN_ARGS))
        base = ["--arch", arch, *MOE_TRAIN_ARGS, "--device", str(dev)]
        smoke = train.get_smoke
        train.get_smoke = lambda a, cfg=cfg: cfg  # the smoke config with its mtp_depth
        try:
            with tempfile.TemporaryDirectory() as d:
                ops.reset_launch_counts()
                rc, _ = captured(train.main, base + ["--metrics", f"{d}/plain.jsonl"])
                launches = ops.launch_counts()
                check(rc == 0, f"launch/train returned {rc}")
                plain = {m["step"]: m["loss"] for m in map(json.loads, open(f"{d}/plain.jsonl"))}
                ck = ["--ckpt-dir", f"{d}/ckpt", "--ckpt-every", "3"]
                try:
                    captured(train.main, base + ck + ["--fault-step", "4",
                                                     "--metrics", f"{d}/run.jsonl"])
                except RuntimeError as e:
                    if "injected fault at step 4" not in str(e):
                        raise
                else:
                    check(False, "the injected fault did not fire")
                for t in threading.enumerate():  # the resume reads the last checkpoint started
                    if t.name.startswith("ckpt-write-"):
                        t.join()
                rc, lines = captured(train.main, base + ck + ["--metrics", f"{d}/run.jsonl"])
                check(rc == 0 and any("resumed from step 3" in x for x in lines),
                      f"{arch}: the resume returned {rc}")
                run = [json.loads(x) for x in open(f"{d}/run.jsonl")]
        finally:
            train.get_smoke = smoke
        check([m["step"] for m in run] == [0, 1, 2, 3, 4, 5], f"{arch} steps {run}")
        check(all(m["loss"] == plain[m["step"]] and math.isfinite(m["loss"]) for m in run),
              f"{arch}: the resumed losses {run} are not the uninterrupted {plain}")
        check(launches["ordered_rows_add"] > 0, f"{arch}: no ordered_rows_add launch")

        # one step card against CPU, the same weights and batch
        params = init_params(torch.Generator().manual_seed(0), get_api(cfg).decls(cfg),
                             torch.float32, torch.device("cpu"))
        batch = SyntheticLM(cfg, 4, 64, seed=0)(0)
        opt = AdamW()
        step = make_train_step(cfg, opt)
        runs = []
        for where in (dev, torch.device("cpu")):
            p = tree_map(lambda a: a.to(where, copy=True), params)
            p, _, mt = step(p, init_train_state(cfg, opt, p),
                            {k: torch.from_numpy(v).to(where) for k, v in batch.items()})
            runs.append((float(mt["loss"]), float(mt["grad_norm"]),
                         max(float((a.cpu() - b).abs().max()) for a, b in zip(
                             tree_leaves(p), tree_leaves(params)))))
        (lg, ng, _), (lc, nc, _) = runs
        check(abs(lg - lc) <= MOE_CARD_CPU_RTOL * abs(lc)
              and abs(ng - nc) <= 10 * MOE_CARD_CPU_RTOL * abs(nc),
              f"{arch}: card loss {lg} / grad_norm {ng} against CPU {lc} / {nc}")
        log(f"  losses {[plain[s] for s in sorted(plain)]}; killed at step 4 and resumed from "
            f"step 3: steps 0-5 repeat the uninterrupted losses bit for bit; launches "
            f"{launches['ordered_rows_add']} ordered_rows_add; one step card vs CPU: loss "
            f"{lg:.7f} / {lc:.7f}, grad_norm {ng:.6f} / {nc:.6f} (rtol {MOE_CARD_CPU_RTOL}, "
            f"{10 * MOE_CARD_CPU_RTOL})")
        out[arch] = {"losses": [plain[s] for s in sorted(plain)], "launches": launches,
                     "card_loss": lg, "cpu_loss": lc, "card_grad_norm": ng, "cpu_grad_norm": nc}
    return out


def supervised_training(torch, dev) -> dict:
    """(c) ``run_supervised`` over the port's trainer on the card
    (deepseek-v3's smoke config, a subprocess an attempt): FAULT_STEP crashes
    the first attempt, the supervisor restarts it, and it resumes from its
    last checkpoint; every step's loss equals an uninterrupted in-process
    run's bit for bit."""
    import os
    import tempfile

    from repro_torch.launch import train
    from repro_torch.launch.supervisor import run_supervised

    args = ["--arch", MOE_ARCH, *MOE_TRAIN_ARGS, "--device", str(dev)]
    log(f"[10c] run_supervised over launch/train on the card: {' '.join(args)}, "
        f"FAULT_STEP={SUPERVISED_FAULT}, checkpoints every 2 steps")
    with tempfile.TemporaryDirectory() as d:
        rc, _ = captured(train.main, args + ["--metrics", f"{d}/plain.jsonl"])
        check(rc == 0, f"launch/train returned {rc}")
        plain = {m["step"]: m["loss"] for m in map(json.loads, open(f"{d}/plain.jsonl"))}
        os.environ["FAULT_STEP"] = str(SUPERVISED_FAULT)
        env_path = os.environ.get("PYTHONPATH")
        os.environ["PYTHONPATH"] = str(ROOT / "src") + (os.pathsep + env_path if env_path else "")
        t0 = time.perf_counter()
        try:
            rc = run_supervised(args + ["--ckpt-every", "2", "--metrics", f"{d}/run.jsonl"],
                                ckpt_dir=f"{d}/ckpt", max_restarts=2, deadline_s=600,
                                poll_s=0.5)
        finally:
            os.environ.pop("FAULT_STEP", None)
            if env_path is None:
                os.environ.pop("PYTHONPATH")
            else:
                os.environ["PYTHONPATH"] = env_path
        wall = time.perf_counter() - t0
        check(rc == 0, f"run_supervised returned {rc}")
        run = [json.loads(x) for x in open(f"{d}/run.jsonl")]
    steps = [m["step"] for m in run]
    check(steps[:SUPERVISED_FAULT] == list(range(SUPERVISED_FAULT))
          and steps[SUPERVISED_FAULT:] == list(range(steps[SUPERVISED_FAULT], 6))
          and steps[SUPERVISED_FAULT] <= SUPERVISED_FAULT, f"supervised steps {steps}")
    check(all(m["loss"] == plain[m["step"]] for m in run),
          f"supervised losses {run} against the uninterrupted {plain}")
    log(f"  restarted once; steps {steps} in {wall:.1f} s (two processes); every loss the "
        f"uninterrupted run's bit for bit")
    return {"steps": steps, "wall_s": wall, "losses": [m["loss"] for m in run]}


DETERMINISTIC_RUNS = (("qwen3-1.7b", "full", 2, 2, 64), ("deepseek-v3-671b", "smoke", 0, 4, 64))


def deterministic_main(device: str = "cuda") -> int:
    """In a process of its own, under ``torch.use_deterministic_algorithms``
    (with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, so any op left with an
    unordered CUDA form raises): for each of DETERMINISTIC_RUNS (arch,
    config, layers or 0 for the config's, batch, seq) the gradients of one
    step twice, held equal bit for bit, then one AdamW step through
    ``make_train_step``.  Prints one JSON line."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config, get_smoke
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.models import get_api
    from repro_torch.models.params import init_params, tree_leaves, tree_map
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import init_train_state, make_train_step

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    out = {}
    for arch, which, layers, batch, seq in DETERMINISTIC_RUNS:
        cfg = get_config(arch) if which == "full" else get_smoke(arch).replace(mtp_depth=1)
        if layers:
            cfg = cfg.replace(num_layers=layers)
        api = get_api(cfg)
        params = init_params(torch.Generator(device=dev).manual_seed(0), api.decls(cfg),
                             torch.float32, dev)
        data = {k: torch.from_numpy(v).to(dev) for k, v in SyntheticLM(cfg, batch, seq)(0).items()}
        ops.reset_launch_counts()
        grads = []
        for _ in range(2):
            leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
            it = iter(leaves)
            loss, _ = api.loss(tree_map(lambda _: next(it), params), data, cfg)
            grads.append(torch.autograd.grad(loss, leaves))
        same = all(torch.equal(a, b) for a, b in zip(*grads))
        opt = AdamW()
        _, _, m = make_train_step(cfg, opt)(params, init_train_state(cfg, opt, params), data)
        out[cfg.name] = {"layers": cfg.num_layers, "batch": [batch, seq], "grads_equal": same,
                         "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                         "ordered_rows_add": ops.launch_counts()["ordered_rows_add"],
                         "finite": bool(np.isfinite(float(m["loss"])))}
        del params, grads
    print(json.dumps(out), flush=True)
    return 0


def deterministic_steps(torch) -> dict:
    """(d) ``deterministic_main`` in a subprocess."""
    import os

    log("[10d] under torch.use_deterministic_algorithms(True), CUBLAS_WORKSPACE_CONFIG=:4096:8, "
        "in a process of its own: " + "; ".join(
            f"{a} ({w}{f', {n} layers' if n else ''}) batch {b} x {s}"
            for a, w, n, b, s in DETERMINISTIC_RUNS))
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8",
               PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; "
                           "sys.exit(chip_smoke.deterministic_main())"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"the deterministic steps failed (rc {proc.returncode}):\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    for name, r in res.items():
        check(r["grads_equal"] and r["finite"] and r["ordered_rows_add"] > 0,
              f"{name} under deterministic algorithms: {r}")
    log(f"  no op raised; two steps' gradients equal bit for bit; {res} "
        f"({time.perf_counter() - t0:.1f} s)")
    return res


def moe_paths(torch, np, dev, kernels: list, dense_train_launches: dict) -> None:
    """Phase [10]: deepseek-v3-671b served at full width (4 layers), the MoE
    smoke configs trained and resumed bit for bit, the supervisor on the
    card, the deterministic-algorithms steps, and ``ordered_rows_add`` held
    against its plain version at the path's inputs and at edge shapes → the
    kernel's entry."""
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    latency = add_latency_ns(torch)
    serve, calls = moe_serving(torch, dev, latency)
    gc.collect()
    torch.cuda.empty_cache()

    # the kernel at the path's inputs, at the qwen3 embedding gradient and at
    # edge shapes
    prefill = rows_call(torch, ops, "the prefill's combine", *calls[0], latency)
    decode = rows_call(torch, ops, "a decode step's combine", *calls[1], latency)
    del calls
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM

    qwen = get_config(DENSE_ARCH)
    toks = torch.from_numpy(SyntheticLM(qwen, TRAIN_BATCH, TRAIN_SEQ, seed=0)(0)["tokens"]).to(dev)
    g = torch.Generator(device=dev).manual_seed(11)
    embed = rows_call(torch, ops, f"the {DENSE_ARCH} embedding gradient ({TRAIN_BATCH} x "
                      f"{TRAIN_SEQ} tokens)",
                      torch.zeros((qwen.vocab_size, qwen.d_model), device=dev), toks.reshape(-1),
                      torch.randn((toks.numel(), qwen.d_model), generator=g, device=dev), latency)
    edges = rows_edges(torch, ops, dev, latency)
    gc.collect()
    torch.cuda.empty_cache()

    train = moe_training(torch, dev)
    supervised = supervised_training(torch, dev)
    determinism = deterministic_steps(torch)
    by_path = {"deepseek-v3-671b serving (4 layers, full width)":
               serve["launches"]["ordered_rows_add"],
               f"{DENSE_ARCH} training, 6 steps (phase [9])":
               dense_train_launches["ordered_rows_add"],
               **{f"{a} smoke training, 6 steps": r["launches"]["ordered_rows_add"]
                  for a, r in train.items()}}
    kernels.append({
        "name": "ordered_rows_add", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ordered_rows.cu",
        "replaces": "src/repro/models/moe.py:136-138 (XLA scatter-add on the CPU, no "
                    "pallas_call; also the backward of moe.py:122 and of the embedding lookups)",
        "launches": sum(by_path.values()), "launches_by_path": by_path, "max_abs_err": 0.0,
        "ms": prefill["ms"], "partition_ms": prefill["partition_ms"],
        "fold_ms": prefill["fold_ms"], "rows_route": prefill["rows_route"],
        "plain_ms": prefill["plain_ms"], "bound_ms": prefill["bound_ms"],
        "bound_by": prefill["bound_by"], "library_ms": prefill["library_ms"],
        "byte_bound_ms": prefill["byte_bound_ms"], "chain_bound_ms": prefill["chain_bound_ms"],
        "add_latency_ns": latency, "path": "deepseek-v3-671b served (4 layers), the training "
        "runs of phases [9] and [10]",
        "shape": f"E={prefill['rows']} ({prefill['kept']} kept) rows of {prefill['width']} "
                 f"bfloat16 into {prefill['targets']} tokens, int64 index",
        "calls": [prefill, decode, embed], "edges": len(edges)})
    log("[10] " + json.dumps({"serve": serve, "train": train, "supervised": supervised,
                              "deterministic": determinism}, default=str))


# ---------------------------------------------------------------------------
# [11] the hybrid, audio and VLM families
# ---------------------------------------------------------------------------

HYBRID_ARCH, AUDIO_ARCH, VLM_ARCH = "recurrentgemma-2b", "whisper-medium", "pixtral-12b"
HYBRID_BATCH, HYBRID_PROMPT, HYBRID_NEW = 4, 64, 32
HYBRID_PREFILLS = ((4, 2_048), (1, 8_192))  # the scan path; the blockwise path, window 2,048
AUDIO_BATCH, AUDIO_PROMPT, AUDIO_NEW = 2, 4, 32
VLM_BATCH, VLM_TEXT, VLM_NEW = 2, 256, 32
# token-by-token decode against the prefill, bf16 activations: the relative
# RMS of the last position's logits' difference
DECODE_VS_PREFILL_RMS = 5e-2
# trained through launch/train, 3 steps: arch -> (layers, 0 for the config's;
# batch; seq); pixtral-12b cut to 6 layers (40 need ~196 GB of state)
ZOO_TRAIN = {HYBRID_ARCH: (0, 2, 512), AUDIO_ARCH: (0, 2, 448), VLM_ARCH: (6, 2, 768)}
ZOO_CARD_CPU_TOL = 1e-5  # float32 smoke configs: the model path's rtol and atol


def rel_rms(torch, a, b) -> float:
    """The RMS of ``a - b`` relative to ``b``'s, in float32."""
    d = a.float() - b.float()
    return float(d.norm() / b.float().norm())


def serve_timings(torch, api, params, cfg, cache, cur, idx, new, step_idx):
    """``new - 1`` greedy steps from ``cur`` at ``idx``, timed on the host
    clock (ms a step), and one step at ``step_idx`` in a CUDA graph (device
    ms) → (tokens, host ms, device ms)."""
    toks = [cur]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(idx, idx + new - 1):
        logits, cache = api.decode_step(params, cache, cur, i, cfg)
        cur = logits[:, -1].float().argmax(-1, keepdim=True).to(torch.int32)
        toks.append(cur)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3 / (new - 1)
    device_ms = graph_ms(torch, lambda: api.decode_step(params, cache, cur, step_idx, cfg),
                         DECODE_GRAPH_CALLS)
    return torch.cat(toks, 1), host_ms, device_ms


def check_generated(torch, out, prompt, new, cfg, launches, label) -> None:
    """``generate``'s output: the prompt, then ``new`` tokens of the
    vocabulary, and no kernel launched."""
    check(tuple(out.shape) == (prompt.shape[0], prompt.shape[1] + new)
          and torch.equal(out[:, :prompt.shape[1]], prompt.to(torch.int32))
          and bool(((out >= 0) & (out < cfg.vocab_size)).all()), f"{label}: generated tokens")
    check(sum(launches.values()) == 0, f"{label}: a kernel ran on the serving path: {launches}")


def fresh_model(torch, dev, cfg, label):
    """``cfg``'s float32 weights from seed 0 on the card, the peak reset."""
    from repro_torch.models import get_api
    from repro_torch.models.params import count_params, init_params, tree_bytes

    api = get_api(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(0), api.decls(cfg),
                         torch.float32, dev)
    torch.cuda.synchronize()
    n, size = count_params(api.decls(cfg)), tree_bytes(params)
    log(f"[11{label}] {cfg.name}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} query / {cfg.num_kv_heads} KV heads of {cfg.hd()}, d_ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size}, activations {cfg.act_dtype}; {n:,} float32 parameters from "
        f"seed 0 ({size / 1e9:.2f} GB, init {time.perf_counter() - t0:.2f} s)")
    return api, params, n, size


def hybrid_serving(torch, dev) -> dict:
    """(a) recurrentgemma-2b at full width and depth: HYBRID_BATCH requests of
    HYBRID_PROMPT tokens warmed token by token and HYBRID_NEW greedy new
    ones; lm_forward prefills at HYBRID_PREFILLS (each timed after an
    untimed first call of its shape); token-by-token decode
    against lm_forward (bf16, and every position in float32); the RG-LRU
    scan timed alone at the first prefill's shape."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import griffin
    from repro_torch.models.attention import FLASH_MIN_KV
    from repro_torch.models.transformer import lm_forward
    from repro_torch.serve.decode import generate

    cfg = get_config(HYBRID_ARCH)
    api, params, n_params, weight_bytes = fresh_model(torch, dev, cfg, "a")
    g = cfg.griffin
    rec_layers = sum(k == "rec" for k in (g.pattern * cfg.num_layers)[:cfg.num_layers])
    P, N, B = HYBRID_PROMPT, HYBRID_NEW, HYBRID_BATCH
    prompt = torch.randint(0, cfg.vocab_size, (B, P), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = generate(params, cfg, prompt, N)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    check_generated(torch, out, prompt, N, cfg, launches, cfg.name)

    with torch.inference_mode():
        cache = api.init_cache(cfg, B, P + N, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(P):
            logits, cache = api.decode_step(params, cache, prompt[:, i:i + 1], i, cfg)
        torch.cuda.synchronize()
        warm_ms = (time.perf_counter() - t0) * 1e3
        cur = logits[:, -1].float().argmax(-1, keepdim=True).to(torch.int32)
        toks, decode_ms, step_ms = serve_timings(torch, api, params, cfg, cache, cur, P, N,
                                                 P + N - 1)
        check(torch.equal(toks, out[:, P:]), "a second run gives other tokens")
        full, _, _ = lm_forward(params, prompt, cfg)
        last_rms = rel_rms(torch, logits[:, -1], full[:, -1])
        agree = float((logits[:, -1].argmax(-1) == full[:, -1].argmax(-1)).float().mean())
        check(last_rms <= DECODE_VS_PREFILL_RMS,
              f"token-by-token decode vs lm_forward, bf16: relative RMS {last_rms}")
        # float32 activations, request 0: every position
        cfg32 = cfg.replace(act_dtype="float32")
        chunked, _, _ = lm_forward(params, prompt[:1], cfg32)
        cache32 = api.init_cache(cfg32, 1, P, device=dev)
        steps = []
        for i in range(P):
            step_logits, cache32 = api.decode_step(params, cache32, prompt[:1, i:i + 1], i, cfg32)
            steps.append(step_logits[:, 0])
        per_pos = (chunked - torch.stack(steps, 1)).abs().amax(dim=(0, 2))
        scale = float(chunked.abs().max())
        check(float(per_pos.max()) <= LOGITS_TOL * scale,
              f"float32 decode vs lm_forward: max|d| {float(per_pos.max())} (max {scale})")
        del cache, cache32, full, chunked, steps, logits

        prefills = []
        for b, s in HYBRID_PREFILLS:
            toks_p = torch.randint(0, cfg.vocab_size, (b, s), device=dev,
                                   generator=torch.Generator(device=dev).manual_seed(s))
            lm_forward(params, toks_p, cfg)  # the shape's first call, untimed
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits_p, _, _ = lm_forward(params, toks_p, cfg)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            check(tuple(logits_p.shape) == (b, s, cfg.vocab_size)
                  and bool(torch.isfinite(logits_p[:, -1].float()).all()), f"prefill {b} x {s}")
            del logits_p
            prefills.append({"batch": b, "seq": s, "ms": ms,
                             "bound_ms": 2 * n_params * b * s / FP32_OPS_PER_S * 1e3,
                             "attention": "blockwise" if s >= FLASH_MIN_KV else "dense"})
        # the RG-LRU scan alone at the first prefill's shape, float32
        b, s = HYBRID_PREFILLS[0]
        gen = torch.Generator(device=dev).manual_seed(2)
        a = torch.rand((b, s, g.lru_width), generator=gen, device=dev)
        x = torch.randn((b, s, g.lru_width), generator=gen, device=dev)
        scan_ms = graph_ms(torch, lambda: griffin.associative_scan(a, x), 3)
        del a, x
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    decode_bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    scan_share = rec_layers * scan_ms / prefills[0]["ms"]
    log(f"  generate {B} x ({P} prompt warmed token by token + {N} new) greedy: {serve_ms:.1f} ms "
        f"(the first call's warm-up included); launches {launches}; request 0 continues with "
        f"{out[0, P:].tolist()}")
    log(f"  warm-up of {P} prompt tokens {warm_ms:.1f} ms ({warm_ms / P:.2f} ms a token); decode "
        f"{decode_ms:.2f} ms a step of {B} tokens on the host clock, {step_ms:.2f} ms on the card "
        f"(a CUDA graph of the step; idle {1 - step_ms / decode_ms:.1%}); weight-read bound "
        f"{weight_bytes / 1e9:.2f} GB at 3.35 TB/s = {decode_bound_ms:.2f} ms")
    log(f"  token-by-token decode vs lm_forward at position {P - 1}: {cfg.act_dtype} relative RMS "
        f"{last_rms:.3g} (limit {DECODE_VS_PREFILL_RMS}), argmax agrees for {agree:.0%} of "
        f"requests; float32, request 0, every position: worst max|d| {float(per_pos.max()):.3g} "
        f"(position {int(per_pos.argmax())}) of max|logits| {scale:.4g} (limit {LOGITS_TOL} x)")
    for p in prefills:
        log(f"  lm_forward prefill {p['batch']} x {p['seq']} ({p['attention']} attention, window "
            f"{g.window}): {p['ms']:.1f} ms (float32 product bound {p['bound_ms']:.1f} ms)")
    log(f"  RG-LRU scan alone at {b} x {s} x {g.lru_width}: {scan_ms:.3f} ms, x {rec_layers} "
        f"recurrent layers = {scan_share:.1%} of the {b} x {s} prefill; peak {peak_gb:.2f} GB")
    del params
    return {"params": n_params, "weight_gb": weight_bytes / 1e9, "serve_ms": serve_ms,
            "warm_ms": warm_ms, "decode_ms_per_step": decode_ms,
            "decode_device_ms_per_step": step_ms, "decode_bound_ms": decode_bound_ms,
            "prefills": prefills, "scan_ms": scan_ms, "scan_share_of_prefill": scan_share,
            "decode_vs_prefill_rel_rms": last_rms, "float32_worst": float(per_pos.max()),
            "peak_gb": peak_gb, "launches": launches}


def audio_serving(torch, dev) -> dict:
    """(b) whisper-medium at full width and depth: ``whisper_prefill`` of
    AUDIO_BATCH x 1,500 frames (timed after an untimed first call),
    AUDIO_PROMPT tokens warmed token by token
    and AUDIO_NEW greedy ones against the cross cache it made, held against
    the teacher-forced decoder; then ``generate`` as the reference runs it
    (the zero cross cache of ``init_cache``)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import whisper
    from repro_torch.models.params import tree_bytes
    from repro_torch.serve.decode import generate

    cfg = get_config(AUDIO_ARCH)
    api, params, n_params, weight_bytes = fresh_model(torch, dev, cfg, "b")
    P, N, B, F = AUDIO_PROMPT, AUDIO_NEW, AUDIO_BATCH, cfg.encdec.num_frames
    gen = torch.Generator(device=dev).manual_seed(2)
    frames = torch.randn((B, F, cfg.d_model), generator=gen, device=dev).to(cfg.adt())
    prompt = torch.randint(0, cfg.vocab_size, (B, P), generator=gen, device=dev)
    with torch.inference_mode():
        ops.reset_launch_counts()
        empty = api.init_cache(cfg, B, P + N, device=dev)
        whisper.whisper_prefill(params, frames, empty, cfg)  # the first call, untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cache = whisper.whisper_prefill(params, frames, empty, cfg)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        check(bool(torch.isfinite(cache["cross"]["k"].float()).all())
              and bool(cache["cross"]["v"].any()), "cross K/V")
        for i in range(P):
            logits, cache = api.decode_step(params, cache, prompt[:, i:i + 1], i, cfg)
        cur = logits[:, -1].float().argmax(-1, keepdim=True).to(torch.int32)
        toks, decode_ms, step_ms = serve_timings(torch, api, params, cfg, cache, cur, P, N,
                                                 P + N - 1)
        launches = ops.launch_counts()
        check(sum(launches.values()) == 0, f"a kernel ran on the audio path: {launches}")
        check(bool(((toks >= 0) & (toks < cfg.vocab_size)).all()), "decoded tokens")
        forced = api.prefill(params, {"frames": frames, "tokens": prompt}, cfg)
        last_rms = rel_rms(torch, logits[:, -1], forced[:, -1])
        check(last_rms <= DECODE_VS_PREFILL_RMS,
              f"decode against the prefill's cross cache vs the teacher-forced decoder: "
              f"relative RMS {last_rms}")
        del cache, forced, logits
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(params, cfg, prompt, N)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    gen_launches = ops.launch_counts()
    check_generated(torch, out, prompt, N, cfg, gen_launches, cfg.name)
    dec_bytes = tree_bytes({k: params[k] for k in ("embed", "dec_layers", "final_ln")})
    decode_bound_ms = dec_bytes / HBM_BYTES_PER_S * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    log(f"  whisper_prefill {B} x {F} frames (the encoder and {cfg.num_layers} layers' cross K/V): "
        f"{prefill_ms:.1f} ms; decode {decode_ms:.2f} ms a step of {B} tokens on the host clock, "
        f"{step_ms:.2f} ms on the card (a CUDA graph of the step; idle "
        f"{1 - step_ms / decode_ms:.1%}); the decoder's weight-read bound "
        f"{dec_bytes / 1e9:.3f} GB at 3.35 TB/s = {decode_bound_ms:.2f} ms; request 0 decodes "
        f"{toks[0].tolist()}")
    log(f"  decode against the prefill's cross cache vs the teacher-forced decoder at position "
        f"{P - 1}: relative RMS {last_rms:.3g} (limit {DECODE_VS_PREFILL_RMS}); generate as the "
        f"reference runs it (zero cross cache): {B} x ({P} + {N}) in {serve_ms:.1f} ms, "
        f"launches {gen_launches}; peak {peak_gb:.2f} GB")
    del params
    return {"params": n_params, "weight_gb": weight_bytes / 1e9, "prefill_ms": prefill_ms,
            "decode_ms_per_step": decode_ms, "decode_device_ms_per_step": step_ms,
            "decoder_weight_gb": dec_bytes / 1e9, "decode_bound_ms": decode_bound_ms,
            "generate_ms": serve_ms, "decode_vs_forced_rel_rms": last_rms, "peak_gb": peak_gb,
            "launches": launches}


def vlm_serving(torch, dev) -> dict:
    """(c) pixtral-12b at full width and depth: a prefill of VLM_BATCH
    requests of 256 patches and VLM_TEXT text tokens (timed after an untimed
    first call); ``generate`` of VLM_NEW
    greedy tokens on the text, then its prefill and decode timed apart."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serve.decode import generate

    cfg = get_config(VLM_ARCH)
    api, params, n_params, weight_bytes = fresh_model(torch, dev, cfg, "c")
    B, T, N, Pch = VLM_BATCH, VLM_TEXT, VLM_NEW, cfg.vlm_patches
    gen = torch.Generator(device=dev).manual_seed(3)
    text = torch.randint(0, cfg.vocab_size, (B, T), generator=gen, device=dev)
    patches = torch.randn((B, Pch, cfg.d_model), generator=gen, device=dev).to(cfg.adt())
    with torch.inference_mode():
        api.prefill(params, {"tokens": text, "image_embeds": patches}, cfg)  # first, untimed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = api.prefill(params, {"tokens": text, "image_embeds": patches}, cfg)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        check(tuple(logits.shape) == (B, Pch + T, cfg.vocab_size)
              and bool(torch.isfinite(logits.float()).all()), "vlm prefill logits")
        text_only = api.prefill(params, {"tokens": text}, cfg)
        moved = rel_rms(torch, logits[:, Pch:], text_only)
        check(moved > 0, "the patches left the text's logits as they were")
        del logits, text_only
    ops.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = generate(params, cfg, text, N)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t0) * 1e3
    launches = ops.launch_counts()
    check_generated(torch, out, text, N, cfg, launches, cfg.name)
    with torch.inference_mode():
        cache = api.init_cache(cfg, B, T + N, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = api.decode_step(params, cache, text, 0, cfg)
        torch.cuda.synchronize()
        text_prefill_ms = (time.perf_counter() - t0) * 1e3
        cur = logits[:, -1].float().argmax(-1, keepdim=True).to(torch.int32)
        toks, decode_ms, step_ms = serve_timings(torch, api, params, cfg, cache, cur, T, N,
                                                 T + N - 1)
        check(torch.equal(toks, out[:, T:]), "a second run gives other tokens")
        del cache, logits
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    tokens = B * (Pch + T)
    prefill_bound_ms = 2 * n_params * tokens / FP32_OPS_PER_S * 1e3
    decode_bound_ms = weight_bytes / HBM_BYTES_PER_S * 1e3
    log(f"  prefill {B} x ({Pch} patches + {T} text): {prefill_ms:.1f} ms (float32 product bound "
        f"{prefill_bound_ms:.1f} ms); the patches move the text's logits by relative RMS "
        f"{moved:.3g}")
    log(f"  generate {B} x ({T} text + {N} new) greedy: {serve_ms:.1f} ms; launches {launches}; "
        f"the text's chunked prefill {text_prefill_ms:.1f} ms; decode {decode_ms:.2f} ms a step "
        f"of {B} tokens on the host clock, {step_ms:.2f} ms on the card (a CUDA graph of the "
        f"step; idle {1 - step_ms / decode_ms:.1%}); weight-read bound {weight_bytes / 1e9:.2f} "
        f"GB at 3.35 TB/s = {decode_bound_ms:.2f} ms; peak {peak_gb:.2f} GB")
    del params
    return {"params": n_params, "weight_gb": weight_bytes / 1e9, "prefill_ms": prefill_ms,
            "prefill_bound_ms": prefill_bound_ms, "generate_ms": serve_ms,
            "text_prefill_ms": text_prefill_ms, "decode_ms_per_step": decode_ms,
            "decode_device_ms_per_step": step_ms, "decode_bound_ms": decode_bound_ms,
            "peak_gb": peak_gb, "launches": launches}


def train_losses(path: str) -> list[dict]:
    """A ``launch/train`` metrics file's lines."""
    with open(path) as f:
        return [json.loads(line) for line in f]


def killed_and_resumed(train, base: list, d: str, label: str) -> tuple[list, list]:
    """``launch/train`` with ``base`` arguments, a checkpoint at step 0 and
    ``--fault-step 2``; then resumed from that checkpoint and stopped by
    ``--fault-step 3`` before it checkpoints again → (the killed run's
    metrics, the resumed run's)."""
    import os
    import threading

    ck = ["--ckpt-dir", f"{d}/ckpt", "--ckpt-every", "100"]
    for fault, steps, name in ((2, 3, "killed"), (3, 4, "resumed")):
        try:
            captured(train.main, base + ck + ["--steps", str(steps), "--fault-step", str(fault),
                                             "--metrics", f"{d}/{name}.jsonl"])
        except RuntimeError as e:  # the injected fault, and nothing else
            if f"injected fault at step {fault}" not in str(e):
                raise
        else:
            check(False, f"{label}: the injected fault did not fire")
        for t in threading.enumerate():  # the step-0 checkpoint written in full
            if t.name.startswith("ckpt-write-"):
                t.join()
        if name == "killed":
            saved = sorted(os.listdir(f"{d}/ckpt"))
            check(saved == ["ckpt_00000000"], f"{label}: checkpoints {saved}")
    return train_losses(f"{d}/killed.jsonl"), train_losses(f"{d}/resumed.jsonl")


def zoo_train_main(device: str = "cuda") -> int:
    """In a process of its own, under ``torch.use_deterministic_algorithms``
    (with ``CUBLAS_WORKSPACE_CONFIG=:4096:8``): each of ZOO_TRAIN trained
    through ``launch/train`` for 3 steps, twice, every loss held bit for bit
    between the two runs and the first against the model's own loss of the
    same weights and batch; then each family's smoke config trained 3 steps,
    killed after a checkpoint at step 0 and resumed from it, every loss bit
    for bit.  The full-width runs write no checkpoint: one of
    ``recurrentgemma-2b`` is 32.2 GB, of ``pixtral-12b`` at 6 layers 35.7 GB,
    and a run that writes them beside phase [9]'s 20.7 GB checkpoints needs
    more than 45 GiB of disk writes; ``tools/zoo_resume.py`` resumes each at
    full width on its own.  Prints one JSON line."""
    import math
    import tempfile

    import torch

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import get_api
    from repro_torch.models.params import count_params, init_params
    from repro_torch.train.train_step import batch_to_device

    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device(device)
    full_config = train.get_config
    out = {}
    for arch, (layers, batch, seq) in ZOO_TRAIN.items():
        cfg = full_config(arch)
        if layers:
            cfg = cfg.replace(num_layers=layers)
        n = count_params(get_api(cfg).decls(cfg))
        log(f"[11d] {cfg.name}" + (f" (reduced: num_layers {full_config(arch).num_layers}→"
                                   f"{layers})" if layers else "")
            + f", {n:,} parameters, trained through launch/train twice: batch {batch} x seq "
            f"{seq}, 3 steps, AdamW, float32 weights and moments")
        base = ["--arch", arch, "--steps", "3", "--batch", str(batch), "--seq", str(seq),
                "--seed", "0", "--device", device]
        runs = []
        train.get_config = lambda a, cfg=cfg: cfg
        try:
            with tempfile.TemporaryDirectory() as d:
                for run in range(2):
                    gc.collect()
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                    ops.reset_launch_counts()
                    rc, _ = captured(train.main, base + ["--metrics", f"{d}/{run}.jsonl"])
                    check(rc == 0, f"{arch}: launch/train returned {rc}")
                    runs.append((train_losses(f"{d}/{run}.jsonl"), ops.launch_counts(),
                                 torch.cuda.max_memory_allocated() / 1e9))
        finally:
            train.get_config = full_config
        (plain, launches, peak_gb), (again, _, _) = runs
        losses = [m["loss"] for m in plain]
        check(len(losses) == 3 and all(math.isfinite(x) for x in losses), f"{arch}: {losses}")
        check([m["loss"] for m in again] == losses,
              f"{arch}: a second run's losses {[m['loss'] for m in again]}, not {losses}")
        check(launches["ordered_rows_add"] == 3 and sum(launches.values()) == 3,
              f"{arch}: launches {launches}, not one ordered_rows_add a step")
        api = get_api(cfg)
        with torch.no_grad():
            params = init_params(torch.Generator(device=dev).manual_seed(0), api.decls(cfg),
                                 torch.float32, dev)
            data = batch_to_device(SyntheticLM(cfg, batch, seq, seed=0)(0), cfg, dev)
            start = float(api.loss(params, data, cfg)[0])
        del params, data
        check(abs(losses[0] - start) <= START_RTOL * abs(start),
              f"{arch}: first loss {losses[0]}, the model's own {start}")
        step_ms = statistics.median(m["step_ms"] for m in plain[1:])
        log(f"  losses {losses}, the second run's bit for bit (the first as the model computes "
            f"it apart: {start:.6f}); step {step_ms:.1f} ms (median of steps 1-2), peak "
            f"{peak_gb:.2f} GB allocated; launches {launches['ordered_rows_add']} "
            "ordered_rows_add")

        # the smoke config killed after a checkpoint and resumed
        smoke = ["--arch", arch, "--smoke", "--steps", "3", "--batch", "2", "--seq", "32",
                 "--seed", "0", "--device", device]
        with tempfile.TemporaryDirectory() as d:
            rc, _ = captured(train.main, smoke + ["--metrics", f"{d}/plain.jsonl"])
            check(rc == 0, f"{arch} smoke: launch/train returned {rc}")
            smoke_losses = [m["loss"] for m in train_losses(f"{d}/plain.jsonl")]
            killed, resumed = killed_and_resumed(train, smoke, d, f"{arch} smoke")
        check([m["step"] for m in killed] == [0, 1] and [m["step"] for m in resumed] == [1, 2],
              f"{arch} smoke: killed steps {killed}, resumed steps {resumed}")
        for m in killed + resumed:
            check(m["loss"] == smoke_losses[m["step"]], f"{arch} smoke step {m['step']}: loss "
                  f"{m['loss']} against {smoke_losses[m['step']]} uninterrupted")
        log(f"  {train.get_smoke(arch).name}: checkpoint at step 0, killed at step 2, resumed: "
            f"steps 0-2 repeat the uninterrupted losses {smoke_losses} bit for bit")
        out[arch] = {"layers": cfg.num_layers, "params": n, "batch": [batch, seq],
                     "losses": losses, "first_loss_apart": start, "step_ms": step_ms,
                     "step_ms_all": [m["step_ms"] for m in plain], "peak_gb": peak_gb,
                     "launches": launches["ordered_rows_add"], "smoke_losses": smoke_losses}
    print(json.dumps(out), flush=True)
    return 0


def zoo_training(torch) -> dict:
    """(d) ``zoo_train_main`` in a subprocess, its lines echoed."""
    import os

    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8", PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; "
                           "sys.exit(chip_smoke.zoo_train_main())"], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        log(line)
    check(proc.returncode == 0, f"the phase [11] training failed (rc {proc.returncode}):\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
    log(f"  under torch.use_deterministic_algorithms(True), CUBLAS_WORKSPACE_CONFIG=:4096:8, in "
        f"a process of its own: no op raised ({time.perf_counter() - t0:.1f} s)")
    return json.loads(lines[-1])


def zoo_card_against_cpu(torch, np, dev) -> dict:
    """(e) each smoke config's prefill logits and loss on the card against
    the CPU, float32, the same weights and SyntheticLM batch."""
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import get_api
    from repro_torch.models.params import init_params, tree_map
    from repro_torch.train.train_step import batch_to_device

    cpu = torch.device("cpu")
    out = {}
    for arch in (HYBRID_ARCH, AUDIO_ARCH, VLM_ARCH):
        cfg = get_smoke(arch)
        api = get_api(cfg)
        params = init_params(torch.Generator().manual_seed(0), api.decls(cfg), torch.float32, cpu)
        batch = SyntheticLM(cfg, 2, 32, seed=0)(0)
        runs = []
        with torch.no_grad():
            for where in (dev, cpu):
                p = tree_map(lambda a: a.to(where, copy=True), params)
                b = batch_to_device(batch, cfg, where)
                runs.append((api.prefill(p, b, cfg).cpu(), float(api.loss(p, b, cfg)[0])))
        (lg, sg), (lc, sc) = runs
        diff = (lg - lc).abs()
        worst = float((diff - ZOO_CARD_CPU_TOL * lc.abs()).max())
        check(worst <= ZOO_CARD_CPU_TOL and abs(sg - sc) <= ZOO_CARD_CPU_TOL * abs(sc),
              f"{cfg.name}: card logits off by {worst} past rtol; loss {sg} vs CPU {sc}")
        log(f"[11e] {cfg.name}, float32, card vs CPU: max|d logits| {float(diff.max()):.3g} of "
            f"max|logits| {float(lc.abs().max()):.4g}; loss {sg:.7f} / {sc:.7f} (rtol and atol "
            f"{ZOO_CARD_CPU_TOL})")
        out[cfg.name] = {"max_abs_logits_diff": float(diff.max()), "loss_card": sg,
                         "loss_cpu": sc}
    return out


def zoo_paths(torch, np, dev, kernels: list) -> None:
    """Phase [11]: the hybrid, audio and VLM families served at full width and
    depth, trained deterministically (the smoke configs also resumed), card
    against CPU, and ``ordered_rows_add`` at their embedding gradients → the
    kernel's entry."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    summary = {"hybrid": hybrid_serving(torch, dev)}
    summary["audio"] = audio_serving(torch, dev)
    summary["vlm"] = vlm_serving(torch, dev)
    gc.collect()
    torch.cuda.empty_cache()
    summary["train"] = zoo_training(torch)
    summary["card_vs_cpu"] = zoo_card_against_cpu(torch, np, dev)

    # the kernel at the three embedding gradients, the training runs' tokens
    latency = add_latency_ns(torch)
    g = torch.Generator(device=dev).manual_seed(12)
    calls = []
    for arch, (_, batch, seq) in ZOO_TRAIN.items():
        cfg = get_config(arch)
        toks = torch.from_numpy(SyntheticLM(cfg, batch, seq, seed=0)(0)["tokens"]).to(dev)
        calls.append(rows_call(
            torch, ops, f"the {arch} embedding gradient ({batch} x {toks.shape[1]} tokens)",
            torch.zeros((cfg.vocab_size, cfg.d_model), device=dev), toks.reshape(-1),
            torch.randn((toks.numel(), cfg.d_model), generator=g, device=dev), latency))
        gc.collect()
        torch.cuda.empty_cache()
    entry = next(e for e in kernels if e["name"] == "ordered_rows_add")
    by_path = {f"{a} training, 3 steps (phase [11], the first run)": r["launches"]
               for a, r in summary["train"].items()}
    entry["launches"] += sum(by_path.values())
    entry["launches_by_path"].update(by_path)
    entry["calls"] += calls
    entry["path"] += ", the training runs of phase [11]"
    summary["ordered_rows_add"] = calls
    log(f"[11] {time.perf_counter() - t0:.1f} s; " + json.dumps(summary, default=str))


# ---------------------------------------------------------------------------
# [12] sharding: the mesh entry points, and elastic restore across worlds
# ---------------------------------------------------------------------------

MESH_TRAIN_STEPS = 2
ELASTIC_ARCH, ELASTIC_BATCH, ELASTIC_SEQ = "qwen3-1.7b", 4, 64
ELASTIC_MESHES = ((1, 2), (2, 1))
ELASTIC_LOSS_RTOL = 1e-5  # float32 smoke: the card's and the CPU's sums in other orders
ELASTIC_TIMEOUT_S = 240

ELASTIC_RANK = r"""
import json, sys, time
import numpy as np, torch
torch.set_num_threads(2)
import torch.distributed as dist
rank, tmp, ckpt, arch, batch, seq = sys.argv[1:7]
rank, batch, seq = int(rank), int(batch), int(seq)
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=2, rank=rank)
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.checkpoint.elastic import elastic_restore
from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import get_api
from repro_torch.models.params import (init_params, shard_params, tree_leaves, tree_map,
                                       validated_pspec_tree)
from repro_torch.sharding import use_mesh
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import batch_to_device, init_train_state, make_train_step

cfg = get_smoke(arch)
api = get_api(cfg)
opt = AdamW()  # launch/train's
with np.load(f"{ckpt}/ckpt_00000001/arrays.npz") as data:
    saved = [data[k] for k in sorted(data.files)]
out = {}
for shape in [tuple(s) for s in json.loads(sys.argv[7])]:
    mesh = DeviceMesh("cpu", torch.arange(2).reshape(shape), mesh_dim_names=("data", "model"))
    with use_mesh(mesh):
        params = init_params(torch.Generator().manual_seed(1), api.decls(cfg), torch.float32,
                             "cpu")
        params = shard_params(params, mesh, validated_pspec_tree(api.decls(cfg), mesh))
        target = {"params": params, "state": init_train_state(cfg, opt, params)}
        dist.barrier()
        t0 = time.perf_counter()
        tree, manifest = elastic_restore(Checkpointer(ckpt), cfg, mesh, target)
        restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        whole = [(t.full_tensor() if isinstance(t, DTensor) else t).numpy().copy()
                 for t in tree_leaves(tree)]
        gather_s = time.perf_counter() - t0
        same = len(whole) == len(saved) and all(
            a.dtype == b.dtype and np.array_equal(a, b) for a, b in zip(whole, saved))
        sharded = sum(isinstance(t, DTensor) and any(p.is_shard() for p in t.placements)
                      for t in tree_leaves(tree["params"]))
        t0 = time.perf_counter()
        Checkpointer(f"{tmp}/resaved{shape[0]}x{shape[1]}").save(manifest["step"], tree)
        save_s = time.perf_counter() - t0
        step = manifest["step"] + 1
        b = batch_to_device(SyntheticLM(cfg, batch, seq, seed=0)(step), cfg, "cpu")
        _, _, m = make_train_step(cfg, opt)(tree["params"], tree["state"], b)
        out["%dx%d" % shape] = {"bits_equal": same, "step": step, "loss": float(m["loss"]),
                                "restore_s": restore_s, "gather_s": gather_s,
                                "save_s": save_s, "sharded_leaves": sharded}
if rank == 0:
    print(json.dumps(out), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def mesh_entry_points(torch, dev, dense: dict) -> dict:
    """[12a] ``launch/train --mesh 1x1`` (MESH_TRAIN_STEPS steps at TRAIN_BATCH x
    TRAIN_SEQ) and ``launch/serve --mesh 1x1`` (DENSE_BATCH x (DENSE_PROMPT +
    DENSE_NEW) greedy), ``qwen3-1.7b`` at full width and depth: the plain
    path, so the losses and every request's ids equal phase [9]'s bit for
    bit."""
    import tempfile

    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train

    log(f"[12a] {DENSE_ARCH} through launch/train and launch/serve with --mesh 1x1")
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        rc, _ = captured(train.main, ["--arch", DENSE_ARCH, "--steps", str(MESH_TRAIN_STEPS),
                                      "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                                      "--seed", "0", "--device", str(dev), "--mesh", "1x1",
                                      "--metrics", f"{d}/m.jsonl"])
        launches = ops.launch_counts()
        check(rc == 0, f"launch/train --mesh 1x1 returned {rc}")
        with open(f"{d}/m.jsonl") as f:
            steps = [json.loads(line) for line in f]
    train_peak = torch.cuda.max_memory_allocated() / 1e9
    losses = [m["loss"] for m in steps]
    check(losses == dense["train"]["losses"][:MESH_TRAIN_STEPS],
          f"--mesh 1x1 losses {losses} against phase [9]'s {dense['train']['losses']}")
    gc.collect()
    torch.cuda.empty_cache()

    generated = []
    inner = serve.generate

    def recording(*args, **kwargs):  # the CLI prints request 0 only: keep all four
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        torch.cuda.synchronize()
        generated.append((out, time.perf_counter() - t0))
        return out

    serve.generate = recording
    try:
        ops.reset_launch_counts()
        rc, _ = captured(serve.main, ["--arch", DENSE_ARCH, "--batch", str(DENSE_BATCH),
                                      "--prompt-len", str(DENSE_PROMPT), "--new", str(DENSE_NEW),
                                      "--temperature", "0", "--seed", "0", "--device", str(dev),
                                      "--mesh", "1x1"])
        serve_launches = ops.launch_counts()
    finally:
        serve.generate = inner
    check(rc == 0 and len(generated) == 1, f"launch/serve --mesh 1x1 returned {rc}")
    out, gen_s = generated[0]
    ids = out[:, DENSE_PROMPT:].tolist()
    check(ids == dense["serve"]["ids"], f"--mesh 1x1 ids {ids} against phase [9]'s")
    step_ms = steps[-1]["step_ms"]
    log(f"  losses {losses} = phase [9]'s first {MESH_TRAIN_STEPS} bit for bit; step "
        f"{[round(m['step_ms'], 1) for m in steps]} ms (the last {step_ms:.1f} ms; phase [9]'s "
        f"median {dense['train']['step_ms']:.1f} ms), peak {train_peak:.2f} GB; generate "
        f"{gen_s * 1e3:.1f} ms for {DENSE_BATCH} x ({DENSE_PROMPT} + {DENSE_NEW}) "
        f"({gen_s * 1e3 / DENSE_NEW:.2f} ms a new token, the prefill included); every "
        f"request's ids = phase [9]'s")
    return {"losses": losses, "step_ms": [m["step_ms"] for m in steps], "peak_gb": train_peak,
            "generate_ms": gen_s * 1e3, "ms_per_new_token": gen_s * 1e3 / DENSE_NEW,
            "launches": launches, "serve_launches": serve_launches}


def elastic_across_worlds(torch, np, dev) -> dict:
    """[12b] the ``ELASTIC_ARCH`` smoke train state saved on the card after
    step 1 (``launch/train --ckpt-every 1``), restored by ``elastic_restore``
    onto a 2-rank gloo world on the CPU (spawned here) as 1×2 and 2×1: every
    restored parameter and moment equals the checkpoint bit for bit, and the
    next step's loss is the one-rank card run's (rtol ELASTIC_LOSS_RTOL).
    Walls: the card's save and restore of the state, and in the world the
    restore, the gather of the sharded tree and a sharded save."""
    import os
    import tempfile

    from repro_torch.checkpoint.checkpoint import Checkpointer
    from repro_torch.kernels import ops
    from repro_torch.launch import train

    log(f"[12b] the {ELASTIC_ARCH} smoke train state: saved on the card after step 1, "
        f"restored onto a 2-rank gloo world on the CPU as "
        f"{', '.join('%dx%d' % m for m in ELASTIC_MESHES)}")
    base = ["--arch", ELASTIC_ARCH, "--smoke", "--batch", str(ELASTIC_BATCH), "--seq",
            str(ELASTIC_SEQ), "--seed", "0", "--device", str(dev)]
    with tempfile.TemporaryDirectory() as d:
        ops.reset_launch_counts()
        rc, _ = captured(train.main, base + ["--steps", "3", "--metrics", f"{d}/three.jsonl"])
        check(rc == 0, f"the card's 3-step run returned {rc}")
        rc, _ = captured(train.main, base + ["--steps", "2", "--ckpt-dir", f"{d}/ck",
                                             "--ckpt-every", "1", "--metrics", f"{d}/two.jsonl"])
        check(rc == 0, f"the card's checkpointed run returned {rc}")
        launches = ops.launch_counts()
        card = [json.loads(line)["loss"] for line in open(f"{d}/three.jsonl")]
        saved_run = [json.loads(line)["loss"] for line in open(f"{d}/two.jsonl")]
        check(saved_run == card[:2], f"the checkpointed run's losses {saved_run} vs {card}")

        # the card's own walls: the saved state restored onto the card, saved again
        ck = Checkpointer(f"{d}/ck")
        with np.load(f"{d}/ck/ckpt_00000001/arrays.npz") as data:
            target = {k: torch.zeros(data[k].shape, dtype=torch.float32 if data[k].dtype.kind ==
                                     "f" else torch.int32, device=dev) for k in data.files}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        flat, _ = ck.restore(1, target)
        torch.cuda.synchronize()
        card_restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        Checkpointer(f"{d}/again").save(1, flat, block=True)
        card_save_s = time.perf_counter() - t0
        state_mb = sum(t.numel() * t.element_size() for t in flat.values()) / 1e6

        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS="2")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, "-c", ELASTIC_RANK, str(r), d, f"{d}/ck", ELASTIC_ARCH,
             str(ELASTIC_BATCH), str(ELASTIC_SEQ), json.dumps(ELASTIC_MESHES)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(2)]
        try:
            outs = [p.communicate(timeout=ELASTIC_TIMEOUT_S) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        world_s = time.perf_counter() - t0
        for r, (p, (_, err)) in enumerate(zip(procs, outs)):
            check(p.returncode == 0, f"elastic rank {r} exited {p.returncode}:\n{err[-3000:]}")
        worlds = json.loads(outs[0][0].strip().splitlines()[-1])
    for shape, w in worlds.items():
        check(w["bits_equal"], f"{shape}: the restored state differs from the checkpoint")
        check(w["sharded_leaves"] > 0 or shape == "2x1",
              f"{shape}: no parameter was sharded")
        check(w["step"] == 2 and abs(w["loss"] - card[2]) <= ELASTIC_LOSS_RTOL * abs(card[2]),
              f"{shape}: step {w['step']} loss {w['loss']} against the card's {card[2]}")
        log(f"  {shape}: every leaf bit for bit ({w['sharded_leaves']} parameters sharded); "
            f"step 2 loss {w['loss']:.7f} (card {card[2]:.7f}, rel "
            f"{abs(w['loss'] - card[2]) / abs(card[2]):.2e}); restore {w['restore_s'] * 1e3:.1f} "
            f"ms, gather {w['gather_s'] * 1e3:.1f} ms, sharded save {w['save_s'] * 1e3:.1f} ms")
    log(f"  card: losses {card}; the {state_mb:.2f} MB state restored onto the card in "
        f"{card_restore_s * 1e3:.1f} ms, saved in {card_save_s * 1e3:.1f} ms; the CPU world "
        f"took {world_s:.1f} s, its start included")
    return {"card_losses": card, "state_mb": state_mb, "card_restore_ms": card_restore_s * 1e3,
            "card_save_ms": card_save_s * 1e3, "world_s": world_s, "worlds": worlds,
            "launches": launches}


def sharding_paths(torch, np, dev, kernels: list, dense: dict) -> None:
    """Phase [12]: the mesh entry points on one rank, bit for bit with phase
    [9], and elastic restore from the card onto a 2-rank CPU world.  A
    multi-rank world on the one card has no phase: NCCL refuses two ranks on
    one device, and on gloo with CUDA tensors a DTensor redistribution
    crashes both ranks (SIGSEGV) and a send/recv aborts one
    (``tools/gloo_cuda_probe.py``)."""
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    summary = {"mesh_1x1": mesh_entry_points(torch, dev, dense)}
    gc.collect()
    torch.cuda.empty_cache()
    summary["elastic"] = elastic_across_worlds(torch, np, dev)
    entry = next(e for e in kernels if e["name"] == "ordered_rows_add")
    by_path = {
        f"{DENSE_ARCH} launch/train --mesh 1x1, {MESH_TRAIN_STEPS} steps (phase [12a])":
        summary["mesh_1x1"]["launches"]["ordered_rows_add"],
        f"{DENSE_ARCH} launch/serve --mesh 1x1 (phase [12a])":
        summary["mesh_1x1"]["serve_launches"]["ordered_rows_add"],
        f"{ELASTIC_ARCH} smoke training, 3 + 2 steps (phase [12b])":
        summary["elastic"]["launches"]["ordered_rows_add"]}
    entry["launches"] += sum(by_path.values())
    entry["launches_by_path"].update(by_path)
    entry["path"] += ", the mesh entry points and elastic runs of phase [12]"
    log(f"[12] {time.perf_counter() - t0:.1f} s; " + json.dumps(summary, default=str))


# ---------------------------------------------------------------------------
# [13] the dry run and roofline
# ---------------------------------------------------------------------------

ROOFLINE_TIMEOUT_S = 600
DRYRUN_CELLS = ("decode_32k", "train_4k")  # qwen3-1.7b at 16x16, [13b]


def roofline_main(measured: str, device: str = "cuda") -> int:
    """[13a] phase [9]'s own programs counted on a 1x1 ``cuda`` mesh (a fake
    world of one rank): the ``DENSE_ARCH`` train step at TRAIN_BATCH x
    TRAIN_SEQ (float32 weights and AdamW state, the config as phase [9] runs
    it) and its serve decode step (DENSE_BATCH rows, a cache of DENSE_PROMPT
    + DENSE_NEW positions), each as a roofline with the H100's float32
    peak beside phase [9]'s measurements (``measured``, JSON); then the same
    count over one real train step on the card, which must equal the fake
    one.  Run in a process of its own; prints one JSON line last.
    ``device="cpu"`` rehearses it on the CPU."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import dryrun
    from repro_torch.models import get_api
    from repro_torch.models.params import count_params, init_params, tree_bytes
    from repro_torch.roofline import analysis as ra
    from repro_torch.roofline.count import count_step
    from repro_torch.sharding import use_mesh
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import batch_to_device, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False  # phase [9]'s float32 products
    torch.backends.cudnn.allow_tf32 = False
    got = json.loads(measured)
    dryrun.fake_world(1)
    mesh = DeviceMesh(device, torch.zeros((1, 1), dtype=torch.int64),
                      mesh_dim_names=("data", "model"))
    rules = {"batch": ("data",), "groups": ("data",)}
    cfg = get_config(DENSE_ARCH)
    api = get_api(cfg)
    n = count_params(api.decls(cfg))
    cells = {"train": ShapeSpec("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
             "decode": ShapeSpec("decode", DENSE_PROMPT + DENSE_NEW, DENSE_BATCH, "decode")}
    out = {}
    for name, shape in cells.items():
        count, t_build, t_step = dryrun.count_cell(cfg, shape, mesh, rules,
                                                   param_dtype=torch.float32)
        roof = ra.analyze(DENSE_ARCH, name, "1x1", 1, count.flops, count.bytes,
                          count.stats.wire_bytes, ra.model_flops_estimate(cfg, shape, n, n),
                          dtype="float32")
        out[name] = {"roofline": roof.row(), "totals": count.totals(),
                     "argument_bytes": count.argument_bytes, "peak_bytes": count.peak_bytes,
                     "build_s": t_build, "count_s": t_step}
    t_c, t_m = out["train"]["roofline"]["t_compute"], out["train"]["roofline"]["t_memory"]

    # one real step on the card, counted by the same mode
    dev = torch.device(device)
    params = init_params(torch.Generator(device=dev).manual_seed(0), api.decls(cfg),
                         torch.float32, dev)
    opt = AdamW()
    state = {"opt": opt.init(params)}
    live_bytes = tree_bytes(params) + tree_bytes(state)
    batch = batch_to_device(SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0)(0), cfg, dev)
    step = make_train_step(cfg, opt)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    with use_mesh(mesh, rules):
        (_, _, metrics), real = count_step(step, {"params": params, "opt_state": state,
                                                  "batch": batch}, mesh)
    sync()
    out["train"]["real_step"] = {"totals": real.totals(), "s": time.perf_counter() - t0,
                                 "loss": float(metrics["loss"]),
                                 "argument_bytes": real.argument_bytes}
    out["train"]["live_state_bytes"] = live_bytes
    print(json.dumps(out), flush=True)
    fake = out["train"]
    ok = (got["step_ms"] * 1e-3 >= max(t_c, t_m)
          and fake["argument_bytes"]["params"] + fake["argument_bytes"]["opt_state"] == live_bytes
          and real.totals() == fake["totals"] and np.isfinite(float(metrics["loss"])))
    return 0 if ok else 1


def dryrun_cells() -> dict:
    """[13b] ``python -m repro_torch.launch.dryrun --arch DENSE_ARCH --shape
    <cell>`` for each of DRYRUN_CELLS: the 16x16 production mesh of a fake
    256-rank world on the ``cuda`` device type, each cell's record read
    back."""
    import os

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = {}
    for shape in DRYRUN_CELLS:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                               DENSE_ARCH, "--shape", shape], cwd=ROOT, env=env,
                              capture_output=True, text=True, timeout=ROOFLINE_TIMEOUT_S)
        wall = time.perf_counter() - t0
        lines = [x for x in proc.stdout.splitlines() if x.startswith(("[OK]", "[FAIL]", "dry-run"))]
        for line in lines:
            log(f"  | {line}")
        check(proc.returncode == 0, f"the dry run of {shape} failed (rc {proc.returncode}):\n"
              f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        with open(ROOT / "experiments" / "dryrun_torch" / f"{DENSE_ARCH}__{shape}__16x16.json") as f:
            rec = json.load(f)
        check(rec["status"] == "ok" and rec["mesh"] == "16x16" and rec["chips"] == 256,
              f"{shape}: {rec}")
        r = rec["roofline"]
        log(f"  {DENSE_ARCH} {shape} at 16x16 (bf16 peak): t_compute {r['t_compute'] * 1e3:.3f} "
            f"ms, t_memory {r['t_memory'] * 1e3:.3f} ms, t_collective {r['t_collective'] * 1e3:.3f}"
            f" ms -> {r['bottleneck']}; MODEL/count flops {r['useful_ratio']:.3f}; collectives "
            f"{rec['collectives']['count_by_kind']} ({r['coll_bytes_per_chip'] / 1e9:.3f} GB a "
            f"chip on the wire); args {rec['memory_analysis']['argument_size_in_bytes'] / 1e9:.2f}"
            f" GB + temps {rec['memory_analysis']['temp_size_in_bytes'] / 1e9:.2f} GB a chip; "
            f"build {rec['lower_s']} s, counted step {rec['compile_s']} s, {wall:.1f} s in all")
        out[shape] = {"roofline": r, "collectives": rec["collectives"],
                      "memory_analysis": rec["memory_analysis"], "wall_s": wall}
    return out


def roofline_paths(torch, dense: dict) -> None:
    """Phase [13]: [13a] in a process of its own (its fake world cannot meet
    phase [12]'s), then [13b].  Fake tensors launch no kernel."""
    import os

    t0 = time.perf_counter()
    measured = {"step_ms": dense["train"]["step_ms"], "peak_gb": dense["train"]["peak_gb"],
                "decode_device_ms": dense["serve"]["decode_device_ms_per_step"],
                "decode_peak_gb": dense["serve"]["peak_gb"]}
    log(f"[13a] {DENSE_ARCH}: phase [9]'s train step ({TRAIN_BATCH} x {TRAIN_SEQ}, float32 "
        f"weights and AdamW) and serve decode step ({DENSE_BATCH} rows, a cache of "
        f"{DENSE_PROMPT + DENSE_NEW}) counted on a 1x1 cuda mesh of fake tensors, then one real "
        f"train step counted on the card")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", "import sys, chip_smoke; "
                           f"sys.exit(chip_smoke.roofline_main({json.dumps(json.dumps(measured))}))"],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=ROOFLINE_TIMEOUT_S)
    lines = proc.stdout.strip().splitlines()
    check(bool(lines) and lines[-1].startswith("{"),
          f"[13a] printed no result (rc {proc.returncode}):\n{proc.stdout[-3000:]}\n"
          f"{proc.stderr[-6000:]}")
    res = json.loads(lines[-1])
    train, decode = res["train"], res["decode"]
    tr, de = train["roofline"], decode["roofline"]
    bound_ms = max(tr["t_compute"], tr["t_memory"]) * 1e3
    counted_args = train["argument_bytes"]["params"] + train["argument_bytes"]["opt_state"]
    log(f"  train: {train['totals']['flops']:.6g} flops ({tr['t_compute'] * 1e3:.2f} ms at 67 "
        f"TFLOP/s float32), {train['totals']['bytes']:.6g} bytes ({tr['t_memory'] * 1e3:.2f} ms "
        f"at 3.35 TB/s), {train['totals']['ops']} ops, no collective -> {tr['bottleneck']}; "
        f"phase [9]'s median step {measured['step_ms']:.1f} ms ({measured['step_ms'] / bound_ms:.2f}"
        f" x the bound); counted peak {train['peak_bytes'] / 1e9:.2f} GB against phase [9]'s "
        f"max_memory_allocated {measured['peak_gb']:.2f} GB; arguments {train['argument_bytes']} "
        f"(parameters and AdamW state {counted_args} B, the live state's "
        f"{train['live_state_bytes']} B); counted in {train['count_s']:.1f} s")
    log(f"  the real step on the card (loss {train['real_step']['loss']:.6f}, "
        f"{train['real_step']['s']:.2f} s under the count): {train['real_step']['totals']}")
    log(f"  decode: {decode['totals']['flops']:.6g} flops ({de['t_compute'] * 1e3:.4f} ms), "
        f"{decode['totals']['bytes']:.6g} bytes ({de['t_memory'] * 1e3:.4f} ms) -> "
        f"{de['bottleneck']}; phase [9]'s step on the card {measured['decode_device_ms']:.2f} ms "
        f"(not held to the bound: L2 serves re-read operands); counted peak "
        f"{decode['peak_bytes'] / 1e9:.2f} GB against {measured['decode_peak_gb']:.2f} GB")
    check(measured["step_ms"] >= bound_ms,
          f"the train step ({measured['step_ms']} ms) beat its counted bound ({bound_ms} ms)")
    check(counted_args == train["live_state_bytes"],
          f"counted argument bytes {counted_args} against the live state's "
          f"{train['live_state_bytes']}")
    check(train["real_step"]["totals"] == train["totals"],
          f"the real step's count {train['real_step']['totals']} against the fake one's "
          f"{train['totals']}")
    check(proc.returncode == 0, f"[13a] returned {proc.returncode}:\n{proc.stderr[-3000:]}")
    log("[13b] the dry run at 16x16 on a fake 256-rank world, the cuda device type")
    cells = dryrun_cells()
    log(f"[13] {time.perf_counter() - t0:.1f} s; " + json.dumps(
        {"13a": res, "13b": cells}, default=str))


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
    gc.collect()
    torch.cuda.empty_cache()
    fused_paths(torch, np, dev, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    service_path(torch, np, dev, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    scenario_paths(torch, np, dev, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    dense = dense_paths(torch, np, dev, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    moe_paths(torch, np, dev, kernels, dense["train"]["launches"])
    gc.collect()
    torch.cuda.empty_cache()
    zoo_paths(torch, np, dev, kernels)
    gc.collect()
    torch.cuda.empty_cache()
    sharding_paths(torch, np, dev, kernels, dense)
    gc.collect()
    torch.cuda.empty_cache()
    roofline_paths(torch, dense)
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
