#!/usr/bin/env python3
"""Where the two z-mode kernels spend their time, on one NVIDIA GPU.

    python3 tools/z_split.py [--parent DIR]

Builds cut copies of ``csrc/sparse_bid_eval.cu`` (``sparse_bid_eval_z``) and
``csrc/sparse_bid_eval_csr.cu`` (``sparse_bid_eval_csr_z``) with ``nvcc``
(the port's flags, one process each, in parallel), each stopping after one
step of the kernel:

    launch   no zeroing of z, the kernel returns at once
    stage    no zeroing, returns after the staging wait and barrier
    select   no zeroing, returns after the selection (chosen written)
    scatter  no zeroing, returns before the flush to z
    kernel   no zeroing of z, the whole kernel
    full     the entry point as built: the zero kernel, then the whole kernel
    memset   the whole kernel after cudaMemsetAsync in place of the zero kernel

and times each with ``chip_smoke.graph_ms`` (a CUDA graph of 20 calls,
median of 20 replays) at the planet books (U = 101,000, B = 3, R = 1,000,
scalar pi; padded K = 2 and CSR), the economy book in z mode (U = 64,691,
B = 8, K = 3, R = 24, vector pi), the synthetic 100k x 4 x 8 book and the
skewed CSR book.  Successive differences are the steps' shares.  Then it
times the whole kernel with span plans of at most 256, 384, 512, 768 and
1,024 users (``ops.z_plan`` / ``ops.csr_z_plan`` with ``max_span``) and,
where the plan sums z in one tile a warp (R <= 128), with one shared tile
and shared atomics instead (``one_tile``).  With ``--parent
DIR`` (an unpacked tree of an earlier commit whose z entry points take no
plan) it also times that tree's two z kernels in the same process.  The
full variants are held against the plain versions first.  Prints one JSON
line of all times (ms) after the card's ``name, power.limit``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402

CUTS = {  # variant -> the step before which the kernel returns (None: it runs whole)
    "launch": 1, "stage": 2, "select": 3, "scatter": 4, "kernel": None, "full": None,
    "memset": None,
}
MARKERS = {
    "sparse_bid_eval": {1: "  // 1. stage the span's idx", 2: "  // 2. select: one thread a user",
                        3: "  // 3. scatter the chosen terms", 4: "  // 4. flush: one global"},
    "sparse_bid_eval_csr": {1: "  // 1. stage the span's offsets",
                            2: "  // 2. select: one thread a user",
                            3: "  // 3. scatter the chosen segments",
                            4: "  // 4. flush: one global"},
}
ZERO = "zero_kernel<<<min((R + kZThreads - 1) / kZThreads, 1024), kZThreads, 0, stream>>>(z, R);"
SPANS = (256, 384, 512, 768, 1_024)


def cut_source(name: str, variant: str) -> str:
    src = (ROOT / "src/repro_torch/kernels/csrc" / f"{name}.cu").read_text()
    if src.count(ZERO) != 1:
        raise RuntimeError(f"{name}.cu: the zero kernel is not where this script expects it")
    if variant == "memset":
        src = src.replace(ZERO, "cudaMemsetAsync(z, 0, sizeof(float) * R, stream);")
    elif variant != "full":
        src = src.replace(ZERO, ";")
    step = CUTS[variant]
    if step is not None:
        marker = MARKERS[name][step]
        if src.count(marker) != 1:
            raise RuntimeError(f"{name}.cu: marker {marker!r} found {src.count(marker)} times")
        src = src.replace(marker, "  return;\n" + marker)
    return src


def build(jobs: dict) -> dict:
    """jobs: key -> source path; one nvcc each, in parallel → key -> CDLL."""
    from repro_torch.kernels import build as kbuild

    out = ROOT / "build" / "z_split"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for key, src in jobs.items():
        lib = out / f"lib_{key}.so"
        cmd = [kbuild._nvcc(), *kbuild.NVCC_FLAGS, "-o", str(lib), str(src)]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib)
    logs = {key: proc.communicate()[0] for key, (proc, _) in procs.items()}
    for key, (proc, _) in procs.items():
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{logs[key]}")
    return {key: ctypes.CDLL(str(lib)) for key, (_, lib) in procs.items()}


def padded_call(torch, ops, fn, book, r, plan):
    """A closure launching a padded-book z entry point; plan None: the
    earlier signature, without a plan."""
    idx, val, mask, pi, prices = book
    u, b, k = idx.shape
    chosen = torch.empty(u, dtype=torch.int32, device=idx.device)
    z = torch.zeros(r, dtype=torch.float32, device=idx.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.restype = I
    head = [idx.data_ptr(), val.data_ptr(), mask.data_ptr(), pi.data_ptr(), int(pi.ndim == 2),
            prices.data_ptr(), u, b, k, r]
    if plan is None:
        fn.argtypes = (P, P, P, P, I, P, I, I, I, I, P, P, P)
        args = head
    else:
        fn.argtypes = (P, P, P, P, I, P, I, I, I, I, P, I, P, P, P)
        arr = ops._plan_ints(plan)
        args = head + [arr, len(arr)]

    def call():
        if plan is None:
            z.zero_()  # the earlier wrapper's torch.zeros
        err = fn(*args, chosen.data_ptr(), z.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cudaError {err}")
        return z, chosen
    return call


def csr_call(torch, ops, fn, cargs, r, k_bound, plan):
    idx, val, offsets, mask, pi, prices = cargs
    u, b = mask.shape
    chosen = torch.empty(u, dtype=torch.int32, device=idx.device)
    z = torch.zeros(r, dtype=torch.float32, device=idx.device)
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.restype = I
    head = [idx.data_ptr(), val.data_ptr(), offsets.data_ptr(), mask.data_ptr(), pi.data_ptr(),
            int(pi.ndim == 2), prices.data_ptr(), u, b, k_bound, r]
    if plan is None:
        fn.argtypes = (P, P, P, P, P, I, P, I, I, I, I, P, P, P)
        args = head
    else:
        fn.argtypes = (P, P, P, P, P, I, P, I, I, I, I, P, I, P, P, P)
        arr = ops._plan_ints(plan)
        args = head + [arr, len(arr)]

    def call():
        if plan is None:
            z.zero_()
        err = fn(*args, chosen.data_ptr(), z.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cudaError {err}")
        return z, chosen
    return call


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, default=None,
                        help="an unpacked earlier tree whose z kernels to time beside these")
    opts = parser.parse_args()
    if not torch.cuda.is_available():
        print("z_split: no CUDA device is visible", file=sys.stderr)
        return 2
    from repro_torch import core as pt
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda")
    scratch = ROOT / "build" / "z_split" / "src"
    scratch.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in MARKERS:
        for variant in CUTS:
            path = scratch / f"{name}_{variant}.cu"
            path.write_text(cut_source(name, variant))
            jobs[f"{name}_{variant}"] = path
        if opts.parent is not None:
            jobs[f"{name}_parent"] = opts.parent / "src/repro_torch/kernels/csrc" / f"{name}.cu"
    libs = build(jobs)

    planet = pt.random_market(100_000, 1_000, seed=0, device=dev)
    planet_csr = pt.csr_from_padded(planet)
    p0 = torch.full((1_000,), 0.1, device=dev)
    probe = pt.fleet_economy(100_000, 8, seed=0, device=dev)
    eco = probe.pack_bid_book().problem
    eco_idx, eco_val = pt.csr_padded_views(eco)
    eco_prices = torch.from_numpy(
        np.asarray(pt.reserve_prices(probe.pools(), probe.weighting), np.float32)).to(dev)
    padded_books = {
        "planet": ((planet.idx, planet.val, planet.bundle_mask, planet.pi, p0), 1_000),
        "economy": ((eco_idx, eco_val, eco.bundle_mask, eco.pi, eco_prices), eco.num_resources),
        "synthetic 100000x4x8 scalar": (chip_smoke.synthetic_book(
            torch, np, dev, 100_000, 4, 8, 1_000, False, seed=1), 1_000),
    }
    skew, skew_prices = chip_smoke.skewed_csr_book(torch, np, pt, dev, 100_000, 4, 1_000, False,
                                                   seed=2)
    csr_books = {
        "planet": ((planet_csr.idx, planet_csr.val, planet_csr.offsets, planet_csr.bundle_mask,
                    planet_csr.pi, p0), 1_000, planet_csr.k_bound),
        "skewed K 1..16 scalar": ((skew.idx, skew.val, skew.offsets, skew.bundle_mask, skew.pi,
                                   skew_prices), 1_000, skew.k_bound),
    }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    result = {"device": smi, "padded": {}, "csr": {}}
    for label, (book, r) in padded_books.items():
        u, b, k = book[0].shape
        vec = book[3].ndim == 2
        plan = ops.z_plan(b, k, r, vec)
        full = padded_call(torch, ops, libs["sparse_bid_eval_full"].sparse_bid_eval_z, book, r,
                           plan)
        z, chosen = full()
        z_ref, chosen_ref = ref.sparse_bid_eval(*book, r)
        chip_smoke.check(torch.equal(chosen, chosen_ref), f"z_split {label}: chosen differs")
        times = {v: chip_smoke.graph_ms(torch, padded_call(
            torch, ops, getattr(libs[f"sparse_bid_eval_{v}"], "sparse_bid_eval_z"), book, r,
            plan)) for v in CUTS}
        times["spans"] = {s: chip_smoke.graph_ms(torch, padded_call(
            torch, ops, libs["sparse_bid_eval_full"].sparse_bid_eval_z, book, r,
            ops.z_plan(b, k, r, vec, s))) for s in SPANS}
        if plan.z_mode == 2:  # the warp tiles' region holds one tile too
            times["one_tile"] = chip_smoke.graph_ms(torch, padded_call(
                torch, ops, libs["sparse_bid_eval_full"].sparse_bid_eval_z, book, r,
                plan._replace(z_mode=1)))
        if opts.parent is not None:
            times["parent"] = chip_smoke.graph_ms(torch, padded_call(
                torch, ops, libs["sparse_bid_eval_parent"].sparse_bid_eval_z, book, r, None))
        times["bound_ms"] = chip_smoke.padded_bound(*book, out_bytes=4 * r)[0]
        times["plan"] = plan._asdict()
        result["padded"][label] = times
        print(f"sparse_bid_eval_z {label} U={u} B={b} K={k} R={r}: {json.dumps(times)}",
              flush=True)
    for label, (cargs, r, k_bound) in csr_books.items():
        u, b = cargs[3].shape
        vec = cargs[4].ndim == 2
        plan = ops.csr_z_plan(u, b, cargs[0].numel(), r, vec)
        full = csr_call(torch, ops, libs["sparse_bid_eval_csr_full"].sparse_bid_eval_csr_z,
                        cargs, r, k_bound, plan)
        z, chosen = full()
        z_ref, chosen_ref = ref.sparse_bid_eval_csr(*cargs, r, k_bound)
        chip_smoke.check(torch.equal(chosen, chosen_ref), f"z_split csr {label}: chosen differs")
        times = {v: chip_smoke.graph_ms(torch, csr_call(
            torch, ops, libs[f"sparse_bid_eval_csr_{v}"].sparse_bid_eval_csr_z, cargs, r,
            k_bound, plan)) for v in CUTS}
        times["spans"] = {s: chip_smoke.graph_ms(torch, csr_call(
            torch, ops, libs["sparse_bid_eval_csr_full"].sparse_bid_eval_csr_z, cargs, r,
            k_bound, ops.csr_z_plan(u, b, cargs[0].numel(), r, vec, s))) for s in SPANS}
        if opts.parent is not None:
            times["parent"] = chip_smoke.graph_ms(torch, csr_call(
                torch, ops, libs["sparse_bid_eval_csr_parent"].sparse_bid_eval_csr_z, cargs, r,
                k_bound, None))
        times["bound_ms"] = chip_smoke.csr_bound(*cargs, r)[0]
        times["plan"] = plan._asdict()
        result["csr"][label] = times
        print(f"sparse_bid_eval_csr_z {label} U={u} B={b} nnz={cargs[0].numel()} R={r}: "
              f"{json.dumps(times)}", flush=True)
    print(smi)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
