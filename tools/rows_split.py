#!/usr/bin/env python3
"""Where ``ordered_rows_add`` spends its time at the model paths' shapes, on
one NVIDIA GPU.

    python3 tools/rows_split.py [--parent DIR] [--cuts]

Builds three calls from seeds, shaped as the paths make them: the MoE
combine of ``deepseek-v3-671b`` (its router, top-k and capacity slots,
``models.moe.route``, on random bf16 activations and a random router) at a
prefill of 4 x 128 tokens and at a decode step of 4 tokens, and the
``qwen3-1.7b`` embedding gradient (``SyntheticLM`` tokens of a 4 x 512
batch, float32 rows).  For each it holds the wrapper against its plain
version bit for bit and times it with ``chip_smoke.graph_ms`` (a CUDA graph
of 20 calls, median of 20 replays): the whole call, the partition and the
fold apart, and ``index_add_`` of the kept rows; and lists the kernels one
call launches (``torch.profiler``, CUDA activity).  A tree whose wrapper
sorts with ``torch.sort`` (no ``ops.rows_plan``) is split here as that
wrapper runs: ``where``, the cast, the stable sort and, in target mode,
``arange`` and ``searchsorted``, against the fold's one launch on their
results.  A tree with ``ops.rows_plan`` is split by that tree's
``chip_smoke.rows_call``.  With ``--parent DIR`` (an unpacked tree of an
earlier commit, under a directory ``.gitignore`` lists) each tree runs in
its own process, in the order parent, change, change, parent.  Prints the
card's ``name, power.limit`` and one JSON line of every run.

With ``--cuts`` it times instead, at the same three calls, copies of
``csrc/ordered_rows.cu`` built with ``nvcc`` (the port's flags, one process
each, in parallel): the smem route's partition (``ordered_rows_partition``)
in copies that return before one of its numbered steps (``cut launch``:
before 1, the keys' load; ``cut load``: before 2, the first pass's count;
``cut count``: before 3; ``cut scan``: before 4, the placement; ``cut
passes``: before 5, the runs; ``cut full``: the whole partition), whose
successive differences are the steps' shares; and the fold
(``ordered_rows_fold``; the scan route's one kernel) in whole copies with
one constant or line changed (``VARIANTS``), and the whole call
(``ordered_rows_add``), each held to the plain version; the variants that
change the partition time it too.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def combine_call(torch, cfg, tokens: int, seed: int):
    """(out, index, source) of the MoE combine at ``tokens`` tokens, as
    ``models.moe.moe_block`` calls ``ordered_rows_add``."""
    from repro_torch.models.moe import capacity, route

    m, dev = cfg.moe, torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)
    G = m.groups if tokens % m.groups == 0 else 1
    Tg = tokens // G
    xt = torch.randn((G, Tg, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
    router = torch.randn((cfg.d_model, m.num_experts), generator=g, device=dev) * 0.02
    r = route(xt, router, cfg)
    base = (torch.arange(G, device=dev) * Tg)[:, None, None]
    rows = torch.where(r.buf_tok < Tg, r.buf_tok + base, G * Tg).reshape(-1)
    slots = G * m.num_experts * capacity(Tg, cfg)
    y = torch.randn((slots, cfg.d_model), generator=g, device=dev).to(torch.bfloat16)
    return torch.zeros((G * Tg, cfg.d_model), dtype=torch.bfloat16, device=dev), rows, y


def path_calls(torch) -> list:
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLM

    ds, qwen = get_config("deepseek-v3-671b"), get_config("qwen3-1.7b")
    toks = torch.from_numpy(SyntheticLM(qwen, 4, 512, seed=0)(0)["tokens"]).cuda().reshape(-1)
    g = torch.Generator(device="cuda").manual_seed(11)
    return [("the prefill's combine", *combine_call(torch, ds, 4 * 128, 1)),
            ("a decode step's combine", *combine_call(torch, ds, 4, 2)),
            ("the qwen3-1.7b embedding gradient (4 x 512 tokens)",
             torch.zeros((qwen.vocab_size, qwen.d_model), device="cuda"), toks,
             torch.randn((toks.numel(), qwen.d_model), generator=g, device="cuda"))]


def launched(torch, fn) -> list:
    """The names of the kernels one ``fn()`` launches (for a tree whose
    ``rows_call`` does not list them)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def sort_split(torch, chip_smoke, ops, out, index, source) -> dict:
    """The partition and the fold of a wrapper that sorts with torch.sort."""
    n, e = out.shape[0], index.shape[0]
    code, vec = ops._ROWS_DTYPES[out.dtype]
    align = vec * out.element_size()
    width = out[0].numel()
    if width % vec or out.data_ptr() % align or source.data_ptr() % align:
        vec = 1
    held = {}

    def partition():
        key = torch.where((index >= 0) & (index < n), index, n).to(torch.int32)
        held["keys"], held["perm"] = torch.sort(key, stable=True)
        held["starts"] = None
        if n <= e:
            held["starts"] = torch.searchsorted(held["keys"], torch.arange(
                n + 1, dtype=torch.int32, device=out.device), out_int32=True)

    partition()
    buf = out.clone()

    def fold():
        starts = held["starts"]
        ops._launch("ordered_rows", "ordered_rows_add", held["keys"].data_ptr(),
                    held["perm"].data_ptr(), None if starts is None else starts.data_ptr(),
                    source.data_ptr(), buf.data_ptr(), code, e, n, width, vec,
                    torch.cuda.current_stream().cuda_stream)

    return {"rows_route": "target" if n <= e else "head", "vec": vec,
            "partition_ms": chip_smoke.graph_ms(torch, partition),
            "fold_ms": chip_smoke.graph_ms(torch, fold)}


CUTS = {"launch": 1, "load": 2, "count": 3, "scan": 4, "passes": 5, "full": None}
# variant -> substitutions in the source; its fold (the scan route: its one
# kernel) and its whole call are timed, and its partition where it changes it
VARIANTS = {
    "as built": {},
    "kPartThreads 512": {"kPartThreads = 1024;": "kPartThreads = 512;"},
    "kPartThreads 256": {"kPartThreads = 1024;": "kPartThreads = 256;"},
    "kFoldCtas 4": {"kFoldCtas = 6;": "kFoldCtas = 4;"},
    "kAhead 8": {"kAhead = 4;": "kAhead = 8;"},
    "kAhead 8, kFoldCtas 4": {"kAhead = 4;": "kAhead = 8;", "kFoldCtas = 6;": "kFoldCtas = 4;"},
    "kAhead 2": {"kAhead = 4;": "kAhead = 2;"},
    "kScanItems 8": {"kScanItems = 4;": "kScanItems = 8;"},
    "match_any peers": {"const unsigned peers = peers_of(d, kept_row, kept);":
                        "const unsigned peers = __match_any_sync(kFull, d) & (kept_row ? kept : 0u);"},
}


def variant_libraries() -> dict:
    """Name -> (the loaded copy of ordered_rows.cu, its source): the cuts
    (``cut <step>``) and the VARIANTS."""
    from repro_torch.kernels import build, ops

    signature = ops._SIGNATURES[("ordered_rows", "ordered_rows_add")]
    src = (build.CSRC / "ordered_rows.cu").read_text()
    out = ROOT / "build" / "rows_split"
    out.mkdir(parents=True, exist_ok=True)
    texts = {}
    for name, step in CUTS.items():
        marker = f"// {step}. "
        if step is not None and src.count(marker) != 1:
            raise RuntimeError(f"ordered_rows.cu: marker {marker!r} not found once")
        texts[f"cut {name}"] = src if step is None else src.replace(marker, "return;\n  " + marker)
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs.items():
            if text.count(old) != 1:
                raise RuntimeError(f"ordered_rows.cu: {old!r} not found once")
            text = text.replace(old, new)
        texts[name] = text
    jobs = {}
    for name, text in texts.items():
        key = re.sub(r"\W+", "_", name)
        cu, lib = out / f"{key}.cu", out / f"lib_{key}.so"
        cu.write_text(text)
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        jobs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), lib)
    libs = {}
    for name, (proc, lib) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        so = ctypes.CDLL(str(lib))
        for entry in ("add", "partition", "fold"):
            f = getattr(so, f"ordered_rows_{entry}")
            f.restype = ctypes.c_int
            f.argtypes = signature
        libs[name] = (so, texts[name])
    return libs


def cuts(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    sys.path.insert(0, str(tree / "src"))
    import torch

    import chip_smoke
    from repro_torch.kernels import ops

    libs = variant_libraries()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    res = {}
    for label, out, index, source in path_calls(torch):
        dst = out.clone()  # written by every fold below: alive until the last
        plan, args, held = ops.rows_args(dst, index, source)
        times = {}
        for name, (lib, text) in libs.items():
            call_args = list(args[:-1])
            if plan.route != "scan":  # the fold's grid: this copy's CTAs an SM
                ctas = int(re.search(r"kFoldCtas = (\d+);", text).group(1))
                call_args[12] = min(min(out.shape[0], index.shape[0]) * plan.tiles, sms * ctas)
            halves = ["partition"] * (plan.route == "smem" and (name.startswith("cut")
                                                                or "kPartThreads" in name
                                                                or "match" in name))
            halves += ["fold", "add"] * (not name.startswith("cut"))
            for half in halves:
                f = getattr(lib, f"ordered_rows_{half}")

                def call(f=f):
                    err = f(*call_args, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"{half}: cudaError {err}")

                if half != "partition" and plan.route == "smem":  # a whole partition to fold
                    libs["as built"][0].ordered_rows_partition(
                        *args[:-1], torch.cuda.current_stream().cuda_stream)
                call()
                times[f"{name}: {half}"] = chip_smoke.graph_ms(torch, call)
        if plan.route == "smem":  # the as-built partition with each split of the key bits
            key_bits = (out.shape[0] - 1).bit_length()
            for passes in range(1, 5):
                bits = -(-key_bits // passes)
                if bits > ops.ROWS_DIGIT_BITS:
                    continue
                split = list(args[:-1])
                split[13], split[14] = passes, bits
                f = libs["as built"][0].ordered_rows_partition

                def part(split=split, f=f):
                    err = f(*split, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"partition: cudaError {err}")

                part()
                times[f"{passes} pass(es) of {bits} bits: partition"] = \
                    chip_smoke.graph_ms(torch, part)
        if plan.route == "smem" and out.shape[0] * plan.tiles <= 4_096:  # the scan route forced
            for name in ("as built", "kScanItems 8"):
                forced = list(args[:-1])
                forced[9], forced[12] = 0, out.shape[0] * plan.tiles  # route scan, grid n · tiles
                f = libs[name][0].ordered_rows_add

                def scan(forced=forced, f=f):
                    err = f(*forced, torch.cuda.current_stream().cuda_stream)
                    if err:
                        raise RuntimeError(f"forced scan: cudaError {err}")

                scan()
                times[f"{name}, the scan route forced: add"] = chip_smoke.graph_ms(torch, scan)
        if plan.route != "scan":  # each variant's fold once more, against the plain version
            for name in VARIANTS:
                lib = libs[name][0]
                got = out.clone()
                a = list(args[:-1])
                a[3] = got.data_ptr()
                lib.ordered_rows_add(*a, torch.cuda.current_stream().cuda_stream)
                want = ops.ordered_rows_add(out.clone(), index, source, plain=True)
                if not chip_smoke.same_bits(torch, got, want):
                    raise RuntimeError(f"{name} differs from the plain version at {label}")
        res[label] = {"plan": plan._asdict(), "ms": times}
    return res


def child(tree: Path) -> dict:
    sys.path.insert(0, str(tree))
    sys.path.insert(0, str(tree / "src"))
    import torch

    import chip_smoke
    from repro_torch.kernels import build, ops

    build.build_all()
    latency = chip_smoke.add_latency_ns(torch)
    rows = []
    for label, out, index, source in path_calls(torch):
        row = chip_smoke.rows_call(torch, ops, label, out, index, source, latency)
        if not hasattr(ops, "rows_plan"):  # the change's rows_call splits and lists itself
            row.update(sort_split(torch, chip_smoke, ops, out, index, source))
            buf = out.clone()
            row["kernels_launched"] = launched(
                torch, lambda: ops.ordered_rows_add(buf, index, source))
        rows.append(row)
    return {"tree": str(tree), "calls": rows}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="an unpacked tree of an earlier commit")
    ap.add_argument("--cuts", action="store_true", help="time cut copies of the partition")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        print(json.dumps((cuts if args.cuts else child)(args.child.resolve())), flush=True)
        return 0
    trees = [ROOT] if args.parent is None else [args.parent, ROOT, ROOT, args.parent]
    runs = []
    for tree in trees:
        proc = subprocess.run([sys.executable, __file__, "--child", str(tree)]
                              + ["--cuts"] * args.cuts,
                              capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-8000:], file=sys.stderr)
            return 1
        runs.append({"label": "parent" if tree != ROOT else "change",
                     **json.loads(proc.stdout.strip().splitlines()[-1])})
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(json.dumps({"runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
