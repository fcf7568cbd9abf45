"""Multi-pod dry run: build and count every (arch × shape × mesh) cell (the
port of ``repro.launch.dryrun``).

The reference lowers and compiles each cell for 256 or 512 fake XLA
devices.  Here rank 0 of an in-process fake ``torch.distributed`` world of
that many ranks (the ``fake`` backend: collectives return at once) builds
the production ``DeviceMesh`` (16×16, or 2×16×16 with ``--multi-pod``),
lays every input out on it as DTensors whose local shards are fake tensors
(``launch.specs``), and runs the step once under ``roofline.count``: every
op the rank runs on its shards is counted, nothing is allocated, and DTensor
must accept every layout and insert every collective on the way.  Run:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all            # 40-cell matrix
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b --device cpu

``--device`` (default ``cuda``) is the mesh's device type; ``cuda`` raises
without a visible GPU.  On a ``cpu`` mesh the fake backend runs an
all-to-all as an all-gather and a chunk, so the MoE cells count their
collectives on ``cuda``.  Records land in
``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json`` in the
reference's schema; ``lower_s`` is the time to build the cell (its
stand-ins and layouts) and ``compile_s`` the time of the counted step.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import math
import os
import time
import traceback

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config
from ..configs.shapes import SHAPES, ShapeSpec, applicable
from ..models import get_api
from ..models.params import count_params
from ..roofline import analysis as ra
from ..roofline.count import StepCount, count_step
from ..sharding import use_mesh
from ..train.optimizer import Adafactor, AdamW
from ..train.train_step import make_train_step
from . import specs as sp
from .mesh import abstract_mesh, axis_size, data_axes, make_production_mesh

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..", "experiments", "dryrun_torch")


# -- depth ---------------------------------------------------------------------
#
# Eager torch runs, and so counts, every layer: the count at the true depth
# is direct.  The per-segment slopes still come from 1-layer and 2-layer
# probes of each scanned segment, as the reference's correction has them:
# C(n) = b + Σ nᵢ·cᵢ.


def segment_counts(cfg) -> dict[str, int]:
    if cfg.family == "audio":
        return {"enc": cfg.encdec.encoder_layers, "dec": cfg.num_layers}
    if cfg.family == "hybrid":
        plen = len(cfg.griffin.pattern)
        return {"units": cfg.num_layers // plen}
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        return {
            "dense": cfg.moe.first_dense_layers,
            "moe": cfg.num_layers - cfg.moe.first_dense_layers,
        }
    return {"layers": cfg.num_layers}


def with_segments(cfg, counts: dict[str, int]):
    if cfg.family == "audio":
        return cfg.replace(
            num_layers=counts["dec"],
            encdec=dataclasses.replace(cfg.encdec, encoder_layers=counts["enc"]),
        )
    if cfg.family == "hybrid":
        plen = len(cfg.griffin.pattern)
        tail = cfg.num_layers % plen
        return cfg.replace(num_layers=counts["units"] * plen + tail)
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        return cfg.replace(
            num_layers=counts["dense"] + counts["moe"],
            moe=dataclasses.replace(cfg.moe, first_dense_layers=counts["dense"]),
        )
    return cfg.replace(num_layers=counts["layers"])


def adjust_cfg(cfg, shape: ShapeSpec, mesh):
    dp = axis_size(mesh, *data_axes(mesh))
    if cfg.moe is not None:
        tokens = shape.global_batch * (1 if shape.kind == "decode" else shape.seq_len)
        groups = dp if tokens % dp == 0 else 1
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, groups=groups))
    if shape.kind == "train":
        # full remat per block: saves only layer-boundary activations
        cfg = cfg.replace(remat="full")
    return cfg


def n_active_params(cfg, n_total: int) -> int:
    if cfg.moe is None:
        return n_total
    m = cfg.moe
    n_moe_layers = cfg.num_layers - m.first_dense_layers
    routed = n_moe_layers * 3 * cfg.d_model * m.expert_ff * m.num_experts
    return int(n_total - routed * (1.0 - m.top_k / m.num_experts))


# -- the fake world ------------------------------------------------------------


def fake_world(size: int) -> None:
    """Make this process rank 0 of a fake ``torch.distributed`` world of
    ``size`` ranks (replacing a world of another size)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == size and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", rank=0, world_size=size, store=FakeStore())


def production_mesh(multi_pod: bool, device: str):
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the dry run's mesh is on cuda by default and no GPU is visible; "
                           "pass --device cpu")
    fake_world(math.prod(abstract_mesh(multi_pod).shape))
    return make_production_mesh(multi_pod=multi_pod, device_type=device)


# -- one cell -------------------------------------------------------------------


@contextlib.contextmanager
def _no_cached_stand_ins():
    """Keep fake tensors out of the models' caches of device tensors
    (whisper's position table): emptied before the cell and after it."""
    from ..models.whisper import sinusoid_pos

    sinusoid_pos.cache_clear()
    try:
        yield
    finally:
        sinusoid_pos.cache_clear()


def count_cell(cfg, shape: ShapeSpec, mesh, rules, param_dtype=torch.bfloat16,
               trace: list | None = None) -> tuple[StepCount, float, float]:
    """Build the cell and run its step once under the count (the
    counterpart of the reference's ``_compile_cell``): ``(count, t_build,
    t_step)``.  A train cell steps AdamW (Adafactor for ``moe``)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    api = get_api(cfg)
    fake = FakeTensorMode()
    t0 = time.perf_counter()
    with use_mesh(mesh, rules), _no_cached_stand_ins():
        if shape.kind == "train":
            opt = Adafactor() if cfg.family == "moe" else AdamW()
            cell = sp.build_cell(cfg, shape, mesh, optimizer=opt, param_dtype=param_dtype,
                                 fake_mode=fake)
            fn = make_train_step(cfg, opt)
            with fake:
                args = {"params": sp.materialize(cell.params_abs, cell.params_sh, mesh),
                        "opt_state": {"opt": sp.materialize(cell.extra_abs[0], cell.extra_sh[0],
                                                            mesh)},
                        "batch": sp.materialize(cell.batch_abs, cell.batch_sh, mesh)}
        else:
            cell = sp.build_cell(cfg, shape, mesh, param_dtype=param_dtype, fake_mode=fake)
            with fake:
                args = {"params": sp.materialize(cell.params_abs, cell.params_sh, mesh),
                        "batch": sp.materialize(cell.batch_abs, cell.batch_sh, mesh)}
                if shape.kind == "decode":
                    args["cache"] = sp.materialize(cell.extra_abs[0], cell.extra_sh[0], mesh)

            @torch.no_grad()
            def fn(params, batch, cache=None):
                if cache is None:
                    return api.prefill(params, batch, cfg)
                # one token at the last position: the cache holds seq_len
                return api.decode_step(params, cache, batch["tokens"], shape.seq_len - 1, cfg)

        t_build = time.perf_counter() - t0
        with fake:
            _, count = count_step(fn, args, mesh, trace=trace)
        t_step = time.perf_counter() - t0 - t_build
    return count, t_build, t_step


def _costs(count: StepCount) -> tuple[float, float, float, dict]:
    """(flops, bytes, collective wire bytes, breakdown) — per device."""
    coll = count.stats
    return (
        float(count.flops),
        float(count.bytes),
        float(coll.wire_bytes),
        {
            "bytes_by_kind": coll.bytes_by_kind,
            "count_by_kind": coll.count_by_kind,
            "ops": count.ops,
        },
    )


def segment_slopes(cfg, shape: ShapeSpec, mesh, rules):
    """Counts of the 1-layer probe and each segment's per-layer slope:
    ``((f0, b0, w0), {segment: (df, db, dw)})``."""
    segs = segment_counts(cfg)
    ones = {k: 1 for k in segs}
    c0, _, _ = count_cell(with_segments(cfg, ones).replace(scan_layers=False), shape, mesh, rules)
    base = _costs(c0)[:3]
    del c0
    gc.collect()
    slopes = {}
    for k in segs:
        probe = dict(ones)
        probe[k] = 2
        ci, _, _ = count_cell(with_segments(cfg, probe).replace(scan_layers=False), shape, mesh,
                              rules)
        slopes[k] = tuple(a - b for a, b in zip(_costs(ci)[:3], base))
        del ci
        gc.collect()
    return base, slopes


def affine_costs(cfg, shape: ShapeSpec, mesh, rules) -> tuple[float, float, float]:
    """(flops, bytes, wire) at the true depth by the affine extrapolation
    from the 1- and 2-layer probes (the reference's correction)."""
    base, slopes = segment_slopes(cfg, shape, mesh, rules)
    segs = segment_counts(cfg)
    return tuple(base[i] + sum((segs[k] - 1) * s[i] for k, s in slopes.items())
                 for i in range(3))


def depth_corrected_costs(cfg, shape: ShapeSpec, mesh, rules, direct: StepCount | None = None):
    """(flops, bytes, wire, breakdown, flop slopes per layer): the direct
    count at the true depth (``direct``, counted here when None) and each
    segment's per-layer flop slope from the 1- and 2-layer probes."""
    if direct is None:
        direct, _, _ = count_cell(cfg, shape, mesh, rules)
    flops, bytes_, wire, bk = _costs(direct)
    _, slopes = segment_slopes(cfg, shape, mesh, rules)
    return flops, bytes_, wire, bk, {k: v[0] for k, v in slopes.items()}


def lower_cell(arch: str, shape: ShapeSpec, multi_pod: bool, save_hlo: bool = False,
               device: str = "cuda", out_dir: str = OUT_DIR):
    mesh = production_mesh(multi_pod, device)
    mesh_name = "x".join(str(s) for s in mesh.shape)
    chips = mesh.size()
    cfg = adjust_cfg(get_config(arch), shape, mesh)
    api = get_api(cfg)
    rules = {"batch": data_axes(mesh), "groups": data_axes(mesh)}

    # 1) the deliverable: the FULL config must build and run on this mesh
    trace = [] if save_hlo else None
    count, t_lower, t_compile = count_cell(cfg, shape, mesh, rules, trace=trace)
    f_raw, b_raw, w_raw, bk_raw = _costs(count)
    mem_fields = {
        "temp_size_in_bytes": count.temp_bytes,
        "argument_size_in_bytes": sum(count.argument_bytes.values()),
        "output_size_in_bytes": count.output_bytes,
        "generated_code_size_in_bytes": None,
    }
    gc.collect()

    # 2) roofline terms (single-pod only)
    n_total = count_params(api.decls(cfg))
    n_active = n_active_params(cfg, n_total)
    roof_row = None
    if not multi_pod:
        flops_dev, bytes_dev, wire_dev, _, flop_slopes = depth_corrected_costs(
            cfg, shape, mesh, rules, direct=count
        )
        model_flops = ra.model_flops_estimate(cfg, shape, n_total, n_active)
        roof = ra.analyze(
            arch, shape.name, mesh_name, chips,
            hlo_flops=flops_dev * chips,  # the count is per device
            hlo_bytes=bytes_dev * chips,
            coll_bytes_per_chip=wire_dev,
            model_flops=model_flops,
        )
        roof_row = roof.row()
        roof_row["flop_slopes_per_layer"] = flop_slopes

    record = {
        "arch": arch,
        "shape": shape.name,
        "mesh": mesh_name,
        "chips": chips,
        "status": "ok",
        "lower_s": round(t_lower, 2),
        "compile_s": round(t_compile, 2),
        "n_params": n_total,
        "n_active": n_active,
        "raw_cost_uncorrected": {"flops": f_raw, "bytes": b_raw, "wire": w_raw},
        "memory_analysis": mem_fields,
        "collectives": bk_raw,
        "roofline": roof_row,
    }
    if save_hlo:
        os.makedirs(out_dir, exist_ok=True)
        record["hlo_path"] = os.path.join(out_dir, f"{arch}__{shape.name}__{mesh_name}.ops.txt")
        with open(record["hlo_path"], "w") as f:
            f.write("\n".join(trace) + "\n")
    gc.collect()
    return record


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--save-hlo", action="store_true",
                    help="write each cell's counted ops, one a line, beside its record")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the mesh's device type (cuda raises without a GPU)")
    ap.add_argument("--out-dir", default=OUT_DIR, help="where the records go")
    args = ap.parse_args(argv)
    if not args.all and not args.arch:
        ap.error("give --arch or --all")

    os.makedirs(args.out_dir, exist_ok=True)
    archs = ARCH_IDS if args.all else [args.arch]
    shapes = list(SHAPES.values()) if args.all or not args.shape else [SHAPES[args.shape]]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    for arch in archs:
        for shape in shapes:
            cfg = get_config(arch)
            ok, why = applicable(cfg, shape)
            for mp in meshes:
                mesh_name = "2x16x16" if mp else "16x16"
                tag = f"{arch}__{shape.name}__{mesh_name}"
                if not ok:
                    rec = {
                        "arch": arch, "shape": shape.name, "mesh": mesh_name,
                        "status": "skip", "reason": why,
                    }
                    print(f"[SKIP] {tag}: {why}", flush=True)
                else:
                    try:
                        rec = lower_cell(arch, shape, mp, save_hlo=args.save_hlo,
                                         device=args.device, out_dir=args.out_dir)
                        r = rec.get("roofline")
                        extra = (
                            f" flops {r['hlo_flops']:.3e} bytes {r['hlo_bytes']:.3e}"
                            f" coll/chip {r['coll_bytes_per_chip']:.3e} -> {r['bottleneck']}"
                            if r else " (shardability only)"
                        )
                        print(
                            f"[OK]   {tag}: lower {rec['lower_s']}s compile {rec['compile_s']}s"
                            + extra,
                            flush=True,
                        )
                    except Exception as e:  # record failures — they are bugs
                        rec = {
                            "arch": arch, "shape": shape.name, "mesh": mesh_name,
                            "status": "fail", "error": f"{type(e).__name__}: {e}",
                            "trace": traceback.format_exc()[-4000:],
                        }
                        print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
                with open(os.path.join(args.out_dir, f"{tag}.json"), "w") as f:
                    json.dump(rec, f, indent=1, default=str)
                results.append(rec)
                gc.collect()
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "fail" for r in results)
    print(f"\ndry-run matrix: {n_ok} ok / {n_skip} skip / {n_fail} fail", flush=True)
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
