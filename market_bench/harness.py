"""One run of one cell: set-up, the measured window, the output check.

``run`` reads the cell from ``BENCHMARK.json``, its deployment from the
configuration's file and its load from ``traffic/<mix>.json``, builds the
program on the seed's fleet, warms up every shape the load uses (set-up),
drives the load for ``seconds``, then frees the program's device state and
checks what the window produced against the plain reference.  ``--trace 1``
adds a device trace over the start of the window and the benchmark's spans
after it, and reports the cell's per-layer metrics in place of its
end-to-end ones.
"""
from __future__ import annotations

import importlib
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import torch

from . import trace

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cell_spec(workload: str, root: Path = ROOT) -> tuple[dict, dict, dict, dict]:
    """(benchmark, cell, deployment, mix parameters) of ``workload``."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    cfg = json.loads((root / conf["file"]).read_text())
    from . import load

    return bench, cell, cfg, load.mix(cell["traffic"])


def cell_class(kind: str):
    """The class that runs a deployment's ``"kind"``: ``<kind>_cell.Cell``."""
    return importlib.import_module(f"market_bench.{kind}_cell").Cell


def driven(cfg: dict, params: dict, seed: int, device: torch.device, workdir: str,
           seconds: float, tracer=None, t_start: float | None = None):
    """A cell's program through set-up (``build``, ``warm_up``, the spans
    of ``tracer`` installed) and a window, then released: ready for its
    ``check``.  Returns ``(cell, window record, setup seconds since
    t_start, peak device bytes)``."""
    t_start = time.perf_counter() if t_start is None else t_start
    sut = cell_class(cfg["kind"])(cfg, params, seed, device, workdir)
    sut.build()
    sut.warm_up()
    if tracer is not None:
        sut.instrument(tracer)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t_start
    rec = sut.window(seconds, tracer)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    sut.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return sut, rec, setup_s, peak


def metric_names(bench: dict, workload: str, kind: str) -> list[str]:
    return [m["name"] for m in bench[kind]
            if "workloads" not in m or workload in m["workloads"]]


def bytes_written() -> int | None:
    """Bytes this process has handed to ``write`` calls so far (files on a
    disk or in memory alike)."""
    try:
        with open("/proc/self/io") as f:
            return next(int(line.split()[1]) for line in f if line.startswith("wchar"))
    except (OSError, StopIteration, ValueError):
        return None


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, traced: bool, device: torch.device,
        t_start: float | None = None, root: Path = ROOT, override=None) -> dict:
    """One run of ``workload``; ``override(cfg, params) -> (cfg, params)``
    resizes it (the CPU tests run the cells at a small size)."""
    t_start = time.perf_counter() if t_start is None else t_start
    bench, cell, cfg, params = cell_spec(workload, root)
    if override is not None:
        cfg, params = override(cfg, params)
    tmp = tempfile.mkdtemp(prefix="market_bench.", dir=os.environ.get("TMPDIR") or None)
    try:
        return _run(bench, cell, cfg, params, seed, seconds, traced, device, t_start, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(bench, cell, cfg, params, seed, seconds, traced, device, t_start, tmp) -> dict:
    tracer = trace.Tracer(device) if traced else None
    sut, rec, setup_s, peak = driven(cfg, params, seed, device, tmp, seconds, tracer, t_start)
    readings = sut.check(device)
    limits = cfg["limits"]
    checks = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    correct = all(v["value"] <= v["limit"] for v in checks.values())

    name = cell["name"]
    if traced:
        metrics = {}
        units = {m["name"]: m["unit"] for m in bench["per_layer"]}
        for m in metric_names(bench, name, "per_layer"):
            v = trace.read_metric(m, tracer)
            if v is not None:
                metrics[m] = {"value": v, "unit": units[m]}
    else:
        metrics = {"setup_s": {"value": setup_s, "unit": "s"}}
        for m in metric_names(bench, name, "end_to_end"):
            if m in rec["metrics"]:
                v, unit = rec["metrics"][m]
                metrics[m] = {"value": v, "unit": unit}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": int(rec["attempted"]),
           "failed": int(sut.failed), "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"], dev["window_s"] = tracer.busy_s, tracer.window_s
        out["breakdown"] = tracer.breakdown()
    out["readings"] = {k: v for k, v in readings.items() if k not in checks}
    out["readings"]["bytes_written"] = bytes_written()
    out["readings"]["window"] = {k: rec[k] for k in ("units", "seconds", "rounds", "tenths_ms",
                                                     "ack_p99_us") if k in rec}
    out["checks"] = checks  # last: the numbers compared, each beside its limit
    return out
