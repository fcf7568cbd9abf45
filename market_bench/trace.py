"""Spans, counters and the device trace of a ``--trace 1`` run, and the
per-layer metrics read from them.

The benchmark's own spans wrap the program's calls into each layer.  The
window's first units run under ``torch.profiler`` (:meth:`Tracer.profile`):
there a span only records a ``torch.profiler.record_function`` range under
its name, so that the device trace can say what the host was doing, and
the host and the device overlap as they do untraced.  After that stretch a
span synchronises the device before and after its call (so it times its
own layer, not the queue before it) and adds its host milliseconds to
``spans[name]``.  A wrapped call that the program no longer has is
skipped, and the metrics that read it report nothing.

From the profiled stretch: kernels, copies and sets on the device, unioned
into the busy time; the idle gaps between them named by the innermost
benchmark span open on the host at the time.
"""
from __future__ import annotations

import bisect
import contextlib
import heapq
import importlib.util
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
SPAN_PREFIXES = ("economy", "fused", "service", "client")


class Tracer:
    def __init__(self, device: torch.device):
        self.device = device
        self.spans: dict[str, list[float]] = {}
        self.counters: dict[str, list] = {}
        self.kernels: list[tuple[str, float, float]] = []  # (name, start s, seconds)
        self.ranges: list[tuple[str, float, float]] = []  # host ranges (name, start s, end s)
        self.busy_s = self.window_s = None
        self.profiling = False  # inside the profiled stretch: spans only annotate
        self.units = 0  # units timed by synchronised spans

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def span(self, name: str):
        if self.profiling:
            with torch.profiler.record_function(name):
                yield
            return
        self.sync()
        t0 = time.perf_counter()
        yield
        self.sync()
        self.spans.setdefault(name, []).append((time.perf_counter() - t0) * 1e3)

    def wrap(self, obj, attr: str, name, when=None) -> None:
        """Time every call of ``obj.attr`` (those for which ``when(*args)``
        holds) as span ``name`` (or ``name(*args)``); nothing where ``obj``
        has no such call."""
        inner = getattr(obj, attr, None)
        if inner is None:
            return

        def call(*args, **kw):
            if when is not None and not when(*args):
                return inner(*args, **kw)
            with self.span(name(*args) if callable(name) else name):
                return inner(*args, **kw)

        setattr(obj, attr, call)

    def count(self, name: str, value) -> None:
        self.counters.setdefault(name, []).append(value)

    @contextlib.contextmanager
    def profile(self):
        """Profile the stretch inside: device busy seconds, the stretch's
        seconds, each device operation and each named host range."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.sync()
        with torch.profiler.profile(activities=acts) as prof:
            self.sync()
            self.profiling = True
            t0 = time.perf_counter()
            try:
                yield
                self.sync()
            finally:
                self.window_s = time.perf_counter() - t0
                self.profiling = False
        self._read(prof)

    def _read(self, prof) -> None:
        """Kineto's raw events (no operator tree is built): device operations
        apart from the annotations of host ranges, and the named host ranges."""
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            start, dur = e.start_ns() * 1e-9, e.duration_ns() * 1e-9
            named = name.split(".")[0] in SPAN_PREFIXES
            if e.device_type() == cuda:
                annotation = getattr(e, "is_user_annotation", lambda: False)()
                if not named and not annotation:
                    self.kernels.append((name, start, dur))
            elif named:
                self.ranges.append((name, start, start + dur))
        self.busy_s = union_seconds([(s, s + d) for _, s, d in self.kernels])

    def breakdown(self) -> dict:
        ops: dict[str, float] = {}
        for name, _, d in self.kernels:
            ops[name] = ops.get(name, 0.0) + d
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in top], "idle_gaps": self.idle_gaps()[:10]}

    def idle_gaps(self) -> list:
        """Seconds the device sat idle between its first and last operation,
        by the innermost benchmark span open on the host meanwhile."""
        iv = sorted((s, s + d) for _, s, d in self.kernels)
        gaps, end = [], None
        for s, e in iv:
            if end is not None and s > end:
                gaps.append((end, s))
            end = e if end is None else max(end, e)
        by_name: dict[str, float] = {}
        for name, secs in _attribute(gaps, sorted(self.ranges, key=lambda r: r[1])):
            by_name[name] = by_name.get(name, 0.0) + secs
        return sorted(([n, v] for n, v in by_name.items()), key=lambda kv: -kv[1])


def _attribute(gaps, ranges, lookback: int = 256):
    """Split each gap at the host ranges' edges and give each piece to the
    innermost range (the latest begun) open over it.  ``ranges`` is sorted
    by start; a range open at a gap's start began at most ``lookback``
    ranges before it (the benchmark's spans nest a few deep)."""
    starts = [r[1] for r in ranges]
    for gs, ge in gaps:
        lo = max(0, bisect.bisect_left(starts, gs) - lookback)
        near = [r for r in ranges[lo:bisect.bisect_right(starts, ge)] if r[2] > gs]
        points = sorted([(max(s, gs), 1, i) for i, (_, s, _e) in enumerate(near)]
                        + [(min(e, ge), 0, i) for i, (_, _s, e) in enumerate(near)])
        heap: list = []
        alive: set = set()
        t_prev = gs
        for t, opens, i in points + [(ge, 0, -1)]:
            while heap and heap[0][1] not in alive:
                heapq.heappop(heap)
            if t > t_prev:
                yield (near[heap[0][1]][0] if heap else "outside the benchmark's spans"), t - t_prev
                t_prev = t
            if opens:
                alive.add(i)
                heapq.heappush(heap, (-near[i][1], i))
            else:
                alive.discard(i)


def union_seconds(intervals) -> float:
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def read_metric(name: str, tracer: Tracer):
    """The per-layer metric ``name`` from its reader, ``metrics/<name>.py``:
    a number, or None where the reader found nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"market_bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    value = mod.read(tracer)
    return None if value is None else float(value)
