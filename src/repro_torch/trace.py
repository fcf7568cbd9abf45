"""Spans of the market's stages, on the clock of the device's trace.

Tracing is on exactly while a ``torch.profiler`` profile records in this
process.  Then :func:`span` opens a ``torch.profiler.record_function``
range, which Kineto writes into its host trace on the same clock as the
device's operations, so a reader of the trace can say which stage the host
was in while the device sat idle.  Otherwise :func:`span` returns one
shared no-op context, and a span costs the flag's read and an empty
``with``: a few hundred nanoseconds, where an idle ``record_function``
costs microseconds.  A range costs about 13 µs of host time on the
NVIDIA H100 machine's host while a profile records.

Span names start with the layer they belong to: ``economy.*``
(:class:`~repro_torch.core.Economy`'s host stages), ``fused.*`` (the fused
epoch program) or ``service.*`` (the market service).  No span sits inside
a function a CUDA graph captures, and none synchronises the device.
:class:`Stopwatch` times consecutive stages of one call besides, each
under its span, for timings a caller keeps whether or not a profile
records (``MarketService.last_tick_timings``).
"""
from __future__ import annotations

import contextlib
import functools
import time

import torch
from torch.autograd import profiler as _profiler

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records the range ``name`` while a profile records,
    and does nothing otherwise."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def traced(name: str):
    """Decorate a function so that every call runs under :func:`span` ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class Stopwatch:
    """Host milliseconds of a call's stages, each run under its span.

    ``now`` reads the clock (the service's reads it after the device has
    finished its queue, so a stage's time includes its device work).  A
    stage timed twice adds up under its key."""

    def __init__(self, now=time.perf_counter):
        self.now = now
        self.ms: dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, key: str):
        t0 = self.now()
        with span(name):
            yield
            t1 = self.now()
        self.ms[key] = self.ms.get(key, 0.0) + (t1 - t0) * 1e3
