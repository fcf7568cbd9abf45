"""Arithmetic over the program's own spans, for the per-layer metrics'
readers (``metrics/``).

The program opens a ``torch.profiler`` range at each of its stages while a
profile records (``repro_torch.trace``); the tracer keeps those whose name
starts with a layer's prefix in ``t.ranges``.  A benchmark span around the
same call opens a range of the same name, one inside the other, so a
name's intervals are merged before they are summed.  The ranges cover the
profiled stretch only, and a program without spans leaves none: every
reader built on :func:`per_unit` returns None then.
"""
from __future__ import annotations


def merged(t, name: str) -> list[tuple[float, float]]:
    """The union of the host ranges named ``name``: disjoint, in order."""
    out: list[tuple[float, float]] = []
    for s, e in sorted((s, e) for n, s, e in t.ranges if n == name):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def overlap(a, b) -> float:
    """Seconds that two lists of disjoint, ordered intervals share."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        total += max(0.0, min(a[i][1], b[j][1]) - max(a[i][0], b[j][0]))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def seconds(t, name: str, less: str | None = None) -> float:
    """Host seconds under ``name``, less the part under ``less``."""
    iv = merged(t, name)
    total = sum(e - s for s, e in iv)
    return total - overlap(iv, merged(t, less)) if less else total


def units(t, name: str) -> int:
    """Calls of the unit span ``name`` (``economy.epoch``, ``service.submit``)."""
    return len(merged(t, name))


def per_unit(t, value, unit: str):
    """``value(t)`` over the calls of ``unit``; None where the program
    opened no such span."""
    n = units(t, unit)
    return value(t) / n if n else None


def idle_seconds(t, names) -> float | None:
    """Seconds of device idle that the tracer gives to ranges in ``names``
    (a predicate on a name); None where the trace has no device operation."""
    if not t.kernels:
        return None
    return sum(secs for name, secs in t.idle_gaps() if names(name))
