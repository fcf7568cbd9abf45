"""Microseconds a journal append: the benchmark's span around each of the
service's write-ahead-log appends (the record written and flushed before
``submit`` or ``withdraw`` acknowledges)."""


def read(t):
    spans = t.spans.get("service.wal_append")
    return sum(spans) * 1e3 / len(spans) if spans else None
