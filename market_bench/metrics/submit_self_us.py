"""Host microseconds a ``submit`` spends outside its journal append (the
program's ``service.submit`` spans less the part under its
``service.wal_append`` spans, over the submits): validation, packing the
row, queueing it."""
from market_bench.program_spans import per_unit, seconds


def read(t):
    return per_unit(t, lambda t: seconds(t, "service.submit", less="service.wal_append") * 1e6,
                    "service.submit")
