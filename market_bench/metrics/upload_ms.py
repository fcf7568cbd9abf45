"""Host milliseconds an epoch uploading the fused program's inputs (the
program's ``economy.upload`` spans, over its ``economy.epoch`` spans): the
per-agent inputs padded and copied to the device, and the whole state
again where the host mirrors changed it."""
from market_bench.program_spans import per_unit, seconds


def read(t):
    return per_unit(t, lambda t: seconds(t, "economy.upload") * 1e3, "economy.epoch")
