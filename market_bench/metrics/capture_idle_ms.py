"""Milliseconds of device idle an epoch under the fused program's CUDA
graph captures (the program's ``fused.capture`` spans, over its
``economy.epoch`` spans): 0 where no stage was captured in the profiled
epochs."""
from market_bench.program_spans import idle_seconds, per_unit


def read(t):
    idle = idle_seconds(t, lambda name: name == "fused.capture")
    if idle is None:
        return None
    return per_unit(t, lambda t: idle * 1e3, "economy.epoch")
