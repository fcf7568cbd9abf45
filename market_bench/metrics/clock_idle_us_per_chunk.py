"""Microseconds of device idle a clock chunk: the idle the device trace
gives to the program's ``fused.clock`` and ``fused.clock.*`` spans (the
chunk replays, the done-flag reads, the checks between escalation stages)
over its ``fused.clock.chunk`` spans."""
from market_bench.program_spans import idle_seconds, per_unit


def clock(name: str) -> bool:
    return name == "fused.clock" or name.startswith("fused.clock.")


def read(t):
    idle = idle_seconds(t, clock)
    if idle is None:
        return None
    return per_unit(t, lambda t: idle * 1e6, "fused.clock.chunk")
