"""Microseconds a clock round: the spans around the fused program's clock
stages, less the CUDA-graph captures inside the epochs, over the rounds."""


def read(t):
    rounds = sum(t.counters.get("rounds", []))
    if "fused.clock" not in t.spans or not rounds:
        return None
    busy = sum(t.spans["fused.clock"]) - sum(t.counters.get("capture_ms", []))
    return busy * 1e3 / rounds
