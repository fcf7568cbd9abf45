"""Milliseconds an epoch in the fused program's pack and settle stages (the
spans around each stage's replay, synchronised before and after)."""


def read(t):
    names = ("fused.pack", "fused.settle")
    if not t.units or any(n not in t.spans for n in names):
        return None
    return sum(sum(t.spans[n]) for n in names) / t.units
