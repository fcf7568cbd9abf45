"""Host milliseconds an epoch in the economy's own numpy: the spans around
its prepare (faults, reserves, the epoch's draws), adopt (copies back) and
finalize (statistics) stages, each after a device synchronisation."""


def read(t):
    names = ("economy.prepare", "economy.adopt", "economy.finalize")
    if not t.units or any(n not in t.spans for n in names):
        return None
    return sum(sum(t.spans[n]) for n in names) / t.units
