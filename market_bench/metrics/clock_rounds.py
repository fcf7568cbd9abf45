"""Clock rounds an epoch, the mean over the traced window (the rounds each
epoch reports)."""


def read(t):
    rounds = t.counters.get("rounds", [])
    return sum(rounds) / len(rounds) if rounds else None
