"""Agents whose reach a bidder policy re-drew, in a mean timed epoch (the
program's ``Economy.last_policy_counts["policy_redraws"]`` after each
epoch); nothing where the program keeps no such count."""


def read(t):
    redraws = t.counters.get("policy_redraws", [])
    return sum(redraws) / len(redraws) if redraws else None
