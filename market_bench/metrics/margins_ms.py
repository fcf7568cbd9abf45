"""Host milliseconds an epoch in ``AgentPopulation.margins()`` (the
program's ``economy.margins`` spans, over its ``economy.epoch`` spans):
``margin0 · margin_decay ** epoch``, dear once the power underflows."""
from market_bench.program_spans import per_unit, seconds


def read(t):
    return per_unit(t, lambda t: seconds(t, "economy.margins") * 1e3, "economy.epoch")
