"""Host milliseconds an epoch in the bidder policies (the program's
``economy.policies`` spans, over its ``economy.epoch`` spans): each
policy's ``act`` on the last epoch's prices, the fold of the actions into
the epoch's reach keys, price caps, sell intents and margins, and the
marking of the acting agents' bids as changed."""
from market_bench.program_spans import per_unit, seconds


def read(t):
    return per_unit(t, lambda t: seconds(t, "economy.policies") * 1e3, "economy.epoch")
