"""The cells at a size the CPU tests can hold: 1,000 agents over 4
clusters, one warm-up epoch or tick, a window of a fraction of a second."""
from __future__ import annotations

import torch

from . import harness

CPU = torch.device("cpu")


def small(cfg: dict, params: dict, agents: int = 1000) -> tuple[dict, dict]:
    params = dict(params, warmup=min(int(params["warmup"]), 2), profile_units=1,
                  sample_span=2, check_sample=1)
    return dict(cfg, agents=agents, clusters=4), params


def run(workload: str, seed: int = 12345678901, seconds: float = 0.2,
        traced: bool = False) -> dict:
    torch.set_num_threads(1)
    return harness.run(workload, seed, seconds, traced, CPU, override=small)


def sut(workload: str, seed: int, seconds: float, workdir: str, agents: int = 1000,
        max_rounds: int | None = None, **mix):
    """A cell's program driven through set-up and a window, released, ready
    for ``check``; ``max_rounds`` cuts the clock's round budget and ``mix``
    overrides the traffic's parameters."""
    torch.set_num_threads(1)
    _, _, cfg, params = harness.cell_spec(workload)
    cfg, params = small(cfg, params, agents)
    if max_rounds is not None:
        cfg["clock"] = dict(cfg["clock"], max_rounds=max_rounds)
    params.update(mix)
    return harness.driven(cfg, params, seed, CPU, workdir, seconds)[0], cfg["limits"]
