"""The output check fails its control: the plain reference computed in
bfloat16, the precision below the deployment's float32, put in the
program's place.  At a small size, over the first epochs or ticks, with a
clock of 1,000 rounds a stage: a bfloat16 clock runs its first stage out
wherever a step is below its resolution, and runs slowly on the CPU;
``control.py`` runs it on the card at the cells' own size."""
from __future__ import annotations

import json

import pytest
import torch

from market_bench import harness, testing

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_the_check(workload, tmp_path):
    """bfloat16 reads beyond a limit where the program in float32 reads
    within every one."""
    sut, limits = testing.sut(workload, 2024, 0.0, str(tmp_path), agents=300, max_rounds=1000,
                              warmup=1, check_sample=0)
    sound = sut.check(testing.CPU)
    assert all(sound[k] <= v for k, v in limits.items()), sound
    control = sut.check(testing.CPU, torch.bfloat16)
    assert any(control[k] > v for k, v in limits.items()), control
