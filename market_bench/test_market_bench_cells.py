"""Each cell end to end at a small size on the CPU: the run is correct and
its metrics are there."""
from __future__ import annotations

import json

import pytest

from market_bench import harness, testing

CELLS = [w["name"] for w in json.loads((harness.ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct(workload):
    out = testing.run(workload)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    assert set(out["metrics"]) == set(harness.metric_names(bench, workload, "end_to_end"))
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert list(out)[-1] == "checks"
    assert out["device"]["platform"] == "cpu"  # never reported as a device's


def test_traced_run_reads_host_layers():
    out = testing.run("fleet-8c-100k.steady", seconds=1.0, traced=True)  # past the profiled epoch
    assert out["correct"]
    m = out["metrics"]
    assert {"economy_host_ms", "fused_stages_ms", "clock_rounds"} <= set(m)
    assert "partials_roofline.epoch" not in m  # no device trace on the CPU


EVERY_FAULT = {"region_faults": [{"cluster": 1, "start": 1, "end": 3, "scale": 0.5, "rtype": 0}],
               "bid_dropout": 0.1, "seller_fail": 0.25, "pool_fail": 0.15,
               "pool_fail_scale": 0.5}


def test_every_fault_channel_of_a_mix_reaches_both_sides(tmp_path):
    """A mix that turns on every channel of the fault model: the program
    draws each, and the reference follows it epoch by epoch."""
    sut, limits = testing.sut("fleet-8c-100k.steady", 4242, 0.0, str(tmp_path), agents=2000,
                              warmup=4, check_sample=0, faults=EVERY_FAULT)
    drawn = [sum(col) for col in zip(*(got["faults"] for got, _ in sut.warm))]
    assert all(d > 0 for d in drawn), drawn  # dropped, flaked, failed pools, evicted
    readings = sut.check(testing.CPU)
    assert all(readings[k] <= v for k, v in limits.items()), readings


def test_a_surge_is_a_mix_of_the_same_generator(tmp_path):
    """Each tick a tenth of the agents raise their bids: the batch load
    with other numbers, checked as the churn cell is."""
    sut, limits = testing.sut("service-8c-131k.churn", 4243, 0.3, str(tmp_path),
                              submits=100, withdraws=0, wtp_scale=[1.5, 3.0])
    readings = sut.check(testing.CPU)
    assert readings["ticks_compared"] > 1
    assert all(readings[k] <= v for k, v in limits.items()), readings
