"""The metrics read from the program's own spans, at a small size on the
CPU: a traced run of each cell reports them beside every metric it
reported before; those read from the device's idle report nothing here,
as the device trace's other readers do."""
from __future__ import annotations

import json

import pytest
import torch

from market_bench import harness, testing

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
SPANS = {"fleet-8c-100k.steady": {"margins_ms", "upload_ms"},
         "fleet-8c-100k.outage": {"margins_ms", "upload_ms"},
         "service-8c-131k.churn": {"submit_self_us", "full_snapshot_ms", "full_write_ms",
                                   "full_publish_ms"}}
IDLE = {"clock_idle_us_per_chunk", "capture_idle_ms"}


def small(cfg, params):
    """The tests' size, with a full record every third tick: the warm-up
    tick and the window's first cut deltas, its second (a traced window has
    two at least) a full one."""
    cfg, params = testing.small(cfg, params)
    if cfg["kind"] == "service":
        cfg = dict(cfg, service=dict(cfg["service"], checkpoint_full_every=2))
    return cfg, params


@pytest.mark.parametrize("workload", sorted(SPANS))
def test_traced_run_reads_the_program_spans(workload):
    torch.set_num_threads(1)
    out = harness.run(workload, 98765432109, 1.0, True, testing.CPU, override=small)
    assert out["correct"], out["checks"]
    got = out["metrics"]
    assert SPANS[workload] <= set(got)
    assert all(got[m]["value"] >= 0.0 for m in SPANS[workload])
    assert not IDLE & set(got)  # no device trace on the CPU
    host = {m["name"] for m in BENCH["per_layer"] if m["source"] != "device_trace"
            and workload in m.get("workloads", [workload])}
    assert set(got) == host  # every metric of the cell that the CPU can read
    if workload.startswith("service"):
        phases = sum(got[m]["value"] for m in ("full_snapshot_ms", "full_write_ms",
                                               "full_publish_ms"))
        assert phases <= got["commit_full_ms"]["value"]
