"""A run loads neither JAX nor the JAX package: a fresh process imports the
harness, runs a small cell and lists the top-level names in
``sys.modules`` (a subprocess, since test workers share their modules with
the JAX tests)."""
from __future__ import annotations

import json
import os
import subprocess
import sys

from market_bench import harness

SCRIPT = """
import json, sys
sys.path[:0] = [{root!r}, {src!r}]
from market_bench import harness, testing
out = testing.run("service-8c-131k.churn", seconds=0.05)
print(json.dumps({{"correct": out["correct"],
                   "tops": sorted({{m.split(".")[0] for m in sys.modules}})}}))
"""


def test_run_loads_no_jax(tmp_path):
    root = str(harness.ROOT)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["TMPDIR"] = str(tmp_path)
    res = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(root=root, src=str(harness.ROOT / "src"))],
        capture_output=True, text=True, timeout=300, env=env, cwd=root)
    assert res.returncode == 0, res.stderr[-2000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got["correct"]
    assert not set(got["tops"]) & {"jax", "jaxlib", "flax", "repro"}
    assert "repro_torch" in got["tops"]
