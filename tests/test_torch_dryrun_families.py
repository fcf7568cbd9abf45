"""A smoke-config step of every family (train, prefill and decode) through
the dry run's ``count_cell`` on a 2×2 fake world, in a subprocess with a
timeout.  The kernel entry points (``ordered_rows_add``, ``wkv6``) are
custom ops with fake versions, so each training step's backward runs on
fake tensors, and every layout the families' hints ask for is accepted.
"""
import json
import os
import subprocess
import sys

import pytest

pytest.importorskip("torch")

TIMEOUT_S = 420
FAMILIES = {"dense": "qwen3-1.7b", "moe": "deepseek-v3-671b", "ssm": "rwkv6-7b",
            "hybrid": "recurrentgemma-2b", "audio": "whisper-medium", "vlm": "pixtral-12b"}
KINDS = ("train", "prefill", "decode")

SCRIPT = r"""
import json
import torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_smoke
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun as dr

dr.fake_world(4)
mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2), mesh_dim_names=("data", "model"))
rules = {"batch": ("data",), "groups": ("data",)}
out = {}
for family, arch in FAMILIES.items():
    for kind in KINDS:
        shape = ShapeSpec(kind, 32, 4, kind)
        cfg = dr.adjust_cfg(get_smoke(arch), shape, mesh)
        c, _, _ = dr.count_cell(cfg, shape, mesh, rules)
        out[f"{family}/{kind}"] = c.totals() | {"peak": c.peak_bytes, "args": c.argument_bytes}
print(json.dumps(out))
""".replace("FAMILIES", repr(FAMILIES)).replace("KINDS", repr(KINDS))


@pytest.fixture(scope="module")
def steps():
    env = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
    proc = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                          env=env, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + "\n" + proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_smoke_step_runs_on_a_fake_world(steps, family, kind):
    c = steps[f"{family}/{kind}"]
    assert c["flops"] > 0 and c["bytes"] > 0 and c["ops"] > 0
    assert c["peak"] >= sum(c["args"].values()) > 0
    assert c["collectives"], "a 2x2 mesh shards something"
    want = {"params", "opt_state", "batch"} if kind == "train" else \
        {"params", "batch", "cache"} if kind == "decode" else {"params", "batch"}
    assert set(c["args"]) == want
