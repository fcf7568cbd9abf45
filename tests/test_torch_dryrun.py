"""The port's dry run (``repro_torch.launch.dryrun``) end to end, on fake
worlds in subprocesses (with a timeout, as ``tests/test_dryrun_specs.py``
runs the reference's).

* the CLI writes an ``ok`` record for ``qwen3-1.7b`` ``decode_32k`` on the
  16×16 mesh of a fake 256-rank world (``--device cpu``), its collectives
  under the reference's own bound (2e9 bytes a chip), its ``model_flops``,
  ``n_params`` and ``n_active`` the reference's;
* the direct count at the true depth equals the affine extrapolation from
  the 1- and 2-layer probes of each segment;
* each custom op's fake output shapes equal its real CPU output's.

A smoke step of every family on a 2×2 fake world is in
``tests/test_torch_dryrun_families.py``.
"""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro.configs import get_config as jx_get_config  # noqa: E402
from repro.configs.shapes import SHAPES as JX_SHAPES  # noqa: E402
from repro.models import get_api as jx_get_api  # noqa: E402
from repro.models.params import count_params as jx_count_params  # noqa: E402
from repro.roofline import analysis as jra  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402

TIMEOUT_S = 420
ENV = dict(os.environ, PYTHONPATH="src", OMP_NUM_THREADS="1")
# one segment, trained; a dense and an MoE segment; units with a tail layer
DEPTH_FAMILIES = {"dense": ("qwen3-1.7b", "train"), "moe": ("deepseek-v3-671b", "train"),
                  "hybrid": ("recurrentgemma-2b", "prefill")}


def _run(script: str) -> dict:
    proc = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          env=ENV, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + "\n" + proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cli_decode_cell_at_16x16(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "qwen3-1.7b", "--shape",
         "decode_32k", "--device", "cpu", "--out-dir", str(tmp_path)],
        capture_output=True, text=True, env=ENV, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stdout[-2000:] + "\n" + proc.stderr[-4000:]
    assert "dry-run matrix: 1 ok / 0 skip / 0 fail" in proc.stdout
    rec = json.loads((tmp_path / "qwen3-1.7b__decode_32k__16x16.json").read_text())
    assert (rec["status"], rec["mesh"], rec["chips"]) == ("ok", "16x16", 256)
    r = rec["roofline"]
    assert r["hlo_flops"] > 0 and r["hlo_bytes"] > 0
    assert r["bottleneck"] in ("compute", "memory", "collective")
    # decode of a 1.7B model must not move more than ~1 GB/chip of collectives
    assert 0 < r["coll_bytes_per_chip"] < 2e9, r["coll_bytes_per_chip"]
    assert set(rec["collectives"]["count_by_kind"]) <= {"all-reduce", "all-gather",
                                                         "reduce-scatter", "all-to-all"}
    jcfg = jx_get_config("qwen3-1.7b")
    n = jx_count_params(jx_get_api(jcfg).decls(jcfg))
    assert rec["n_params"] == rec["n_active"] == n  # dense: every parameter is active
    assert r["model_flops"] == jra.model_flops_estimate(jcfg, JX_SHAPES["decode_32k"], n, n)
    assert r["flop_slopes_per_layer"]["layers"] > 0
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] >= 0


def test_cuda_mesh_needs_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU is visible"):
        dryrun.production_mesh(False, "cuda")


DEPTH_SCRIPT = r"""
import json
import torch
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.configs import get_smoke
from repro_torch.configs.shapes import ShapeSpec
from repro_torch.launch import dryrun as dr

# three layers of each segment against the 1- and 2-layer probes, on a mesh
# whose data axis is one rank: there no layout depends on the depth (ZeRO-1
# picks the largest dim the data axes divide, which a depth of 3 can change)
dr.fake_world(4)
mesh = DeviceMesh("cpu", torch.arange(4).reshape(1, 4), mesh_dim_names=("data", "model"))
rules = {"batch": ("data",), "groups": ("data",)}
out = {}
for family, (arch, kind) in DEPTH_FAMILIES.items():
    shape = ShapeSpec(kind, 32, 4, kind)
    base = dr.adjust_cfg(get_smoke(arch), shape, mesh)
    cfg = dr.with_segments(base, {k: 3 for k in dr.segment_counts(base)})
    c, _, _ = dr.count_cell(cfg, shape, mesh, rules)
    affine = dr.affine_costs(cfg, shape, mesh, rules)
    f, b, w, _, slopes = dr.depth_corrected_costs(cfg, shape, mesh, rules, direct=c)
    out[family] = {"direct": dr._costs(c)[:3], "affine": affine, "reported": [f, b, w],
                   "slopes": slopes, "segments": dr.segment_counts(cfg)}
print(json.dumps(out))
""".replace("DEPTH_FAMILIES", repr(DEPTH_FAMILIES))


@pytest.fixture(scope="module")
def depth_runs():
    return _run(DEPTH_SCRIPT)


@pytest.mark.parametrize("family", DEPTH_FAMILIES)
def test_direct_count_equals_the_affine_extrapolation(depth_runs, family):
    """Flops exactly, and bytes and collective bytes too where every layer
    of a segment moves the same: a one-layer stack is the exception DTensor
    makes, gathering a (1, E) factored moment of the MoE router as a view
    where deeper stacks chunk and concatenate (a few hundred bytes, in the
    Adafactor update only)."""
    d = depth_runs[family]
    assert d["reported"] == d["direct"]
    assert d["direct"][0] == d["affine"][0]
    if family == "moe":
        assert d["direct"][1:] == pytest.approx(d["affine"][1:], rel=1e-4, abs=0)
    else:
        assert d["direct"] == d["affine"]
    assert set(d["slopes"]) == set(d["segments"]) and all(v > 0 for v in d["slopes"].values())
    assert all(n == 3 for n in d["segments"].values())


def test_custom_ops_fake_shapes_equal_their_real_outputs():
    g = torch.Generator().manual_seed(0)
    cases = [((2, 37, 3, 8), (2, 37, 3, 5), True), ((2, 5, 3, 8), (2, 5, 3, 8), False),
             ((9, 2, 4), (9, 2, 6), False)]  # the last one unbatched
    for rk, vk, with_state in cases:
        r = torch.randn(rk, generator=g)
        v = torch.randn(vk, generator=g)
        w = torch.rand(rk, generator=g)
        u = torch.randn(rk[-2:], generator=g)
        s0 = torch.randn(rk[:-3] + rk[-2:] + vk[-1:], generator=g) if with_state else None
        real = ops.wkv6(r, r, v, w, u, s0, 8)
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            fake = ops.wkv6(*(None if t is None else mode.from_tensor(t)
                              for t in (r, r, v, w, u, s0)), 8)
        assert [(tuple(t.shape), t.dtype) for t in fake] == \
            [(tuple(t.shape), t.dtype) for t in real]
    out, index, source = torch.zeros(7, 3, 2), torch.tensor([0, 6, 6, 9, -1]), torch.ones(5, 3, 2)
    real = ops.ordered_rows_add(out.clone(), index, source)
    with FakeTensorMode() as mode:
        fo = mode.from_tensor(out)
        fake = ops.ordered_rows_add(fo, mode.from_tensor(index), mode.from_tensor(source))
        assert fake is fo
    assert (tuple(fake.shape), fake.dtype) == (tuple(real.shape), real.dtype)
    assert real[6].eq(2).all() and real[0].eq(1).all()
    with FakeTensorMode() as mode:
        t = mode.from_tensor(torch.zeros(11, 4)).requires_grad_(True)
        y = ops.ordered_gather(t, mode.from_tensor(torch.tensor([[1, 2], [3, 12]])))
        y.sum().backward()  # the backward's ordered_rows_add runs fake
        assert tuple(y.shape) == (2, 2, 4) and tuple(t.grad.shape) == (11, 4)
