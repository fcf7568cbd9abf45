"""The port's roofline (``repro_torch.roofline``) against the reference's.

* ``analyze`` and ``model_flops_estimate``: the same terms for the same
  counts, each term times its constant equal (the H100's constants stand
  where the reference's TPU ones do);
* ``collective_stats`` over the counting mode's records equals the
  reference's over HLO lines written from the same records;
* ``dryrun_table`` and ``roofline_table`` byte for byte for the same records;
* the counting mode: one sharded product at 16×16 counts each device's
  local product (103,079,215,104 flops), not DTensor's global shape
  inference; a replicated op counts whole on every device; the live-bytes
  peak of a known sequence; collectives by kind, result bytes and group.

Fake worlds run in subprocesses with a timeout.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import ARCH_IDS, get_config as jx_get_config  # noqa: E402
from repro.configs.shapes import SHAPES as JX_SHAPES  # noqa: E402
from repro.roofline import analysis as jra  # noqa: E402
from repro.roofline import hlo_parse as jhlo  # noqa: E402
from repro.roofline import report as jreport  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.shapes import SHAPES  # noqa: E402
from repro_torch.roofline import analysis as ra  # noqa: E402
from repro_torch.roofline import report  # noqa: E402
from repro_torch.roofline.collectives import Collective, collective_stats  # noqa: E402
from repro_torch.roofline.count import count_step, rows_add_cost, wkv6_cost  # noqa: E402

TIMEOUT_S = 300

COUNTS = [  # (chips, flops, bytes, wire a chip, model flops)
    (256, 1.853e12, 7.159e12, 3.571e7, 4.4e11),
    (256, 5.02e16, 1.77e15, 1.77e11, 1.08e16),
    (512, 3.3e15, 1e13, 0.0, 2.2e15),
    (1, 2.1e13, 3.0e11, 0.0, 2.1e13),
    (256, 0.0, 1e9, 1e6, 0.0),
]


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", range(len(COUNTS)))
def test_analyze_terms_match_the_reference(case, dtype):
    chips, flops, nbytes, wire, model = COUNTS[case]
    want = jra.analyze("a", "s", "m", chips, flops, nbytes, wire, model)
    got = ra.analyze("a", "s", "m", chips, flops, nbytes, wire, model, dtype=dtype)
    assert list(got.row()) == list(want.row())  # the reference's fields, in its order
    assert got.t_compute * ra.PEAK_FLOPS[dtype] == pytest.approx(
        want.t_compute * jra.PEAK_FLOPS, rel=1e-15, abs=0)
    assert got.t_memory * ra.HBM_BW == pytest.approx(want.t_memory * jra.HBM_BW, rel=1e-15,
                                                     abs=0)
    assert got.t_collective * ra.LINK_BW == pytest.approx(want.t_collective * jra.LINK_BW,
                                                          rel=1e-15, abs=0)
    assert got.useful_ratio == want.useful_ratio
    terms = {"compute": got.t_compute, "memory": got.t_memory, "collective": got.t_collective}
    assert got.bottleneck == max(terms, key=terms.get)
    dom = max(terms.values())
    assert got.peak_fraction == (model / (chips * ra.PEAK_FLOPS[dtype] * dom) if dom else 0.0)


def test_h100_constants():
    assert ra.PEAK_FLOPS == {"bfloat16": 989e12, "float32": 67e12}
    assert (ra.HBM_BW, ra.LINK_BW) == (3.35e12, 50e9)


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_estimate_matches_the_reference(arch, shape):
    n, na = 1_234_567_891, 456_789_123
    for active in (na, 0):
        assert ra.model_flops_estimate(get_config(arch), SHAPES[shape], n, active) == \
            jra.model_flops_estimate(jx_get_config(arch), JX_SHAPES[shape], n, active)


_HLO_NAMES = {"all-reduce": ["all-reduce", "all-reduce-start"],
              "all-gather": ["all-gather", "all-gather-start"],
              "reduce-scatter": ["reduce-scatter"], "all-to-all": ["all-to-all"],
              "collective-permute": ["collective-permute", "collective-permute-start"]}


def _records(seed, n=200):
    rng = np.random.default_rng(seed)
    kinds = list(_HLO_NAMES)
    return [Collective(kinds[int(rng.integers(len(kinds)))], int(rng.integers(1, 1 << 20)) * 4,
                       int(rng.choice([2, 16, 256]))) for _ in range(n)]


def _hlo(records, seed):
    """HLO lines carrying each record's result bytes (f32 when they split
    into 4-byte words, else u8), with ops and shapes the parser skips
    between them."""
    rng = np.random.default_rng(seed)
    lines = ["HloModule m", "ENTRY %main {", "  %p = f32[8,8]{1,0} parameter(0)"]
    for i, r in enumerate(records):
        op = _HLO_NAMES[r.kind][i % len(_HLO_NAMES[r.kind])]
        if r.result_bytes % 4 == 0 and rng.random() < 0.7:
            shape = f"f32[{r.result_bytes // 8},2]{{1,0}}" if r.result_bytes % 8 == 0 else \
                f"f32[{r.result_bytes // 4}]{{0}}"
        else:
            shape = f"u8[{r.result_bytes}]{{0}}"
        root = "ROOT " if i == len(records) - 1 else ""
        lines.append(f"  {root}%c.{i} = {shape} {op}(f32[8,8]{{1,0}} %p), "
                     f"replica_groups=[{r.group_size}]<=[{r.group_size}]")
        lines.append(f"  %add.{i} = f32[8,8]{{1,0}} add(f32[8,8]{{1,0}} %p, f32[8,8]{{1,0}} %p)")
    return "\n".join(lines + ["}"])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_collective_stats_match_the_reference_parser(seed):
    recs = _records(seed)
    got, want = collective_stats(recs), jhlo.collective_stats(_hlo(recs, seed))
    assert got.bytes_by_kind == want.bytes_by_kind
    assert got.count_by_kind == want.count_by_kind
    assert got.wire_bytes == want.wire_bytes
    assert got.total_bytes == want.total_bytes


def test_collective_stats_rejects_an_unknown_kind():
    with pytest.raises(ValueError, match="unknown collective"):
        collective_stats([Collective("broadcast", 4, 2)])


def _report_records():
    rng = np.random.default_rng(7)
    recs = []
    for arch in ARCH_IDS[:5]:
        for shape in SHAPES:
            for mesh in ("16x16", "2x16x16"):
                kind = rng.choice(["ok", "ok", "ok", "skip", "fail"])
                rec = {"arch": arch, "shape": shape, "mesh": mesh, "status": str(kind)}
                if kind == "skip":
                    rec["reason"] = "full-attention arch: O(S²) at 524k infeasible — skip"
                elif kind == "ok":
                    roof = ra.analyze(arch, shape, mesh, 256, *rng.uniform(1e9, 1e16, 3),
                                      float(rng.uniform(1e9, 1e15))).row()
                    rec.update(compile_s=round(float(rng.uniform(0, 90)), 2),
                               memory_analysis={
                                   "argument_size_in_bytes": int(rng.integers(1, 1 << 40)),
                                   "temp_size_in_bytes": int(rng.integers(0, 1 << 38))},
                               collectives={"count_by_kind": {
                                   "all-gather": int(rng.integers(0, 900)),
                                   "all-reduce": int(rng.integers(1, 400))}},
                               roofline=roof if mesh == "16x16" else None)
                recs.append(rec)
    return recs


def test_tables_byte_for_byte():
    recs = _report_records()
    assert report.dryrun_table(recs) == jreport.dryrun_table(recs)
    assert report.roofline_table(recs) == jreport.roofline_table(recs)
    for x in (None, 0, 1023, 1024, 5.5e9, -3e12, 2.0**70):
        assert report.fmt_b(x) == jreport.fmt_b(x)
        assert report.fmt_s(x) == jreport.fmt_s(x)


def test_report_loads_records(tmp_path):
    recs = _report_records()
    for i, r in enumerate(recs):
        (tmp_path / f"{i:03d}.json").write_text(json.dumps(r))
    assert report.load(str(tmp_path)) == jreport.load(str(tmp_path)) == recs


# -- the counting mode ----------------------------------------------------------


def test_live_bytes_peak_of_a_known_sequence():
    """Arguments count from the start; a storage counts until it dies; views
    share their base's storage and move no bytes."""
    a = torch.ones(1000)  # 4,000 B

    def fn(a):
        b = a * 2  # +4,000 (8,000 live)
        c = b[:500]  # a view: no storage, no bytes
        d = torch.cat([b, b])  # +8,000 (16,000)
        del b  # c keeps b's storage alive
        e = d.sum()  # +4 (16,004)
        del d  # -8,000 (8,004)
        f = torch.ones(3000)  # +12,000 (20,004): the peak
        return c, e, f

    _, c = count_step(fn, {"a": a})
    assert c.argument_bytes == {"a": 4000}
    assert c.peak_bytes == 4000 + 4000 + 8000 + 4 - 8000 + 12000
    assert c.output_bytes == 4000 + 4 + 12000
    assert c.temp_bytes == c.peak_bytes - 4000
    # mul reads a, writes b; cat reads b twice, writes d; sum; ones writes
    assert c.bytes == (4000 + 4000) + (8000 + 8000) + (8000 + 4) + 12000
    assert c.flops == 0


def test_flops_follow_the_flop_counter_and_replicated_ops_count_whole():
    x, w = torch.ones(64, 128), torch.ones(128, 32)
    _, c = count_step(lambda x, w: torch.relu(x @ w), {"x": x, "w": w})
    assert c.flops == 2 * 64 * 128 * 32 and c.flops_by_op == {"aten.mm": 2 * 64 * 128 * 32}
    assert c.bytes == (64 * 128 + 128 * 32 + 64 * 32) * 4 + 2 * 64 * 32 * 4


def test_custom_ops_are_charged_their_bounds():
    from repro_torch.kernels import ops

    out, index, source = torch.zeros(10, 3, 4), torch.arange(25) % 12, torch.ones(25, 3, 4)
    _, c = count_step(lambda out, index, source: ops.ordered_rows_add(out, index, source),
                      {"out": out, "index": index, "source": source})
    assert (c.bytes, c.flops) == rows_add_cost(out, index)
    assert rows_add_cost(out, index) == (25 * 8 + (25 + 2 * 10) * 12 * 4, 25 * 12)
    r, v = torch.ones(2, 40, 3, 8), torch.ones(2, 40, 3, 5)
    u, s0 = torch.ones(3, 8), torch.zeros(2, 3, 8, 5)
    _, c = count_step(lambda r, v, u, s0: ops.wkv6(r, r, v, r, u, s0, 16),
                      {"r": r, "v": v, "u": u, "s0": s0})
    want = wkv6_cost(r, r, v, r, u, s0, 16)
    assert (c.bytes, c.flops) == want
    b, t, h, kd, vd, L = 2, 40, 3, 8, 5, 16
    fmas = b * h * 3 * (2 * L * kd * vd + L * (L - 1) // 2 * (kd + vd) + L * vd)
    assert want == (4 * (3 * b * t * h * kd + b * t * h * vd + h * kd + b * h * kd * vd)
                    + 4 * (b * t * h * vd + b * h * kd * vd), 2 * fmas)


COUNT_SCRIPT = r"""
import json
import torch
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.roofline.count import count_step
from repro_torch.sharding.specs import from_local, placements
dist.init_process_group("fake", rank=0, world_size=256, store=FakeStore())
mesh = DeviceMesh("cpu", torch.arange(256).reshape(16, 16), mesh_dim_names=("data", "model"))

def sharded(shape, spec):
    pl = placements(spec, mesh)
    local = list(shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return from_local(torch.empty(local), mesh, pl, shape)

out = {}
with FakeTensorMode():
    x = sharded((256, 4096, 2048), ("data", None, None))
    w = sharded((2048, 6144), (None, "model"))
    for rep in range(2):  # the second product's shape inference is cached
        y, c = count_step(lambda x, w: x @ w, {"x": x, "w": w}, mesh)
        out[f"pin{rep}"] = {"flops": c.flops, "by_op": c.flops_by_op,
                            "local": list(y.to_local().shape), "args": c.argument_bytes}
    a = torch.empty(64, 64)
    _, c = count_step(lambda a: a @ a, {"a": a}, mesh)
    out["plain"] = c.flops
    r = sharded((64, 64), (None, None))
    _, c = count_step(lambda r: r @ r, {"r": r}, mesh)
    out["replicated"] = c.flops
    s = sharded((64, 64), ("data", "model"))
    for name, fn in {"partial": lambda s: s.sum(),
                     "all-reduce": lambda s: s.sum().full_tensor(),
                     "all-gather": lambda s: s.full_tensor()}.items():
        _, c = count_step(fn, {"s": s}, mesh)
        out[name] = [[r.kind, r.result_bytes, r.group_size] for r in c.collectives]
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def counted():
    env = dict(os.environ, PYTHONPATH="src")
    proc = subprocess.run([sys.executable, "-c", COUNT_SCRIPT], capture_output=True, text=True,
                          env=env, timeout=TIMEOUT_S)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_one_op_pin_counts_the_local_product(counted):
    """x (256, 4096, 2048) sharded over data, w (2048, 6144) over model: a
    device's product is (16·4096 × 2048)·(2048 × 384), 2·16·4096·2048·384
    flops; the global (1,048,576 × 2,048)·(2,048 × 6,144) product DTensor
    infers the output's shape with is not counted, cached or not."""
    for rep in ("pin0", "pin1"):
        assert counted[rep]["flops"] == 103_079_215_104 == 2 * 16 * 4096 * 2048 * 384
        assert counted[rep]["by_op"] == {"aten.mm": 103_079_215_104}
        assert counted[rep]["local"] == [16, 4096, 384]
        assert counted[rep]["args"] == {"x": 16 * 4096 * 2048 * 4, "w": 2048 * 384 * 4}


def test_replicated_op_counts_whole_on_every_device(counted):
    assert counted["plain"] == counted["replicated"] == 2 * 64 ** 3


def test_collectives_are_recorded_by_kind_bytes_and_group(counted):
    """A (64, 64) float32 tensor sharded over both 16-rank axes: its sum
    stays a partial sum (no collective); made whole, the scalar is
    all-reduced over each axis in turn; gathered whole, each axis
    all-gathers its part (the data axis first: 4 × 64 × 4 B, then the
    whole 64 × 64 × 4 B)."""
    assert counted["partial"] == []
    assert counted["all-reduce"] == [["all-reduce", 4, 16], ["all-reduce", 4, 16]]
    assert sorted(counted["all-gather"]) == [["all-gather", 1024, 16],
                                             ["all-gather", 16384, 16]]
