"""The port's training CLI (``python -m repro_torch.launch.train``), its
mesh from a grant (``core.provisioner.grant_to_mesh``) and the five example
twins (``examples/*_torch.py``), on the CPU.

The CLI's losses are held exactly against an uninterrupted run (one
process, one device, the same seed: the same float32 arithmetic), across an
injected fault and a resume.  Mesh shapes are the reference's for every
grant of 1–512 chips over 1, 3, 8 and 512 devices.  The twins run as a
user runs them, in a subprocess with ``--device cpu`` at the sizes of the
reference's ``tests/test_examples.py``, and must print its lines.
"""
import contextlib
import io
import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny model: more threads only contend with the other test workers

from repro.core import provisioner as jprov  # noqa: E402
from repro_torch.core import provisioner as prov  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--batch", "2", "--seq", "16"]


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")


def _losses(path):
    with open(path) as f:
        return {m["step"]: m["loss"] for m in map(json.loads, f)}


def _main(argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = train.main(argv)
    return rc, out.getvalue().splitlines()


def test_train_cli_resumes_after_a_fault_with_the_same_losses(tmp_path):
    rc, lines = _main(SMOKE + ["--steps", "8", "--metrics", str(tmp_path / "plain.jsonl")])
    assert rc == 0 and lines[-1] == "[train] done" and lines[0].startswith("[train] step 0 loss")
    plain = _losses(tmp_path / "plain.jsonl")
    assert sorted(plain) == list(range(8))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *SMOKE, "--steps", "8",
           "--ckpt-dir", str(tmp_path / "ckpt"), "--ckpt-every", "3",
           "--metrics", str(tmp_path / "run.jsonl"), "--heartbeat", str(tmp_path / "hb")]
    killed = subprocess.run(cmd + ["--fault-step", "5"], env=_env(), capture_output=True,
                            text=True, timeout=300)
    assert killed.returncode != 0 and "injected fault at step 5" in killed.stderr
    assert (tmp_path / "hb").read_text() == "4"
    assert sorted(os.listdir(tmp_path / "ckpt"))[-1] in ("ckpt_00000003", ".tmp.3")
    resumed = subprocess.run(cmd, env=_env(), capture_output=True, text=True, timeout=300)
    assert resumed.returncode == 0, resumed.stderr
    out = resumed.stdout.splitlines()
    first = int(re.fullmatch(r"\[train\] resumed from step (\d+)", out[0]).group(1))
    assert first in (0, 3) and out[-1] == "[train] done"
    with open(tmp_path / "run.jsonl") as f:
        run = [json.loads(line) for line in f]
    assert [m["step"] for m in run] == list(range(5)) + list(range(first + 1, 8))
    for m in run:
        assert m["loss"] == plain[m["step"]], m
    assert "ckpt_00000007" in os.listdir(tmp_path / "ckpt")


def test_train_cli_nan_guard_returns_3(tmp_path):
    rc, lines = _main(SMOKE + ["--steps", "4", "--lr", "inf"])
    assert rc == 3 and "NaN/Inf loss at step 1" in lines[-1]


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "whisper-medium", "pixtral-12b"])
def test_train_cli_trains_the_hybrid_audio_and_vlm_families(arch, tmp_path):
    """Three steps of the smoke config; the first loss is the model's own
    loss of seed 0's weights on step 0's batch (audio frames and image
    patches cast to the activation dtype on the device)."""
    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import get_api
    from repro_torch.models.params import init_params
    from repro_torch.train.train_step import batch_to_device

    rc, lines = _main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2", "--seq",
                       "16", "--steps", "3", "--metrics", str(tmp_path / "m.jsonl")])
    assert rc == 0 and lines[-1] == "[train] done"
    losses = _losses(tmp_path / "m.jsonl")
    assert sorted(losses) == [0, 1, 2] and all(map(math.isfinite, losses.values()))
    cfg = get_smoke(arch)
    api = get_api(cfg)
    params = init_params(torch.Generator().manual_seed(0), api.decls(cfg), device="cpu")
    batch = batch_to_device(SyntheticLM(cfg, 2, 16, seed=0)(0), cfg, "cpu")
    with torch.no_grad():
        assert losses[0] == float(api.loss(params, batch, cfg)[0])


@pytest.mark.parametrize("extra", [["--grad-accum", "2"], ["--compress"]])
def test_train_cli_options_run(extra):
    rc, lines = _main(SMOKE + ["--steps", "2"] + extra)
    assert rc == 0 and lines[-1] == "[train] done"


def test_train_cli_refuses_a_mesh_of_several_devices():
    """Without a world of that many ranks (torchrun's or the caller's)."""
    with pytest.raises(RuntimeError, match="needs a torch.distributed world of 2 ranks"):
        train.main(SMOKE + ["--steps", "1", "--mesh", "2x1"])
    assert tuple(train.build_mesh("1x1", torch.device("cpu")).shape) == (1, 1)


@pytest.mark.parametrize("available", [1, 3, 8, 512])
@pytest.mark.parametrize("min_model", [1, 2, 8])
def test_grant_to_mesh_has_the_reference_shape(available, min_model):
    for chips in range(1, 513):
        want = jprov.grant_to_mesh(jprov.DeviceGrant("job", "c", chips), min_model,
                                   devices=list(range(available)))
        got = prov.grant_to_mesh(prov.DeviceGrant("job", "c", chips), min_model,
                                 devices=range(available), device="cpu")
        assert tuple(got.shape) == want.devices.shape, chips
        assert got.mesh_dim_names == ("data", "model")
        assert got.mesh.flatten().tolist() == want.devices.flatten().tolist()


_GLOO_ONE = """
import json, sys, torch.distributed as dist
from repro_torch.core.provisioner import DeviceGrant, grant_to_mesh, world_size
from repro_torch.launch.train import build_mesh
dist.init_process_group("gloo", store=dist.FileStore(sys.argv[1], 1), world_size=1, rank=0)
mesh = grant_to_mesh(DeviceGrant("job", "eu-west", 128), device="cpu")
group = mesh.get_group("data")
out = {"shape": list(mesh.shape), "names": list(mesh.mesh_dim_names), "world": world_size(),
       "group": dist.get_world_size(group), "coord": list(mesh.get_coordinate()),
       "train": list(build_mesh(None, mesh.device_type).shape)}
dist.destroy_process_group()
print(json.dumps(out))
"""


def test_grant_to_mesh_in_a_gloo_world_of_one(tmp_path):
    """With a process group the mesh spans its ranks (one here), and each
    axis has a process group of its own."""
    out = subprocess.run([sys.executable, "-c", _GLOO_ONE, str(tmp_path / "store")], env=_env(),
                         capture_output=True, text=True, timeout=120, check=True)
    assert json.loads(out.stdout.splitlines()[-1]) == {
        "shape": [1, 1], "names": ["data", "model"], "world": 1, "group": 1, "coord": [0, 0],
        "train": [1, 1]}


def test_grant_to_mesh_without_a_group_is_one_rank():
    mesh = prov.grant_to_mesh(prov.DeviceGrant("job", "c", 64), device="cpu")
    assert tuple(mesh.shape) == (1, 1) and list(mesh.get_coordinate()) == [0, 0]
    assert prov.world_size() == 1


TWINS = {
    "quickstart": (["quickstart_torch.py"], ["SYSTEM feasible: True", "settled unit prices"]),
    "market_sim": (["market_sim_torch.py", "--epochs", "4", "--seed", "3"],
                   ["all epochs SYSTEM-feasible: True"]),
    "market_sim_scenario": (["market_sim_torch.py", "--scenario", "congestion_relief", "--epochs",
                             "4", "--seed", "3"],
                            ["all epochs converged: True", "all epochs SYSTEM-feasible: True"]),
    "market_sim_list": (["market_sim_torch.py", "--list-scenarios"],
                        ["congestion_relief", "cluster_drain", "price_shock", "flash_crowd",
                         "sticky_relocation"]),
    "market_service_demo": (["market_service_demo_torch.py", "--agents", "300", "--ticks", "3",
                             "--seed", "0"],
                            ["churn synced", "killed + resumed", "WAL records replayed",
                             "SYSTEM ok=True",
                             "incremental book bit-identical to full repack: True"]),
    "serve_demo": (["serve_demo_torch.py"], ["[serve] prefill 4×16", "[serve] generated 96 tokens",
                                             "[serve] sample continuation ids"]),
    "elastic_train": (["elastic_train_torch.py"],
                      ["[market] grant: 128 chips in eu-west", "[market] grant: 64 chips in us-east",
                       "[elastic] resumed step 20 on new grant (64 chips in us-east)",
                       "[done] final loss"]),
}


@pytest.mark.parametrize("twin", list(TWINS))
def test_example_twin_runs_on_the_cpu(twin):
    script, *args = TWINS[twin][0]
    out = subprocess.run([sys.executable, str(ROOT / "examples" / script), *args, "--device", "cpu"],
                         env=_env(), cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout + "\n" + out.stderr
    for line in TWINS[twin][1]:
        assert line in out.stdout, line
    if twin.startswith("market_sim") and twin != "market_sim_list":
        m = re.search(r"total migrations: (\d+)", out.stdout)
        assert m and int(m.group(1)) > 0, "the market must move agents"
