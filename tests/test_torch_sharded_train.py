"""Sharded training and serving of the port on spawned gloo worlds, against
the port's one-rank step and the live JAX reference's unsharded step.

Two worlds a module, each spawned once (``_spawn``: one ``python -c`` a
rank over a FileStore, within ``SPAWN_TIMEOUT_S``), started before the
parent computes its own results so both run at once:

* world 2: every family's smoke config takes one AdamW step at meshes 2×1
  and 1×2 (weights placed by ``validated_pspec_tree`` as DTensors, under
  ``sharding.use_mesh``); ``qwen3`` and ``deepseek-v3`` repeat their 1×2
  step (determinism) and decode greedily at 1×2 (``qwen3`` also at 1×4,
  its two kv heads whole on each rank); ``launch.train`` and
  ``launch.serve`` run with ``--mesh 1x2``;
* world 4: every family at 1×4 (four model ranks: the kv heads of the
  GQA smoke configs and recurrentgemma's gate blocks do not split four
  ways), ``qwen3`` and ``deepseek-v3`` at 2×2, ``launch.train`` and
  ``launch.serve`` with ``--mesh 2x2``, and ``compressed_psum`` over the
  four ranks.

Tolerances are ``tests/test_torch_train.py``'s: the loss to rtol 1e-5, the
gradients to rtol 1e-4 and atol 1e-6 against the one-rank port's (RWKV-6:
rtol = atol = 1e-4, ``tests/test_torch_rwkv.py``'s float32 tolerance); the
updated parameters against both by its rule for a step whose gradients
differ by more than float order in a few elements: at most 1% of them
apart by more than rtol 1e-4 / atol 1e-5, none by more than the learning
rate.  A sharded gradient sums its terms in another order, and Adam's
normalised first step turns an ulp of difference in a gradient near zero
into a visible step (one element of a leaf, 2e-5 to 6e-5 apart, in about
half the cases).  A world's repeated step is bit-identical, and greedy ids
equal one rank's.  ``examples/elastic_train_torch.py`` runs through its
re-provision on two and four ranks under ``torchrun --standalone`` (a free
port, no fixed one), its printed final loss (four decimals) within one
step of the last decimal of one rank's.
"""
import json
import os
import pickle
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # tiny models: more threads only contend with the other test workers

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jx_get_smoke  # noqa: E402
from repro.models import get_api as jx_get_api  # noqa: E402
from repro.models.params import init_params as jx_init_params  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro.train import train_step as jts  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.launch import serve as pserve  # noqa: E402
from repro_torch.launch import train as ptrain  # noqa: E402
from repro_torch.models import get_api  # noqa: E402
from repro_torch.models.convert import params_from_reference  # noqa: E402
from repro_torch.models.params import tree_leaves, tree_map  # noqa: E402
from repro_torch.serve.decode import generate  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402
from repro_torch.train.train_step import (batch_to_device, init_train_state,  # noqa: E402
                                          make_train_step)

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
SPAWN_TIMEOUT_S = 240
ARCHS = ["qwen3-1.7b", "deepseek-v3-671b", "kimi-k2-1t-a32b", "rwkv6-7b",
         "recurrentgemma-2b", "whisper-medium", "pixtral-12b"]
PAIR = ["qwen3-1.7b", "deepseek-v3-671b"]  # also at 2×2, repeated and served
MESHES = {2: [(2, 1), (1, 2)], 4: [(2, 2), (1, 4)]}
LR = 1e-3
# test_torch_rwkv.py's float32 tolerance: the WKV sums run in other orders
GRAD_TOL = {"rwkv6-7b": (1e-4, 1e-4)}
CLI = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--seed", "3"]
TRAIN_CLI = CLI + ["--steps", "2", "--batch", "4", "--seq", "16"]
SERVE_CLI = CLI + ["--batch", "2", "--prompt-len", "8", "--new", "6", "--temperature", "0"]

WORKER = r"""
import contextlib, io, pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
rank, world, tmp = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=world, rank=rank)
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_smoke
from repro_torch.launch import serve, train
from repro_torch.models import get_api
from repro_torch.models.convert import params_from_reference
from repro_torch.models.params import shard_params, tree_leaves, tree_map, validated_pspec_tree
from repro_torch.serve.decode import generate
from repro_torch.sharding import use_mesh
from repro_torch.train.grad_compress import compressed_psum
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import batch_to_device, init_train_state, make_train_step

job = pickle.load(open(f"{tmp}/job.pkl", "rb"))


def whole(t):
    return (t.full_tensor() if isinstance(t, DTensor) else t).detach().numpy()


def mesh_of(shape):
    return DeviceMesh("cpu", torch.arange(world).reshape(shape), mesh_dim_names=("data", "model"))


def sharded(arch, mesh):
    cfg = get_smoke(arch)
    return cfg, shard_params(params_from_reference(job["weights"][arch], device="cpu"), mesh,
                             validated_pspec_tree(get_api(cfg).decls(cfg), mesh))


def grads(cfg, params, batch):
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    loss, _ = get_api(cfg).loss(tree_map(lambda _: next(it), params), batch, cfg)
    return [whole(g) for g in torch.autograd.grad(loss, leaves)]


def step(arch, shape):
    mesh = mesh_of(shape)
    with use_mesh(mesh):
        cfg, params = sharded(arch, mesh)
        opt = AdamW(lr=job["lr"])
        state = init_train_state(cfg, opt, params)
        batch = batch_to_device(job["batches"][arch], cfg, "cpu")
        g = grads(cfg, params, batch)
        params, state, m = make_train_step(cfg, opt)(params, state, batch)
        return {"metrics": {k: float(v) for k, v in m.items()}, "params": tree_map(whole, params),
                "grads": g}


out = {"steps": {}, "repeat": {}, "ids": {}}
for arch, shapes in job["steps"].items():
    for shape in shapes:
        out["steps"][arch, shape] = step(arch, shape)
for arch, shape in job["repeat"]:
    out["repeat"][arch, shape] = step(arch, shape)
for arch, shape in job["serve"]:
    mesh = mesh_of(shape)
    with use_mesh(mesh):
        cfg, params = sharded(arch, mesh)
        out["ids"][arch, shape] = generate(params, cfg, torch.from_numpy(job["prompt"]),
                                           job["new"]).numpy()
shape = "x".join(map(str, job["cli_mesh"]))
metrics = f"{tmp}/metrics{rank}.jsonl"
assert train.main(job["train_cli"] + ["--mesh", shape, "--metrics", metrics]) == 0
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    assert serve.main(job["serve_cli"] + ["--mesh", shape]) == 0
out["serve_stdout"] = buf.getvalue()
if job["psum"]:
    x = np.random.default_rng(rank).normal(size=(5, 9)).astype(np.float32) * (rank + 1)
    out["psum"] = compressed_psum(torch.from_numpy(x)).numpy()
pickle.dump(out, open(f"{tmp}/rank{rank}.pkl", "wb"))
dist.barrier()  # no rank tears its connections down while a peer still uses them
dist.destroy_process_group()
"""


def _weights(arch):
    cfg = jx_get_smoke(arch)
    p = jx_init_params(jax.random.PRNGKey(0), jx_get_api(cfg).decls(cfg))
    return jax.tree_util.tree_map(np.asarray, p)


def _batch(arch):
    return SyntheticLM(get_smoke(arch), 4, 16, seed=1)(0)


def _start(world, tmp: Path, job: dict):
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump(job, f)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(tmp)],
                             env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]


def _join(procs, tmp: Path, deadline: float) -> list[dict]:
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(deadline - time.monotonic(), 1))[0])
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return [pickle.load(open(tmp / f"rank{r}.pkl", "rb")) for r in range(len(procs))]


def _reference_step(arch, weights, batch):
    cfg = jx_get_smoke(arch)
    opt = jopt.AdamW(lr=LR)
    params = jax.tree_util.tree_map(jnp.asarray, weights)
    state = jts.init_train_state(cfg, opt, params)
    params, _, m = jax.jit(jts.make_train_step(cfg, opt))(
        params, state, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(m["loss"]), [np.asarray(x) for x in jax.tree_util.tree_leaves(params)]


def _port_step(arch, weights, batch):
    """The one-rank port's loss, updated parameters and gradients."""
    cfg = get_smoke(arch)
    opt = AdamW(lr=LR)
    params = params_from_reference(weights, device="cpu")
    batch = batch_to_device(batch, cfg, "cpu")
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    it = iter(leaves)
    loss, _ = get_api(cfg).loss(tree_map(lambda _: next(it), params), batch, cfg)
    grads = [g.numpy() for g in torch.autograd.grad(loss, leaves)]
    state = init_train_state(cfg, opt, params)
    params, _, m = make_train_step(cfg, opt)(params, state, batch)
    return float(m["loss"]), [x.numpy() for x in tree_leaves(params)], grads


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Both worlds' outputs and the parent's one-rank and reference results."""
    weights = {arch: _weights(arch) for arch in ARCHS}
    batches = {arch: _batch(arch) for arch in ARCHS}
    prompt = np.random.default_rng(5).integers(0, 512, (2, 8)).astype(np.int64)
    jobs = {
        2: {"steps": {arch: MESHES[2] for arch in ARCHS},
            "repeat": [(arch, (1, 2)) for arch in PAIR], "serve": [(arch, (1, 2)) for arch in PAIR],
            "cli_mesh": (1, 2), "psum": False},
        4: {"steps": {arch: MESHES[4] if arch in PAIR else [(1, 4)] for arch in ARCHS},
            "repeat": [(PAIR[1], (2, 2))],
            "serve": [(PAIR[0], (1, 4))], "cli_mesh": (2, 2), "psum": True},
    }
    started, deadline = {}, time.monotonic() + SPAWN_TIMEOUT_S
    for world, job in jobs.items():
        job.update(weights=weights, batches=batches, lr=LR, prompt=prompt, new=6,
                   train_cli=TRAIN_CLI, serve_cli=SERVE_CLI)
        tmp = tmp_path_factory.mktemp(f"world{world}")
        started[world] = (_start(world, tmp, job), tmp)
    ref = {arch: _reference_step(arch, weights[arch], batches[arch]) for arch in ARCHS}
    one = {arch: _port_step(arch, weights[arch], batches[arch]) for arch in ARCHS}
    ids = {}
    for arch in PAIR:
        cfg = get_smoke(arch)
        ids[arch] = generate(params_from_reference(weights[arch], device="cpu"), cfg,
                             torch.from_numpy(prompt), 6).numpy()
    cli_dir = tmp_path_factory.mktemp("one_rank_cli")
    assert ptrain.main(TRAIN_CLI + ["--metrics", str(cli_dir / "m.jsonl")]) == 0
    outs = {world: _join(procs, tmp, deadline) for world, (procs, tmp) in started.items()}
    return {"ref": ref, "one": one, "ids": ids, "outs": outs,
            "dirs": {world: tmp for world, (_, tmp) in started.items()}, "cli_dir": cli_dir}


CASES = [(arch, shape) for arch in ARCHS for shape in MESHES[2] + [(1, 4)]] + [
    (arch, (2, 2)) for arch in PAIR]


@pytest.mark.parametrize("arch,shape", CASES, ids=[f"{a}-{d}x{m}" for a, (d, m) in CASES])
def test_sharded_step_matches_one_rank_and_reference(run, arch, shape):
    world = shape[0] * shape[1]
    got = run["outs"][world][0]["steps"][arch, shape]
    for other in run["outs"][world][1:]:  # every rank holds the same whole result
        assert other["steps"][arch, shape]["metrics"] == got["metrics"]
    loss, one_params, one_grads = run["one"][arch]
    assert len(got["grads"]) == len(one_grads)
    rtol, atol = GRAD_TOL.get(arch, (1e-4, 1e-6))
    for g, w in zip(got["grads"], one_grads):
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    params = tree_leaves(got["params"])
    for loss, want in (run["one"][arch][:2], run["ref"][arch]):
        np.testing.assert_allclose(got["metrics"]["loss"], loss, rtol=1e-5)
        assert len(params) == len(want)
        apart = total = 0
        for g, w in zip(params, want):
            diff = np.abs(g - w)
            assert diff.max() <= LR * 1.01
            apart += int((diff > 1e-5 + 1e-4 * np.abs(w)).sum())
            total += diff.size
        assert apart <= 0.01 * total, (apart, total)


REPEATS = [(arch, (1, 2)) for arch in PAIR] + [(PAIR[1], (2, 2))]


@pytest.mark.parametrize("arch,shape", REPEATS, ids=[f"{a}-{d}x{m}" for a, (d, m) in REPEATS])
def test_a_world_repeats_its_step_bit_for_bit(run, arch, shape):
    outs = run["outs"][shape[0] * shape[1]][0]
    first, again = outs["steps"][arch, shape], outs["repeat"][arch, shape]
    assert first["metrics"] == again["metrics"]
    for a, b in zip(tree_leaves(first["params"]), tree_leaves(again["params"])):
        assert np.array_equal(a, b)


SERVES = [(arch, (1, 2)) for arch in PAIR] + [(PAIR[0], (1, 4))]


@pytest.mark.parametrize("arch,shape", SERVES, ids=[f"{a}-{d}x{m}" for a, (d, m) in SERVES])
def test_sharded_greedy_decode_equals_one_rank(run, arch, shape):
    for out in run["outs"][shape[0] * shape[1]]:
        np.testing.assert_array_equal(out["ids"][arch, shape], run["ids"][arch])


def _losses(path):
    return [json.loads(line)["loss"] for line in open(path)]


@pytest.mark.parametrize("world", [2, 4])
def test_train_and_serve_clis_on_a_mesh(run, world, capsys):
    want = _losses(run["cli_dir"] / "m.jsonl")
    np.testing.assert_allclose(_losses(run["dirs"][world] / "metrics0.jsonl"), want, rtol=1e-5)
    assert not os.path.exists(run["dirs"][world] / "metrics1.jsonl")  # rank 0 writes alone
    assert pserve.main(SERVE_CLI) == 0
    one = capsys.readouterr().out
    lead = run["outs"][world][0]["serve_stdout"]
    ids = re.compile(r"continuation ids\[0\]: .*|greedy next ids .*")
    assert ids.findall(lead) == ids.findall(one) and len(ids.findall(one)) == 2
    assert all(out["serve_stdout"] == "" for out in run["outs"][world][1:])


def test_compressed_psum_over_four_ranks_is_the_reference_formula(run):
    xs = [np.random.default_rng(r).normal(size=(5, 9)).astype(np.float32) * (r + 1)
          for r in range(4)]
    scale = np.float32(max(np.abs(x).max() for x in xs) / np.float32(127.0))
    q = sum(np.clip(np.round(x / scale), -127, 127).astype(np.int32) for x in xs)
    for out in run["outs"][4]:
        np.testing.assert_allclose(out["psum"], q.astype(np.float32) * scale, rtol=1e-6)


def _final_loss(stdout):
    return float(re.findall(r"\[done\] final loss ([0-9.]+)", stdout)[-1])


TWIN = [str(ROOT / "examples" / "elastic_train_torch.py"), "--device", "cpu", "--steps", "6"]


def _twin_env():
    return dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")


@pytest.fixture(scope="module")
def twin_one_rank():
    return subprocess.run([sys.executable] + TWIN, env=_twin_env(), capture_output=True,
                          text=True, timeout=SPAWN_TIMEOUT_S, check=True).stdout


@pytest.mark.parametrize("ranks", [2, 4])
def test_elastic_twin_reprovisions_on_a_world(twin_one_rank, ranks):
    out = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                          "--nproc-per-node", str(ranks)] + TWIN, env=_twin_env(),
                         capture_output=True, text=True, timeout=SPAWN_TIMEOUT_S)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert f"[job] mesh ({ranks}, 1) over {ranks} rank(s)" in out.stdout
    assert "[elastic] resumed step 3 on new grant (64 chips in us-east)" in out.stdout
    # one step of the printed fourth decimal: the two may round apart
    assert abs(_final_loss(out.stdout) - _final_loss(twin_one_rank)) <= 1.01e-4
