"""The port's GPipe pipeline (``repro_torch.train.pipeline``) against the
sequential loss, mirroring ``tests/test_pipeline.py``: S = 4 stages, M = 8
microbatches of MB = 2, width D = 16, on 4 spawned gloo ranks (one a
stage, a FileStore rendezvous, one spawn a module).  The loss and every
gradient are held to the sequential loss's at float32 rtol 1e-5 (atol 1e-6
for gradient elements near zero): the pipeline computes the same float32
expressions, stage by stage, on the same microbatches.  The reference's
own GPipe loss on the same numbers is held to the same.
"""
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

SRC = Path(__file__).resolve().parents[1] / "src"
S, M, MB, D = 4, 8, 2, 16
SPAWN_TIMEOUT_S = 120

WORKER = r"""
import pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
rank, tmp = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=4, rank=rank)
from torch.distributed.device_mesh import DeviceMesh
from repro_torch.sharding.specs import distribute_local
from repro_torch.train.pipeline import make_pipelined_loss

data = pickle.load(open(f"{tmp}/data.pkl", "rb"))
t = {k: torch.from_numpy(v) for k, v in data.items()}
mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("pod",))


def stage_fn(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def loss_head(p, outs, tgt):
    return torch.mean((torch.einsum("mbd,d->mb", outs, p["v"]) - tgt) ** 2)


params = {"stages": {"w": distribute_local(t["w"], mesh, ("pod", None, None)),
                     "b": distribute_local(t["b"], mesh, ("pod", None))},
          "head": {"v": distribute_local(t["v"], mesh, (None,))}}
for leaf in (params["stages"]["w"], params["stages"]["b"], params["head"]["v"]):
    leaf.requires_grad_(True)
loss = make_pipelined_loss(stage_fn, loss_head, mesh, "pod")(params, {"x": t["x"], "y": t["y"]})
loss.backward()
grads = {"w": params["stages"]["w"].grad.full_tensor().numpy(),
         "b": params["stages"]["b"].grad.full_tensor().numpy(),
         "v": params["head"]["v"].grad.full_tensor().numpy()}
pickle.dump({"loss": float(loss), "grads": grads}, open(f"{tmp}/rank{rank}.pkl", "wb"))
dist.barrier()
dist.destroy_process_group()
"""


def _data():
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(S, D, D)).astype(np.float32) * 0.3,
            "b": rng.normal(size=(S, D)).astype(np.float32) * 0.1,
            "v": rng.normal(size=(D,)).astype(np.float32),
            "x": rng.normal(size=(M, MB, D)).astype(np.float32),
            "y": rng.normal(size=(M, MB)).astype(np.float32)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("gpipe")
    with open(tmp / "data.pkl", "wb") as f:
        pickle.dump(_data(), f)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(S)]
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
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
    return [pickle.load(open(tmp / f"rank{r}.pkl", "rb")) for r in range(S)]


def _sequential():
    """The sequential loss and its gradients (torch), and the reference's."""
    d = {k: torch.from_numpy(v).requires_grad_(k in ("w", "b", "v")) for k, v in _data().items()}
    h = d["x"]
    for s in range(S):
        h = torch.tanh(h @ d["w"][s] + d["b"][s])
    loss = torch.mean((torch.einsum("mbd,d->mb", h, d["v"]) - d["y"]) ** 2)
    loss.backward()
    return float(loss), {k: d[k].grad.numpy() for k in ("w", "b", "v")}


def _reference_sequential():
    j = {k: jnp.asarray(v) for k, v in _data().items()}

    def loss(w, b, v):
        h = j["x"]
        for s in range(S):
            h = jnp.tanh(h @ w[s] + b[s])
        return jnp.mean((jnp.einsum("mbd,d->mb", h, v) - j["y"]) ** 2)

    value, grads = jax.value_and_grad(loss, argnums=(0, 1, 2))(j["w"], j["b"], j["v"])
    return float(value), dict(zip(("w", "b", "v"), (np.asarray(g) for g in grads)))


def test_every_stage_returns_the_sequential_loss(ranks):
    want, _ = _sequential()
    jwant, _ = _reference_sequential()
    for out in ranks:
        assert out["loss"] == ranks[0]["loss"]
        np.testing.assert_allclose(out["loss"], want, rtol=1e-5)
        np.testing.assert_allclose(out["loss"], jwant, rtol=1e-5)


@pytest.mark.parametrize("leaf", ["w", "b", "v"])
def test_gradients_match_the_sequential_loss(ranks, leaf):
    _, grads = _sequential()
    _, jgrads = _reference_sequential()
    for out in ranks:
        np.testing.assert_allclose(out["grads"][leaf], grads[leaf], rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(out["grads"][leaf], jgrads[leaf], rtol=1e-5, atol=1e-6)
