"""Elastic restore (``repro_torch.checkpoint.elastic``) across meshes on a
spawned 4-rank gloo world (one spawn a module, a FileStore rendezvous).

``launch.train --mesh 2x2`` trains the qwen3 smoke config one step and
checkpoints it (gathered by every rank, written by rank 0).  The same world
then restores that train state with ``elastic_restore`` onto 1×4 and 4×1,
and moves the 2×2 parameters onto 1×4 with ``reshard`` (through the whole
arrays, as across meshes); the parent restores it onto one rank (1×1).
Every restored parameter and moment equals the checkpoint's bit for bit on
every mesh.  The next step's loss on each mesh is held to the one-rank
next step's at float32 rtol 1e-5 (``tests/test_torch_train.py``'s loss
tolerance: the same float32 sums in other orders).
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

from repro_torch.checkpoint.checkpoint import Checkpointer  # noqa: E402
from repro_torch.checkpoint.elastic import elastic_restore  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.provisioner import DeviceGrant, grant_to_mesh  # noqa: E402
from repro_torch.data.pipeline import SyntheticLM  # noqa: E402
from repro_torch.models import get_api  # noqa: E402
from repro_torch.models.params import init_params, tree_leaves  # noqa: E402
from repro_torch.train.optimizer import AdamW  # noqa: E402
from repro_torch.train.train_step import (batch_to_device, init_train_state,  # noqa: E402
                                          make_train_step)

SRC = Path(__file__).resolve().parents[1] / "src"
SPAWN_TIMEOUT_S = 150
ARCH, SEED, BATCH, SEQ, LR = "qwen3-1.7b", 0, 4, 16, 3e-4  # launch.train's defaults
TRAIN = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "1", "--batch", str(BATCH),
         "--seq", str(SEQ), "--seed", str(SEED), "--lr", str(LR)]

WORKER = r"""
import pickle, sys
import numpy as np, torch
torch.set_num_threads(1)
import torch.distributed as dist
rank, tmp = int(sys.argv[1]), sys.argv[2]
dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=4, rank=rank)
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.checkpoint.elastic import elastic_restore, param_shardings, reshard
from repro_torch.configs import get_smoke
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train
from repro_torch.models import get_api
from repro_torch.models.params import init_params, shard_params, tree_map, validated_pspec_tree
from repro_torch.sharding import use_mesh
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import batch_to_device, init_train_state, make_train_step

job = pickle.load(open(f"{tmp}/job.pkl", "rb"))
assert train.main(job["train"] + ["--mesh", "2x2", "--ckpt-dir", f"{tmp}/ck"]) == 0
cfg = get_smoke(job["arch"])
api = get_api(cfg)
opt = AdamW(lr=job["lr"])


def whole(t):  # a copy: the step below updates the tensors in place
    return (t.full_tensor() if isinstance(t, DTensor) else t).numpy().copy()


def mesh_of(shape):
    return DeviceMesh("cpu", torch.arange(4).reshape(shape), mesh_dim_names=("data", "model"))


def fresh_state(mesh):
    params = init_params(torch.Generator().manual_seed(99), api.decls(cfg), torch.float32, "cpu")
    params = shard_params(params, mesh, validated_pspec_tree(api.decls(cfg), mesh))
    return {"params": params, "state": init_train_state(cfg, opt, params)}


out = {}
batch = batch_to_device(SyntheticLM(cfg, job["batch"], job["seq"], seed=job["seed"])(1), cfg, "cpu")
for shape in [(1, 4), (4, 1)]:
    mesh = mesh_of(shape)
    with use_mesh(mesh):
        tree, manifest = elastic_restore(Checkpointer(f"{tmp}/ck"), cfg, mesh, fresh_state(mesh))
        layout = {k: [type(p).__name__ + str(getattr(p, "dim", "")) for p in v.placements]
                  for k, v in tree["params"]["layers"]["attn"].items()}
        restored = tree_map(whole, tree)
        _, _, m = make_train_step(cfg, opt)(tree["params"], tree["state"], batch)
        out[shape] = {"tree": restored, "step": manifest["step"], "loss": float(m["loss"]),
                      "layout": layout}
old = mesh_of((2, 2))
with use_mesh(old):
    saved = elastic_restore(Checkpointer(f"{tmp}/ck"), cfg, old, fresh_state(old))[0]["params"]
new = mesh_of((1, 4))
with use_mesh(new):
    out["reshard"] = tree_map(whole, reshard(saved, param_shardings(cfg, new)))
pickle.dump(out, open(f"{tmp}/rank{rank}.pkl", "wb"))
dist.barrier()
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    with open(tmp / "job.pkl", "wb") as f:
        pickle.dump({"train": TRAIN, "arch": ARCH, "lr": LR, "batch": BATCH, "seq": SEQ,
                     "seed": SEED}, f)
    env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(tmp)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(4)]
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
    return tmp, [pickle.load(open(tmp / f"rank{r}.pkl", "rb")) for r in range(4)]


def _saved(tmp):
    with np.load(tmp / "ck" / "ckpt_00000000" / "arrays.npz") as data:
        return {k: data[k] for k in data.files}


def _one_rank(tmp):
    """The checkpoint restored onto a one-rank mesh, and its next step."""
    cfg = get_smoke(ARCH)
    api = get_api(cfg)
    opt = AdamW(lr=LR)
    mesh = grant_to_mesh(DeviceGrant("job", "c", 1), device="cpu")
    params = init_params(torch.Generator().manual_seed(99), api.decls(cfg), torch.float32, "cpu")
    target = {"params": params, "state": init_train_state(cfg, opt, params)}
    tree, manifest = elastic_restore(Checkpointer(str(tmp / "ck")), cfg, mesh, target)
    batch = batch_to_device(SyntheticLM(cfg, BATCH, SEQ, seed=SEED)(1), cfg, "cpu")
    leaves = [t.numpy().copy() for t in tree_leaves(tree)]
    _, _, m = make_train_step(cfg, opt)(tree["params"], tree["state"], batch)
    return leaves, float(m["loss"])


def _ordered(saved):
    """The checkpoint's arrays in the tree's leaf order (sorted keys)."""
    return [saved[k] for k in sorted(saved)]


@pytest.mark.parametrize("shape", [(1, 4), (4, 1)], ids=["1x4", "4x1"])
def test_restore_across_meshes_is_bit_for_bit(world, shape):
    tmp, outs = world
    want = _ordered(_saved(tmp))
    for out in outs:
        assert out[shape]["step"] == 0
        got = tree_leaves(out[shape]["tree"])
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and np.array_equal(g, w)


def test_restored_layout_follows_the_new_mesh(world):
    _, outs = world
    assert outs[0][(1, 4)]["layout"]["wq"] == ["Replicate", "Shard2"]  # heads on model
    assert outs[0][(1, 4)]["layout"]["wk"] == ["Replicate", "Replicate"]  # 2 kv heads
    assert outs[0][(4, 1)]["layout"]["wq"] == ["Replicate", "Replicate"]


def test_restore_onto_one_rank_is_bit_for_bit_and_steps_on(world):
    tmp, outs = world
    leaves, loss = _one_rank(tmp)
    for g, w in zip(leaves, _ordered(_saved(tmp))):
        assert np.array_equal(g, w)
    for shape in [(1, 4), (4, 1)]:
        for out in outs:
            np.testing.assert_allclose(out[shape]["loss"], loss, rtol=1e-5)


def test_reshard_across_meshes_keeps_every_bit(world):
    tmp, outs = world
    saved = _saved(tmp)
    want = [saved[k] for k in sorted(saved) if k.startswith("params/")]
    for out in outs:
        for g, w in zip(tree_leaves(out["reshard"]), want):
            assert np.array_equal(g, w)
