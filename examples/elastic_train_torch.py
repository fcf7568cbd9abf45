"""End-to-end example on the PyTorch port: market-provisioned, elastic,
fault-tolerant training (the twin of ``examples/elastic_train.py``).

The full stack in one script:
  1. an auction epoch prices two clusters and grants chips to a training job
     (each clock round one ``bid_eval`` launch on the card);
  2. the job builds its mesh from the grant and trains, checkpointing;
  3. mid-run, a *second* auction epoch (congestion changed) re-provisions the
     job to a different grant; the job elastically re-shards from its
     checkpoint onto the new mesh and keeps training;
  4. the in-memory state is dropped first (a node failure), so that restore
     is the supervisor-style one.

A mesh spans the ranks of the ``torch.distributed`` world (one rank without
one; torchrun's world is joined here): the weights are DTensors laid out by
``validated_pspec_tree``, checkpoints are gathered and written by rank 0 into
a directory rank 0 picks, and ``checkpoint.elastic.elastic_restore`` places
the state on the new mesh.  Rank 0 prints.  The default is a CPU-sized
model for a quick demo; ``--production`` switches to a ~100M-parameter
model × 300 steps.

    PYTHONPATH=src python examples/elastic_train_torch.py [--production] [--device cpu]
    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        examples/elastic_train_torch.py --device cpu
"""
import argparse
import tempfile
import time

import numpy as np
import torch

import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import Checkpointer
from repro_torch.checkpoint.elastic import elastic_restore
from repro_torch.configs import get_smoke
from repro_torch.core import (
    ClockConfig, ResourcePool, clock_auction, operator_supply_bids,
    pack_bids, reserve_prices,
)
from repro_torch.core.provisioner import (grants_from_allocation, grant_to_mesh,
                                          init_world_from_env, lead_rank, world_size)
from repro_torch.core.types import as_device
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import ModelConfig, get_api
from repro_torch.models.params import (count_params, init_params, shard_params,
                                       validated_pspec_tree)
from repro_torch.sharding import use_mesh
from repro_torch.train.optimizer import AdamW
from repro_torch.train.train_step import init_train_state, make_train_step

MODEL_100M = ModelConfig(
    name="repro-100m", family="dense", num_layers=12, d_model=512,
    num_heads=8, num_kv_heads=8, d_ff=2048, vocab_size=49152,
    qk_norm=True, act_dtype="float32",
)


def run_auction(util_east: float, job_chips: int, device: torch.device, say=print):
    """One provisioning epoch: returns the job's DeviceGrant."""
    pools = [
        ResourcePool("us-east", "tpu_chips", 10.0, util_east, supply=256),
        ResourcePool("eu-west", "tpu_chips", 10.0, 0.30, supply=256),
    ]
    tilde_p = reserve_prices(pools)
    bl, pis = operator_supply_bids(pools, tilde_p, lots=4)
    user_jobs = [-1] * len(bl)
    bl.append([np.array([job_chips, 0], np.float32), np.array([0, job_chips], np.float32)])
    pis.append(job_chips * 10.0 * 4)
    user_jobs.append(0)
    prob = pack_bids(bl, pis, base_cost=np.array([10.0, 10.0]), device=device)
    start = torch.from_numpy(np.asarray(tilde_p, np.float32)).to(device)
    res = clock_auction(prob, start, ClockConfig())
    grants = grants_from_allocation(
        res, ["train-job"], [p.cluster for p in pools], [p.rtype for p in pools], user_jobs
    )
    if not grants:
        raise RuntimeError("the training job must win at reserve prices")
    g = grants[0]
    say(f"[market] grant: {g.chips} chips in {g.cluster} @ ${g.unit_price:.2f}/chip")
    return g


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--production", action="store_true", help="~100M params × 300 steps")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--batch", type=int, default=None)
    ap.add_argument("--seq", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = as_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32
    init_world_from_env(dev)
    lead = lead_rank()
    say = print if lead else (lambda *a, **k: None)
    cfg = MODEL_100M if args.production else get_smoke("qwen3-1.7b")
    steps = args.steps or (300 if args.production else 40)
    batch = args.batch or (8 if args.production else 4)
    seq = args.seq or (256 if args.production else 64)
    api = get_api(cfg)
    n = count_params(api.decls(cfg))
    say(f"[job] model {cfg.name}: {n/1e6:.1f}M params, {steps} steps, batch {batch} × seq {seq}")

    ckdir = [tempfile.mkdtemp(prefix="elastic_train_") if lead else None]
    if world_size() > 1:  # one directory for every rank: rank 0's
        dist.broadcast_object_list(ckdir, src=0)
    ck = Checkpointer(ckdir[0])
    opt = AdamW(lr=1e-3)
    step_fn = make_train_step(cfg, opt)
    pipe = SyntheticLM(cfg, batch, seq, seed=0)

    def batch_at(step):
        return {k: torch.from_numpy(v).to(dev) for k, v in pipe(step).items()}

    # ---- epoch 1: us-east congested → market sends the job to eu-west ------
    grant = run_auction(util_east=0.93, job_chips=128, device=dev, say=say)
    mesh = grant_to_mesh(grant, device=dev)
    say(f"[job] mesh {tuple(mesh.shape)} over {world_size()} rank(s)")
    phase_1_end = steps // 2
    with use_mesh(mesh):
        params = init_params(torch.Generator(device=dev).manual_seed(0), api.decls(cfg),
                             torch.float32, dev)
        params = shard_params(params, mesh, validated_pspec_tree(api.decls(cfg), mesh))
        state = init_train_state(cfg, opt, params)
        t0 = time.time()
        for step in range(phase_1_end):
            params, state, m = step_fn(params, state, batch_at(step))
            if step % 10 == 0:
                say(f"[train/{grant.cluster}] step {step} loss {float(m['loss']):.4f}")
            if step % 10 == 0:
                ck.save(step, {"params": params, "state": state})
        ck.save(phase_1_end - 1, {"params": params, "state": state}, block=True)
        say(f"[train] phase 1 done in {time.time()-t0:.1f}s")

    # ---- epoch 2: congestion flipped → re-provisioned; elastic reshard -----
    grant2 = run_auction(util_east=0.20, job_chips=64, device=dev, say=say)
    mesh2 = grant_to_mesh(grant2, device=dev)
    with use_mesh(mesh2):
        # simulate loss of the in-memory state (node failure) → restore
        restored, manifest = elastic_restore(ck, cfg, mesh2, {"params": params, "state": state})
        params, state = restored["params"], restored["state"]
        start = manifest["step"] + 1
        say(
            f"[elastic] resumed step {start} on new grant "
            f"({grant2.chips} chips in {grant2.cluster})"
        )
        say(f"[job] mesh {tuple(mesh2.shape)} over {world_size()} rank(s)")
        for step in range(start, steps):
            params, state, m = step_fn(params, state, batch_at(step))
            if step % 10 == 0 or step == steps - 1:
                say(f"[train/{grant2.cluster}] step {step} loss {float(m['loss']):.4f}")
        ck.save(steps - 1, {"params": params, "state": state}, block=True)
    say(f"[done] final loss {float(m['loss']):.4f}; checkpoints in {ckdir[0]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
