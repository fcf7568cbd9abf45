"""Training entry point: real steps on one device (the card by default) or a
(data, model) mesh of ranks, with checkpoint and restart, a NaN guard, a
heartbeat and a metrics log (the port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/run1 --device cpu
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch qwen3-1.7b --smoke --steps 5 --mesh 2x2 --device cpu

Takes the reference's flags plus ``--device``.  Weights are a random init
from ``torch.Generator(device).manual_seed(seed)`` in float32; batches come
from ``SyntheticLM`` (the reference's batches, bit for bit).  A run with a
checkpoint directory resumes from its latest checkpoint.  A non-finite loss
returns 3, so a supervisor restarts from the last good checkpoint.  The
metrics log has one JSON line a step: ``step``, ``loss`` and ``step_ms``
(host clock around the step, the loss read back included).

``--mesh DxM`` of more than one rank needs an initialised
``torch.distributed`` world of D·M ranks: torchrun's environment (then the
group is made here: NCCL for the card, gloo for the CPU) or a group the
caller made.  Every rank draws the same weights and batches; the weights
are placed by ``validated_pspec_tree`` as DTensors, and the step runs under
``sharding.use_mesh``.  Rank 0 prints, writes the metrics and the
heartbeat; a checkpoint is gathered by every rank and written by rank 0.
A mesh of one rank is the plain one-device path.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
import os
import time

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..checkpoint.checkpoint import Checkpointer
from ..configs import ARCH_IDS, get_config, get_smoke
from ..core.provisioner import (DeviceGrant, grant_to_mesh, init_world_from_env, lead_rank,
                                world_size)
from ..core.types import as_device
from ..data.pipeline import SyntheticLM
from ..models import get_api
from ..models.params import init_params, shard_params, validated_pspec_tree
from ..sharding import use_mesh
from ..train.optimizer import AdamW
from ..train.train_step import batch_to_device, init_train_state, make_train_step


def build_mesh(spec: str | None, device: torch.device) -> DeviceMesh:
    """The (data, model) mesh ``spec`` ("DxM") asks for, or every rank of
    the world on the data axis.  More than one rank needs an initialised
    world of exactly that many ranks (torchrun's is made here)."""
    init_world_from_env(device)
    if spec:
        d, m = (int(x) for x in spec.split("x"))
    else:
        d, m = world_size(), 1
    if d * m == 1:
        return grant_to_mesh(DeviceGrant("train", "local", 1), device=device)
    if world_size() != d * m:
        raise RuntimeError(f"a {d}x{m} mesh needs a torch.distributed world of {d * m} ranks, "
                           f"found {world_size()}: run under torchrun --nproc-per-node "
                           f"{d * m}, or initialise the process group first")
    return DeviceMesh(device.type, torch.arange(d * m).reshape(d, m),
                      mesh_dim_names=("data", "model"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default=None, help="DxM, e.g. 4x2")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--heartbeat", default=None, help="file touched every step")
    ap.add_argument("--metrics", default=None, help="metrics jsonl path")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fault-step", type=int, default=int(os.environ.get("FAULT_STEP", -1)),
                    help="inject a crash at this step (fault-tolerance tests)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = as_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    api = get_api(cfg)
    mesh = build_mesh(args.mesh, dev)
    lead = lead_rank()
    say = functools.partial(print, flush=True) if lead else (lambda *a, **k: None)
    opt = AdamW(lr=args.lr)
    step_fn = make_train_step(cfg, opt, grad_accum=args.grad_accum, compress=args.compress)
    pipe = SyntheticLM(cfg, args.batch, args.seq, seed=args.seed)

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    with use_mesh(mesh):
        params = init_params(torch.Generator(device=dev).manual_seed(args.seed), api.decls(cfg),
                             torch.float32, dev)
        params = shard_params(params, mesh, validated_pspec_tree(api.decls(cfg), mesh))
        state = init_train_state(cfg, opt, params, compress=args.compress)
        if ckpt is not None and ckpt.latest_step() is not None:
            restored, manifest = ckpt.restore_latest({"params": params, "state": state})
            params, state = restored["params"], restored["state"]
            start_step = manifest["step"] + 1
            say(f"[train] resumed from step {manifest['step']}")

        t0 = time.time()
        log = args.metrics if args.metrics and lead else os.devnull
        with open(log, "a") as mfile:
            for step in range(start_step, args.steps):
                if step == args.fault_step:
                    raise RuntimeError(f"injected fault at step {step}")
                t_step = time.perf_counter()
                batch = batch_to_device(pipe(step), cfg, dev)
                params, state, metrics = step_fn(params, state, batch)
                loss = float(metrics["loss"])
                step_ms = (time.perf_counter() - t_step) * 1e3
                if not math.isfinite(loss):
                    # NaN guard: exit non-zero so the supervisor restarts from
                    # the last good checkpoint (and skips this data window).
                    say(f"[train] NaN/Inf loss at step {step} — aborting for restart")
                    return 3
                if args.heartbeat and lead:
                    with open(args.heartbeat, "w") as f:
                        f.write(str(step))
                mfile.write(json.dumps({"step": step, "loss": loss, "step_ms": step_ms}) + "\n")
                mfile.flush()
                if step % 10 == 0 or step == args.steps - 1:
                    dt = time.time() - t0
                    say(f"[train] step {step} loss {loss:.4f} ({dt:.1f}s)")
                if ckpt is not None and (step % args.ckpt_every == 0 or step == args.steps - 1):
                    ckpt.save(step, {"params": params, "state": state})
    if ckpt is not None:
        ckpt.wait()
    say("[train] done")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
