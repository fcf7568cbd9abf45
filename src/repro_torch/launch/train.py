"""Training entry point: real steps on one device (the card by default), with
checkpoint and restart, a NaN guard, a heartbeat and a metrics log (the port
of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
        --steps 50 --batch 8 --seq 128 --ckpt-dir /tmp/run1 --device cpu

Takes the reference's flags plus ``--device``.  Weights are a random init
from ``torch.Generator(device).manual_seed(seed)`` in float32; batches come
from ``SyntheticLM`` (the reference's batches, bit for bit).  A run with a
checkpoint directory resumes from its latest checkpoint.  A non-finite loss
returns 3, so a supervisor restarts from the last good checkpoint.  The
metrics log has one JSON line a step: ``step``, ``loss`` and ``step_ms``
(host clock around the step, the loss read back included).  Training runs
on one rank: a mesh of more than one device raises ``NotImplementedError``
(ROADMAP queue 1, 'Sharding').
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time

import torch

from ..checkpoint.checkpoint import Checkpointer
from ..configs import ARCH_IDS, get_config, get_smoke
from ..core.provisioner import DeviceGrant, grant_to_mesh, world_size
from ..core.types import as_device
from ..data.pipeline import SyntheticLM
from ..models import get_api
from ..models.config import SHARDING_ITEM, not_ported
from ..models.params import init_params
from ..train.optimizer import AdamW
from ..train.train_step import batch_to_device, init_train_state, make_train_step


def build_mesh(spec: str | None, device: torch.device):
    """The (data, model) mesh ``spec`` ("DxM") asks for, or every rank on
    the data axis; more than one device raises."""
    if spec:
        d, m = (int(x) for x in spec.split("x"))
    else:
        d, m = world_size(), 1
    if d * m > 1:
        raise not_ported(f"training on a {d}x{m} mesh", SHARDING_ITEM)
    return grant_to_mesh(DeviceGrant("train", "local", 1), device=device)


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
    build_mesh(args.mesh, dev)
    opt = AdamW(lr=args.lr)
    step_fn = make_train_step(cfg, opt, grad_accum=args.grad_accum, compress=args.compress)
    pipe = SyntheticLM(cfg, args.batch, args.seq, seed=args.seed)

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    start_step = 0
    params = init_params(torch.Generator(device=dev).manual_seed(args.seed), api.decls(cfg),
                         torch.float32, dev)
    state = init_train_state(cfg, opt, params, compress=args.compress)
    if ckpt is not None and ckpt.latest_step() is not None:
        restored, manifest = ckpt.restore_latest({"params": params, "state": state})
        params, state = restored["params"], restored["state"]
        start_step = manifest["step"] + 1
        print(f"[train] resumed from step {manifest['step']}", flush=True)

    t0 = time.time()
    with open(args.metrics, "a") if args.metrics else open(os.devnull, "w") as mfile:
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
                print(f"[train] NaN/Inf loss at step {step} — aborting for restart", flush=True)
                return 3
            if args.heartbeat:
                with open(args.heartbeat, "w") as f:
                    f.write(str(step))
            mfile.write(json.dumps({"step": step, "loss": loss, "step_ms": step_ms}) + "\n")
            mfile.flush()
            if step % 10 == 0 or step == args.steps - 1:
                dt = time.time() - t0
                print(f"[train] step {step} loss {loss:.4f} ({dt:.1f}s)", flush=True)
            if ckpt is not None and (step % args.ckpt_every == 0 or step == args.steps - 1):
                ckpt.save(step, {"params": params, "state": state})
    if ckpt is not None:
        ckpt.wait()
    print("[train] done", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
