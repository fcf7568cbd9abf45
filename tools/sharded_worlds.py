"""Every family's sharded train steps and greedy decode on spawned gloo
worlds on the CPU, against one rank, with no JAX: for a machine whose torch
differs from the one the tests run on (DTensor's sharding rules change
between releases), such as the card's.

    PYTHONPATH=src python tools/sharded_worlds.py [ARCH ...]

For each (arch, mesh) of ``CASES`` (2×1, 1×2 and 1×4 for every family,
2×2 for qwen3 and deepseek-v3) a world of ``D·M`` ranks (``python`` of this
file with ``--rank``, a FileStore rendezvous, ``CUDA_VISIBLE_DEVICES=""``)
trains the smoke config two AdamW steps with the weights placed by
``validated_pspec_tree``, then decodes 6 greedy tokens, and rank 0 compares
with the same run on one rank.  Four worlds run at a time.  Prints one line
a case: ``OK`` with both runs' losses, the largest parameter difference
after the steps and the share of greedy ids that agree, or ``FAIL`` with the
error's last lines.  Exits 1 if any case failed.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

ARCHS = ["qwen3-1.7b", "deepseek-v3-671b", "kimi-k2-1t-a32b", "rwkv6-7b",
         "recurrentgemma-2b", "whisper-medium", "pixtral-12b"]
CASES = [(a, m) for a in ARCHS for m in [(2, 1), (1, 2), (1, 4)]] + [
    ("qwen3-1.7b", (2, 2)), ("deepseek-v3-671b", (2, 2))]
PARALLEL = 4
TIMEOUT_S = 400


def rank_main(rank: int, world: int, store: str, shape: tuple[int, int], arch: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}/store", world_size=world,
                            rank=rank)
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import DTensor

    from repro_torch.configs import get_smoke
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import get_api
    from repro_torch.models.params import (init_params, shard_params, tree_leaves,
                                           validated_pspec_tree)
    from repro_torch.serve.decode import generate
    from repro_torch.sharding import use_mesh
    from repro_torch.train.optimizer import AdamW
    from repro_torch.train.train_step import batch_to_device, init_train_state, make_train_step

    cfg = get_smoke(arch)
    api = get_api(cfg)
    pipe = SyntheticLM(cfg, 4, 16, seed=0)
    opt = AdamW(lr=1e-3)
    step = make_train_step(cfg, opt)

    def fresh():
        return init_params(torch.Generator().manual_seed(0), api.decls(cfg), torch.float32, "cpu")

    def run(params):
        state = init_train_state(cfg, opt, params)
        losses = []
        for i in range(2):
            params, state, m = step(params, state, batch_to_device(pipe(i), cfg, "cpu"))
            losses.append(float(m["loss"]))
        prompt = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(1))
        return losses, params, generate(params, cfg, prompt, 6)

    out = {}
    try:
        one_losses, one_params, one_ids = run(fresh())
        mesh = DeviceMesh("cpu", torch.arange(world).reshape(shape),
                          mesh_dim_names=("data", "model"))
        with use_mesh(mesh):
            losses, params, ids = run(shard_params(
                fresh(), mesh, validated_pspec_tree(api.decls(cfg), mesh)))
            whole = [p.full_tensor() if isinstance(p, DTensor) else p for p in tree_leaves(params)]
        out = {"ok": True, "losses": losses, "one_rank": one_losses,
               "max_param_diff": max(float((a - b).abs().max())
                                     for a, b in zip(whole, tree_leaves(one_params))),
               "ids_agree": float((ids == one_ids).float().mean())}
    except Exception:  # noqa: BLE001 - the case is reported, not raised
        out = {"ok": False, "error": traceback.format_exc().strip().splitlines()[-4:]}
    if rank == 0:
        print(json.dumps(out), flush=True)
    dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--world", type=int)
    ap.add_argument("--store")
    ap.add_argument("--mesh")
    ap.add_argument("--arch")
    args = ap.parse_args()
    if args.rank is not None:
        rank_main(args.rank, args.world, args.store,
                  tuple(int(x) for x in args.mesh.split("x")), args.arch)
        return 0
    cases = [c for c in CASES if not args.archs or c[0] in args.archs]
    src = str(Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ, PYTHONPATH=src, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    queue, running, failed = list(cases), [], 0
    while queue or running:
        while queue and len(running) < PARALLEL:
            arch, (d, m) = queue.pop(0)
            store = tempfile.mkdtemp()
            procs = [subprocess.Popen(
                [sys.executable, __file__, "--rank", str(r), "--world", str(d * m), "--store",
                 store, "--mesh", f"{d}x{m}", "--arch", arch], env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for r in range(d * m)]
            running.append((f"{arch} {d}x{m}", procs, time.monotonic()))
        for case in list(running):
            name, procs, t0 = case
            if all(p.poll() is not None for p in procs) or time.monotonic() - t0 > TIMEOUT_S:
                for p in procs:
                    p.kill()
                logs = [p.communicate()[0] for p in procs]
                lines = [x for x in logs[0].splitlines() if x.startswith("{")]
                res = json.loads(lines[-1]) if lines else {"ok": False,
                                                           "error": logs[0].splitlines()[-4:]}
                failed += not res["ok"]
                print(name, "OK" if res["ok"] else "FAIL", json.dumps(res), flush=True)
                running.remove(case)
        time.sleep(0.2)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
