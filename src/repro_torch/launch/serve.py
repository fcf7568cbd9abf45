"""Serving entry point: batched generation on one device (the card by default)
or a (data, model) mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-7b \\
        --batch 4 --prompt-len 16 --new 32

Weights are a random init from ``--seed`` (float32, as the reference
initialises them); ``--smoke`` takes the arch's small config, and
``--device cpu`` runs on the CPU.  Prints the reference's ``[serve]`` lines
(no prefill line for ``whisper-medium``, whose prefill needs frames).

``--mesh DxM`` takes the world ``launch.train.build_mesh`` takes (torchrun's
or the caller's): the weights are placed by ``validated_pspec_tree`` as
DTensors, every rank draws the same prompt, and decoding runs under
``sharding.use_mesh``, the cache laid out by ``shard_cache_kv`` /
``shard_cache_latent``.  Only rank 0 prints.  A sharded decode step is not
captured in a CUDA graph: its collectives (gloo's above all) cannot be.
"""
from __future__ import annotations

import argparse
import functools
import time

import torch

from ..configs import ARCH_IDS, get_config, get_smoke
from ..core.provisioner import lead_rank
from ..core.types import as_device
from ..models import get_api
from ..models.params import init_params, shard_params, validated_pspec_tree
from ..serve.decode import generate, make_serve_steps, no_grad, sample_token
from ..sharding import use_mesh
from .train import build_mesh


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS, required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default=None, help="DxM, e.g. 4x2")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = as_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    api = get_api(cfg)
    mesh = build_mesh(args.mesh, dev)
    say = functools.partial(print, flush=True) if lead_rank() else (lambda *a, **k: None)
    with use_mesh(mesh):
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = init_params(gen, api.decls(cfg), torch.float32, dev)
        params = shard_params(params, mesh, validated_pspec_tree(api.decls(cfg), mesh))
        prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                               generator=torch.Generator(device=dev).manual_seed(1), device=dev)

        prefill, _ = make_serve_steps(cfg)
        if cfg.family != "audio":  # audio's prefill needs frames, not only tokens
            t0 = time.time()
            with no_grad(params):
                logits = prefill(params, {"tokens": prompt})
            _sync(dev)
            # the prefill's last-position logits are the first generated
            # token's distribution: report it instead of discarding the pass
            nxt = sample_token(logits)[:, 0]  # greedy, plain on every rank
            say(
                f"[serve] prefill {args.batch}x{args.prompt_len}: "
                f"{time.time()-t0:.2f}s logits {tuple(logits.shape)} "
                f"greedy next ids {nxt.tolist()}"
            )

        t0 = time.time()
        out = generate(params, cfg, prompt, max_new=args.new, temperature=args.temperature,
                       seed=args.seed)
        _sync(dev)
    dt = time.time() - t0
    toks = args.batch * args.new
    say(f"[serve] {toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s)")
    say(f"[serve] continuation ids[0]: {out[0, args.prompt_len:].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
