"""Batched serving demo on the PyTorch port (the twin of
``examples/serve_demo.py``): market-priced capacity → prefill + decode loop.

The serving fleet buys capacity on the market like any other team; the grant
sets the max concurrent batch.  Generation is one chunked prefill of the
prompts, then greedy or temperature decode token by token.

    PYTHONPATH=src python examples/serve_demo_torch.py [--batch 4] [--new 24] [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.core.types import as_device
from repro_torch.models import get_api
from repro_torch.models.params import init_params
from repro_torch.serve.decode import generate, make_serve_steps


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = as_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products stay float32
    cfg = get_smoke(args.arch)
    api = get_api(cfg)
    params = init_params(torch.Generator(device=dev).manual_seed(0), api.decls(cfg),
                         torch.float32, dev)

    prefill, _ = make_serve_steps(cfg)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(1))

    # prefill logits for the whole batch of requests
    t0 = time.time()
    with torch.inference_mode():
        logits = prefill(params, {"tokens": prompt})
    _sync(dev)
    print(
        f"[serve] prefill {args.batch}×{args.prompt_len}: {time.time()-t0:.2f}s "
        f"logits {tuple(logits.shape)}"
    )

    # full generation loop: one chunked prefill, then a step a token
    t0 = time.time()
    out = generate(params, cfg, prompt, max_new=args.new, temperature=args.temperature)
    _sync(dev)
    dt = time.time() - t0
    toks = args.batch * args.new
    print(f"[serve] generated {toks} tokens in {dt:.2f}s ({toks/dt:.1f} tok/s on this host)")
    print(f"[serve] sample continuation ids: {np.asarray(out[0, args.prompt_len:].cpu())}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
