#!/usr/bin/env python3
"""Kill and resume one of the hybrid, audio and VLM families at full width on
the card, through full-size checkpoints.

    python3 tools/zoo_resume.py --arch recurrentgemma-2b

Trains ``--arch`` at ``chip_smoke.ZOO_TRAIN``'s depth, batch and sequence
through ``launch/train`` for 3 steps, then again with a checkpoint at step 0
killed by ``--fault-step 2``, then resumed from it and stopped by
``--fault-step 3`` (``chip_smoke.killed_and_resumed``), under
``torch.use_deterministic_algorithms(True)``; every killed and resumed loss
must equal the uninterrupted run's bit for bit.  Prints the card's
``name, power.limit`` and one JSON line: the losses, the killed and resumed
runs' walls (checkpoint write and restore included) and the peak memory of
the restore.  One checkpoint is 9.1 GB (whisper-medium) to 35.7 GB
(pixtral-12b at 6 layers), so on a machine whose disk takes less than the
three together, run one arch at a time.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before cuBLAS starts
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(chip_smoke.ZOO_TRAIN), required=True)
    args = ap.parse_args(argv)

    import torch

    from repro_torch.launch import train

    if not torch.cuda.is_available():
        print("zoo_resume: no CUDA device is visible", file=sys.stderr)
        return 2
    torch.use_deterministic_algorithms(True)
    torch.backends.cuda.matmul.allow_tf32 = False
    layers, batch, seq = chip_smoke.ZOO_TRAIN[args.arch]
    cfg = train.get_config(args.arch)
    if layers:
        cfg = cfg.replace(num_layers=layers)
    train.get_config = lambda a: cfg
    base = ["--arch", args.arch, "--steps", "3", "--batch", str(batch), "--seq", str(seq),
            "--seed", "0", "--device", "cuda"]
    with tempfile.TemporaryDirectory() as d:
        rc, _ = chip_smoke.captured(train.main, base + ["--metrics", f"{d}/plain.jsonl"])
        chip_smoke.check(rc == 0, f"launch/train returned {rc}")
        losses = [m["loss"] for m in chip_smoke.train_losses(f"{d}/plain.jsonl")]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        killed, resumed = chip_smoke.killed_and_resumed(train, base, d, args.arch)
        wall_s = time.perf_counter() - t0
        ckpt_gb = sum(f.stat().st_size for f in Path(d, "ckpt").rglob("*")) / 1e9
    chip_smoke.check([m["step"] for m in killed] == [0, 1]
                     and [m["step"] for m in resumed] == [1, 2],
                     f"killed {killed}, resumed {resumed}")
    for m in killed + resumed:
        chip_smoke.check(m["loss"] == losses[m["step"]],
                         f"step {m['step']}: {m['loss']} against {losses[m['step']]}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    print(json.dumps({"arch": args.arch, "layers": cfg.num_layers, "batch": [batch, seq],
                      "losses": losses, "killed": [m["loss"] for m in killed],
                      "resumed": [m["loss"] for m in resumed], "checkpoint_gb": ckpt_gb,
                      "killed_and_resumed_s": wall_s,
                      "peak_gb": torch.cuda.max_memory_allocated() / 1e9}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
