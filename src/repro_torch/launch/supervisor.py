"""Fault-tolerant supervisor: run the trainer, restart on crash or hang (the
port of ``repro.launch.supervisor``).

Policies, the reference's:
  * crash (non-zero exit, incl. the trainer's NaN-guard code 3) → restart
    from the latest checkpoint, up to --max-restarts;
  * hang/straggler (heartbeat file older than --deadline seconds) → kill and
    restart;
  * each restart resumes exactly: a checkpoint, a step-pure data pipeline,
    and a train step that repeats itself bit for bit on the card (the
    embedding's and the MoE's scatter-adds in operand order,
    ``kernels/ops.ordered_rows_add``).

    PYTHONPATH=src python -m repro_torch.launch.supervisor --ckpt-dir /tmp/run1 -- \\
        --arch qwen3-1.7b --smoke --steps 100 --device cpu

The trainer is ``python -m repro_torch.launch.train`` in a subprocess, on the
card unless its arguments say ``--device cpu``.  One change from the
reference: a restart first removes the killed attempt's heartbeat.  The
reference keeps it, so the supervisor's first poll of the new attempt
finds a file older than the deadline and kills the attempt unless it has
beaten within one poll.
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time


def run_supervised(
    trainer_args: list[str],
    ckpt_dir: str,
    max_restarts: int = 3,
    deadline_s: float = 300.0,
    poll_s: float = 2.0,
    python: str = sys.executable,
    module: str = "repro_torch.launch.train",
) -> int:
    # the heartbeat lives in a private temp dir removed on every exit path;
    # ``module`` is the trainer entry point (tests substitute a stub that
    # hangs on demand)
    hb_dir = tempfile.mkdtemp(prefix="repro_torch_hb_")
    try:
        return _supervise(
            trainer_args, ckpt_dir, max_restarts, deadline_s, poll_s,
            python, module, os.path.join(hb_dir, "heartbeat"),
        )
    finally:
        shutil.rmtree(hb_dir, ignore_errors=True)


def _supervise(
    trainer_args: list[str],
    ckpt_dir: str,
    max_restarts: int,
    deadline_s: float,
    poll_s: float,
    python: str,
    module: str,
    hb: str,
) -> int:
    restarts = 0
    while True:
        cmd = [
            python, "-m", module,
            "--ckpt-dir", ckpt_dir, "--heartbeat", hb, *trainer_args,
        ]
        print(f"[supervisor] launching (attempt {restarts + 1}): {' '.join(cmd)}", flush=True)
        if os.path.exists(hb):  # the last attempt's beat says nothing of this one
            os.remove(hb)
        env = dict(os.environ)
        proc = subprocess.Popen(cmd, env=env)
        verdict = None
        while verdict is None:
            try:
                rc = proc.wait(timeout=poll_s)
                verdict = ("exit", rc)
            except subprocess.TimeoutExpired:
                if os.path.exists(hb) and time.time() - os.path.getmtime(hb) > deadline_s:
                    print("[supervisor] heartbeat stale — killing straggler", flush=True)
                    proc.kill()
                    proc.wait()
                    verdict = ("hang", None)
        kind, rc = verdict
        if kind == "exit" and rc == 0:
            print("[supervisor] trainer finished cleanly", flush=True)
            return 0
        restarts += 1
        if restarts > max_restarts:
            print(f"[supervisor] giving up after {max_restarts} restarts", flush=True)
            return 1
        print(f"[supervisor] restarting ({kind}, rc={rc})", flush=True)
        # fault injection only fires once: clear it for the retry
        env.pop("FAULT_STEP", None)
        os.environ.pop("FAULT_STEP", None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--deadline", type=float, default=300.0)
    ap.add_argument("trainer_args", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    rest = [a for a in args.trainer_args if a != "--"]
    return run_supervised(rest, args.ckpt_dir, args.max_restarts, args.deadline)


if __name__ == "__main__":
    raise SystemExit(main())
