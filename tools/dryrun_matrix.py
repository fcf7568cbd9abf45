"""The port's whole dry-run matrix (``repro_torch.launch.dryrun --all``) on
the 16×16 mesh of a fake 256-rank world, one ``dryrun --arch`` process an
arch, several at a time, then the report's tables.

    PYTHONPATH=src python tools/dryrun_matrix.py [--device cuda|cpu] [--jobs N]
        [--out-dir DIR] [ARCH ...]

Each process runs every shape of its arch (``long_500k`` skips the
full-attention archs) and writes its records to ``--out-dir`` (default
``experiments/dryrun_torch``).  Prints each process's ``[OK]`` / ``[SKIP]``
/ ``[FAIL]`` lines with its wall, the ``dryrun_table`` and ``roofline_table``
of the records, and last one JSON line: the ok / skip / fail counts, each
arch's wall and the whole wall.  Exits 1 if a cell failed.  ``--device
cuda`` (the default) needs a visible GPU: on a ``cpu`` mesh the fake backend
runs an all-to-all as an all-gather and a chunk, so the MoE cells count their
collectives on ``cuda``.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.roofline import report  # noqa: E402

TIMEOUT_S = 3000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("archs", nargs="*", default=ARCH_IDS)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--jobs", type=int, default=min(os.cpu_count() or 1, len(ARCH_IDS)))
    ap.add_argument("--out-dir", default=str(ROOT / "experiments" / "dryrun_torch"))
    args = ap.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    t0 = time.perf_counter()
    pending, running, walls, lines = list(args.archs), {}, {}, {}
    while pending or running:
        while pending and len(running) < args.jobs:
            arch = pending.pop(0)
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                   "--device", args.device, "--out-dir", args.out_dir]
            running[arch] = (subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                                              stderr=subprocess.STDOUT, text=True),
                             time.perf_counter())
        time.sleep(0.5)
        for arch, (proc, start) in list(running.items()):
            if proc.poll() is None and time.perf_counter() - start < TIMEOUT_S:
                continue
            if proc.poll() is None:
                proc.kill()
            out = proc.communicate()[0]
            walls[arch] = time.perf_counter() - start
            lines[arch] = [x for x in out.splitlines()
                           if x.startswith(("[OK]", "[SKIP]", "[FAIL]"))]
            for x in lines[arch]:
                print(x, flush=True)
            print(f"{arch}: rc {proc.returncode}, {walls[arch]:.1f} s", flush=True)
            if proc.returncode and not any(x.startswith("[FAIL]") for x in lines[arch]):
                print(out[-3000:], flush=True)
            del running[arch]
    recs = [r for r in report.load(args.out_dir) if r["arch"] in args.archs]
    print("\n### Dry-run matrix\n")
    print(report.dryrun_table(recs))
    print("\n### Roofline (single-pod 16x16, H100 constants, counted at full depth)\n")
    print(report.roofline_table(recs))
    counts = {s: sum(r["status"] == s for r in recs) for s in ("ok", "skip", "fail")}
    counts["missing"] = 4 * len(args.archs) - len(recs)  # cells a killed process never wrote
    print(json.dumps({**counts, "device": args.device, "jobs": args.jobs,
                      "arch_wall_s": walls, "wall_s": time.perf_counter() - t0}), flush=True)
    return 0 if counts["fail"] == counts["missing"] == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
