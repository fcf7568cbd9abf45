"""The port's supervisor (``repro_torch.launch.supervisor``) on the CPU: the
three supervisor tests of ``tests/test_checkpoint.py`` against the port.

* a crash injected at step 6 (``FAULT_STEP``): the supervisor restarts the
  port's trainer, which resumes from its checkpoint and finishes 12 steps;
  the losses of every step equal an uninterrupted run's bit for bit (one
  process and device, the same float32 arithmetic);
* a hung trainer (its heartbeat stale, the process alive) is killed and
  restarted, and the private heartbeat directory is removed;
* a trainer that always hangs: the supervisor gives up after
  ``max_restarts`` and cleans up.

The hang stubs write their heartbeat before anything else, and the
deadlines are several seconds (5 and 3), not the reference's 2 and 1:
``tests/test_checkpoint.py``'s hang test with ``deadline_s=2.0`` under six
test workers failed once (ROADMAP queue 3).  As in the reference, only the
end-to-end trainer test is marked slow.
"""
import json
import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the trainers run in subprocesses; this process only supervises

from repro_torch.launch.supervisor import run_supervised  # noqa: E402

TRAIN = ["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--steps", "12", "--batch", "2",
         "--seq", "32"]


def _losses(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.slow
def test_supervisor_restarts_after_injected_fault(tmp_path, monkeypatch):
    """End-to-end fault tolerance: crash at step 6, restart, finish 12 steps,
    each step's loss the uninterrupted run's."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = run_supervised(TRAIN + ["--metrics", str(tmp_path / "plain.jsonl")],
                        ckpt_dir=str(tmp_path / "plain_ck"), max_restarts=0, deadline_s=600)
    assert rc == 0
    plain = {m["step"]: m["loss"] for m in _losses(tmp_path / "plain.jsonl")}
    assert sorted(plain) == list(range(12))

    monkeypatch.setenv("FAULT_STEP", "6")
    rc = run_supervised(TRAIN + ["--ckpt-every", "2", "--metrics", str(tmp_path / "m.jsonl")],
                        ckpt_dir=str(tmp_path / "ck"), max_restarts=2, deadline_s=600)
    assert rc == 0 and "FAULT_STEP" not in os.environ
    runs = _losses(tmp_path / "m.jsonl")
    steps = [m["step"] for m in runs]
    # resumed from step 4's checkpoint (or step 2's, had the crash beaten its writer)
    assert steps[:6] == list(range(6)) and steps[6:] == list(range(steps[6], 12))
    assert steps[6] in (3, 5)
    assert all(m["loss"] == plain[m["step"]] for m in runs)


_HANG_TRAINER = '''
"""Stub trainer: beats once, hangs on attempt 1, exits clean on attempt 2."""
import argparse, os, sys, time

ap = argparse.ArgumentParser()
ap.add_argument("--ckpt-dir")
ap.add_argument("--heartbeat")
args, _ = ap.parse_known_args()
with open(args.heartbeat, "w") as f:
    f.write("beat")
os.makedirs(args.ckpt_dir, exist_ok=True)
marker = os.path.join(args.ckpt_dir, "attempted")
if os.path.exists(marker):
    sys.exit(0)  # the restarted attempt finishes cleanly
with open(marker, "w") as f:
    f.write("1")
while True:
    time.sleep(60)  # hang: the heartbeat above is the last one ever written
'''


def _temp_hb_dirs():
    import glob
    import tempfile

    return set(glob.glob(os.path.join(tempfile.gettempdir(), "repro_torch_hb_*")))


def test_supervisor_restarts_on_hang_and_cleans_heartbeat(tmp_path, monkeypatch):
    """A hung trainer (stale heartbeat, process alive) is killed and
    restarted, and the heartbeat directory is removed afterwards."""
    (tmp_path / "hang_trainer.py").write_text(_HANG_TRAINER)
    monkeypatch.setenv("PYTHONPATH",
                       str(tmp_path) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    before = _temp_hb_dirs()
    rc = run_supervised([], ckpt_dir=str(tmp_path / "ck"), max_restarts=2, deadline_s=5.0,
                        poll_s=0.2, module="hang_trainer")
    assert rc == 0  # hang detected -> killed -> restart finished cleanly
    assert (tmp_path / "ck" / "attempted").exists()
    assert _temp_hb_dirs() <= before  # no leaked heartbeat directories


def test_supervisor_gives_up_after_max_restarts_and_cleans_up(tmp_path, monkeypatch):
    (tmp_path / "always_hang.py").write_text(_HANG_TRAINER.replace("sys.exit(0)", "pass"))
    monkeypatch.setenv("PYTHONPATH",
                       str(tmp_path) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    before = _temp_hb_dirs()
    rc = run_supervised([], ckpt_dir=str(tmp_path / "ck"), max_restarts=1, deadline_s=3.0,
                        poll_s=0.2, module="always_hang")
    assert rc == 1
    assert _temp_hb_dirs() <= before


def test_a_restart_is_not_judged_by_the_killed_attempts_heartbeat(tmp_path, monkeypatch):
    """The restarted attempt beats only after 1 s, five polls in: the killed
    attempt's stale heartbeat is gone by then, so it is not killed too."""
    slow_start = _HANG_TRAINER.replace(
        'args, _ = ap.parse_known_args()\n',
        'args, _ = ap.parse_known_args()\n'
        'if os.path.exists(os.path.join(args.ckpt_dir, "attempted")):\n'
        '    time.sleep(1.0)\n')
    (tmp_path / "slow_restart.py").write_text(slow_start)
    monkeypatch.setenv("PYTHONPATH",
                       str(tmp_path) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    rc = run_supervised([], ckpt_dir=str(tmp_path / "ck"), max_restarts=1, deadline_s=3.0,
                        poll_s=0.2, module="slow_restart")
    assert rc == 0
