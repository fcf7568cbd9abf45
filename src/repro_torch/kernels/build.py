"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` into its own shared library
with a plain C interface (no PyTorch headers, so a build takes seconds), for
``sm_90a`` only::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false \
         -shared -Xcompiler -fPIC -o build/kernels/<hash>/lib<name>.so csrc/<name>.cu

``--fmad=false`` keeps every ``a*b + c`` that the sources do not spell as
``__fmaf_rn`` uncontracted: the proxy evaluators' float results are part of
their contract (see ``ref.py``).  ``wkv6`` has no bitwise contract, only a
float tolerance; it shares the flag so that every source builds one way.  Libraries are cached under ``build/kernels/`` at
the repository root, keyed by a hash of the sources and flags, so a rebuild
happens only when a source changes.  :func:`build_all` starts one ``nvcc``
per source, all at once.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)
SOURCES = ("clock_bid_eval", "sparse_bid_eval", "sparse_bid_eval_csr", "wkv6", "ordered_scatter",
           "ordered_rows")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_ROOT / key / f"lib{name}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for one source unless its library is already cached."""
    target = _target(name)
    if target.exists():
        return None
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, target


def _finish(name: str, job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, target = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, target)  # atomic: concurrent builders never see half a file


def build_all() -> float:
    """Compile every kernel source in parallel; returns the seconds taken."""
    t0 = time.perf_counter()
    jobs = {name: _start(name) for name in SOURCES}
    for name, job in jobs.items():
        if job is not None:
            _finish(name, job)
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``lib<name>.so``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        job = _start(name)
        if job is not None:
            _finish(name, job)
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib
