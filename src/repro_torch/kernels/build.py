"""Build the CUDA sources in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled by its own ``nvcc`` process into
``build/repro_torch/<name>-<hash>.so`` at the repository root (a directory
``.gitignore`` lists), with a plain C interface and no PyTorch headers, so a
build takes seconds. ``<hash>`` covers the source, the shared headers and the
flags, so an edited source is rebuilt and an unchanged one is reused.
:func:`build_all` starts every compile at once (used by ``chip_smoke.py``);
:func:`load` builds one source if needed and returns its ``ctypes.CDLL``.

Flags: ``-gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
-Xcompiler -fPIC -Xptxas -v``. Never ``--use_fast_math``: the kernels rely
on IEEE division and uncontracted multiply-adds to match their plain
versions bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "NVCC_FLAGS", "build_all", "load", "ptxas_report"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_reports: dict[str, str] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit (PATH or /usr/local/cuda/bin)")


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for p in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str):
    """Start the compile of ``csrc/<name>.cu``; None when already built."""
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, job) -> None:
    if job is None:
        return
    proc, tmp, out = job
    log, _ = proc.communicate()
    _reports[name] = log
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def sources() -> list[str]:
    """Names of the CUDA sources (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all() -> float:
    """Compile every source, all ``nvcc`` processes started together.
    Returns the wall seconds spent."""
    t0 = time.perf_counter()
    with _lock:
        jobs = {name: _start(name) for name in sources()}
        for name, job in jobs.items():
            _finish(name, job)
    return time.perf_counter() - t0


def ptxas_report() -> dict[str, list[str]]:
    """The ``-Xptxas -v`` register / shared-memory / spill lines of the
    sources compiled by this process."""
    keep = ("registers", "spill", "smem", "Compiling entry")
    return {
        name: [ln.strip() for ln in log.splitlines() if any(k in ln for k in keep)]
        for name, log in _reports.items()
    }


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            _finish(name, _start(name))
            lib = ctypes.CDLL(str(_target(name)))
            _libs[name] = lib
        return lib
