"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point (no PyTorch headers), so
one ``nvcc`` call of a few seconds builds it. The shared library lands in
``ivid_tpu_torch/_build/`` (listed in ``.gitignore``), keyed by a hash of the
source and the flags, and is built at first use (:func:`build` starts one
nvcc per source at once): importing a module never touches nvcc or the GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: dict = {}
build_seconds: dict = {}
build_log: dict = {}


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda``, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _library(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names) -> None:
    """Build the missing libraries of ``names``, one nvcc process per source,
    all started together."""
    todo = [n for n in dict.fromkeys(names) if not _library(n).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, time.perf_counter(), subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    # communicate() drains each process's pipes while the others go on
    # building; a build's seconds run until its output has been collected.
    for name, (tmp, t0, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {name}.cu:\n{out}\n{err}")
            continue
        os.replace(tmp, _library(name))
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = err
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if its library is missing, then load it."""
    if name not in _libs:
        build([name])
        _libs[name] = ctypes.CDLL(str(_library(name)))
    return _libs[name]
