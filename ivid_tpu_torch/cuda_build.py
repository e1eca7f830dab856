"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point (no PyTorch headers), so
one ``nvcc`` call of a few seconds builds it. The shared library lands in
``ivid_tpu_torch/_build/`` (listed in ``.gitignore``), keyed by a hash of the
source, the headers beside it and the flags, and is built at first use
(:func:`build` starts one nvcc per source at once): importing a module never
touches nvcc or the GPU. The attention kernels link the driver library
(``-lcuda``) for ``cuTensorMapEncodeTiled``, which describes their TMA copies.

Every kernel wrapper of ``ops/`` launches through :func:`launch`, which
counts each launch in :data:`launches`. The inference forward's kernels (the
GroupNorm's and the residual sum's) and the UNet's layout and bias fold
dispatch on one rule, :func:`kernel_applies`.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
#: The package's CUDA sources, ``csrc/<name>.cu``, by name.
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
LINK = {"packed_attention": ["-lcuda"], "packed_attention_bwd": ["-lcuda"]}

_libs: dict = {}
_fns: dict = {}
build_seconds: dict = {}
build_log: dict = {}

#: Kernel launches since the counter was last cleared, by key: ``K1`` to
#: ``K6`` and ``GN`` (each kernel's launches; ``K2 bins`` counts the calls of
#: ``ops/raster_dense.bin_tiles``, two C calls each), ``K1 f32`` and ``K4 f32``
#: (the attention kernels' f32 paths) and ``("K1", 3C)`` (K1's launches by the
#: width of the qkv it read; under tensor parallelism, this rank's heads).
#: :func:`launch` adds to it; a CUDA graph's capture takes back what it
#: counted and each replay adds that again (``models/adm.py``). A key whose
#: count falls to 0 leaves it.
launches = collections.Counter()


def nvcc() -> str:
    """Path of nvcc: ``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda``, then PATH."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _flags(name: str) -> list:
    return NVCC_FLAGS + LINK.get(name, [])


def _library(name: str, src_dir: Path = CSRC) -> Path:
    src_dir = Path(src_dir)
    blob = (Path(src_dir, f"{name}.cu").read_bytes()
            + b"".join(p.read_bytes() for p in sorted(src_dir.glob("*.cuh")))
            + " ".join(_flags(name)).encode())
    if src_dir != CSRC:
        blob += str(src_dir.resolve()).encode()
    return BUILD_DIR / f"lib{name}-{hashlib.sha256(blob).hexdigest()[:16]}.so"


def build(names, src_dir: Path = CSRC) -> None:
    """Build the missing libraries of ``names`` (sources ``src_dir/<name>.cu``),
    one nvcc process per source, all started together."""
    todo = [n for n in dict.fromkeys(names) if not _library(n, src_dir).exists()]
    if not todo:
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc(), *_flags(name), "-o", tmp, str(Path(src_dir, f"{name}.cu"))]
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
        os.replace(tmp, _library(name, src_dir))
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = err
    if failed:
        raise RuntimeError("\n".join(failed))


def load(name: str, src_dir: Path = CSRC) -> ctypes.CDLL:
    """Build ``src_dir/<name>.cu`` if its library is missing, then load it."""
    key = (str(src_dir), name)
    if key not in _libs:
        build([name], src_dir)
        _libs[key] = ctypes.CDLL(str(_library(name, src_dir)))
    return _libs[key]


def function(name: str, symbol: str, argtypes, src_dir: Path = CSRC):
    """The C entry point ``symbol`` of library ``name``, returning an int
    error code, with its argument types set once (pointers and the stream as
    ``c_void_p``, so ctypes does not cut them to 32 bits)."""
    key = (str(src_dir), name, symbol)
    if key not in _fns:
        fn = getattr(load(name, src_dir), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return _fns[key]


def _on_device(device: torch.device):
    """No context switch when ``device`` is already the current one (the
    usual case: a switch costs host time on every launch)."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` lies where the kernels run."""
    return x.device.type == "cuda"


def kernel_applies(x: torch.Tensor, *tensors) -> bool:
    """Whether a call on ``x`` with ``tensors`` (parameters, embeddings,
    biases; None for none) launches the inference forward's kernels: ``x``
    on the card, and autograd records a computation on none of them. The
    UNet lays its torso out NCHW in memory where this holds
    (``models/adm.py``), since the kernels take no other layout."""
    return on_card(x) and not (torch.is_grad_enabled()
                               and any(t is not None and t.requires_grad for t in (x, *tensors)))


def launch(name: str, symbol: str, argtypes, device: torch.device, *args, count) -> None:
    """Call the entry point ``symbol`` of library ``name`` (:func:`function`)
    with ``args`` and the current stream of ``device``, entering ``device``
    only when it is not the current one. Raises on a CUDA error code and
    counts nothing; otherwise adds one to each key of ``count`` in
    :data:`launches` (``count`` is empty where a launch takes two calls and
    the second counts it)."""
    fn = function(name, symbol, argtypes)
    with _on_device(device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{symbol} kernel launch failed: CUDA error {rc}")
    launches.update(count)
