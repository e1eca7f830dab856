"""The native image resampler: ``csrc/image_ops.cpp`` built with g++ and
loaded with ctypes.

The library is built at first use (never at import) with the flags of
``native/Makefile``, into ``ivid_tpu_torch/_build/`` (listed in
``.gitignore``), keyed by a hash of the source, the flags and the host's CPU
model: ``-march=native`` code from one machine must not load on another. A
file lock keeps loader workers that start together from building it twice. A
failed build raises with the compiler's output; there is no fallback to
another resampler, so an item never depends on which one a machine has.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "image_ops.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]
LIBS = ["-lpthread"]

_lock = threading.Lock()
_lib = None


def _cpu_model() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            return next((line for line in f if line.startswith("model name")), "")
    except OSError:
        return ""


def library_path() -> Path:
    blob = (SOURCE.read_bytes() + " ".join(FLAGS + LIBS).encode()
            + f"{platform.machine()} {_cpu_model()}".encode())
    return BUILD_DIR / f"libimage_ops-{hashlib.sha256(blob).hexdigest()[:16]}.so"


def build() -> Path:
    """Build the library if it is missing; returns its path."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / "image_ops.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if path.exists():
            return path
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = ["g++", *FLAGS, str(SOURCE), "-o", tmp, *LIBS]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"g++ failed to build {SOURCE.name}:\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)
    return path


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.ivid_lanczos_resize_center_crop.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ]
            lib.ivid_lanczos_resize_center_crop.restype = None
            _lib = lib
    return _lib


def lanczos_resize_center_crop(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] → float32 [size, size, C] in [0, 1]: the
    shorter side Lanczos-3-resampled to ``size`` (the other side rounded),
    then the centred square, both passes quantized to 8 bits as PIL's are
    (torchvision's ``Resize(size, LANCZOS)`` + ``CenterCrop(size)``)."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"expected a uint8 [H, W(, C)] image, got {img.dtype} {img.shape}")
    img = np.ascontiguousarray(img if img.ndim == 3 else img[..., None])
    h, w, c = img.shape
    out = np.empty((size, size, c), np.float32)
    _load().ivid_lanczos_resize_center_crop(
        img.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), h, w, c, size,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out
