"""Checkpoint files: the JAX package's three-files-per-step layout under
``{output_dir}/ckpts`` (``model_step{N:07d}``, ``ema_{rate}_step{N:07d}``,
``misc_step{N:07d}``), as ``torch.save`` files of state dicts. Every write is
atomic (a temporary file, then a rename), and the trainer writes the model
file last, so :func:`find_latest_step` only finds complete steps.
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional

import torch

STEP_RE = re.compile(r"model_step(\d+)\.pt$")


def model_path(output_dir: str, step: int) -> str:
    return os.path.join(output_dir, "ckpts", f"model_step{step:07d}.pt")


def ema_path(output_dir: str, rate: float, step: int) -> str:
    return os.path.join(output_dir, "ckpts", f"ema_{rate}_step{step:07d}.pt")


def misc_path(output_dir: str, step: int) -> str:
    return os.path.join(output_dir, "ckpts", f"misc_step{step:07d}.pt")


def find_latest_step(output_dir: str) -> Optional[int]:
    """The latest step with a model file, or None."""
    ckpt_dir = os.path.join(output_dir, "ckpts")
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for name in os.listdir(ckpt_dir) if (m := STEP_RE.search(name))]
    return max(steps) if steps else None


def save(path: str, obj: Any) -> None:
    """``torch.save`` through a temporary file and a rename."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def load(path: str) -> Any:
    """A file written by :func:`save`, tensors on the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)
