"""Checkpoint files: the JAX package's three-files-per-step layout under
``{output_dir}/ckpts`` (``model_step{N:07d}``, ``ema_{rate}_step{N:07d}``,
``misc_step{N:07d}``), as ``torch.save`` files of state dicts. Every write is
atomic (a temporary file, then a rename), and the trainer writes the model
file last, so :func:`find_latest_step` only finds complete steps.

:func:`finetune_load` reads a model state dict for finetuning a model with
more input channels (the channel-pad finetune of the JAX package's
``checkpoint.finetune_load``).
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

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


IN_CONV = "input_blocks.0.0.weight"


def pad_input_channels(state: Dict[str, torch.Tensor], in_channels: int) -> Dict[str, torch.Tensor]:
    """``state`` with the first convolution's weight [O, I, kh, kw]
    zero-padded along I to ``in_channels``: the added inputs start with no
    effect on the output."""
    w = state[IN_CONV]
    if w.shape[1] > in_channels:
        raise ValueError(f"{IN_CONV} has {w.shape[1]} input channels, more than {in_channels}")
    if w.shape[1] == in_channels:
        return state
    pad = w.new_zeros((w.shape[0], in_channels - w.shape[1]) + tuple(w.shape[2:]))
    return dict(state, **{IN_CONV: torch.cat([w, pad], dim=1)})


def finetune_load(path: str, model_state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The state dict in ``path`` (the port's ``model_step*.pt`` or
    ``ema_*.pt``, or a reference PyTorch checkpoint: the port keeps the
    reference's names) made to fit ``model_state``: the reference's
    ``freqs`` buffers dropped, the first convolution zero-padded to the
    model's input channels. Raises ``ValueError`` unless every name and
    shape then matches ``model_state``."""
    state = {k: v for k, v in load(path).items() if "freqs" not in k}
    state = pad_input_channels(state, model_state[IN_CONV].shape[1])
    missing = sorted(set(model_state) - set(state))
    unexpected = sorted(set(state) - set(model_state))
    if missing or unexpected:
        raise ValueError(f"{path}: missing {missing}, unexpected {unexpected}")
    wrong = {k: (tuple(v.shape), tuple(model_state[k].shape))
             for k, v in state.items() if v.shape != model_state[k].shape}
    if wrong:
        raise ValueError(f"{path}: shape mismatch (checkpoint, model): {wrong}")
    return state
