"""Device calls the drivers share: no-ops on the CPU, where the tests drive
a run, and the reference's float32 precision."""

from __future__ import annotations

import gc

import torch


def reset_peak(device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def peak_bytes(device) -> int:
    return int(torch.cuda.max_memory_allocated(device)) if device.type == "cuda" else 0


def release(device) -> None:
    """Free what the dropped objects held on the device."""
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class exact_f32:
    """Float32 products without TF32 inside the block (the reference's
    precision), the flags restored after it."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved
