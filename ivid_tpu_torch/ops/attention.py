"""Packed-qkv multi-head attention: the CUDA kernel and its plain version.

The UNet's attention blocks project tokens to one fused ``qkv [B, T, 3C]``
whose columns are head-major ``[h][q|k|v][D]`` groups (the reference's Conv1d
channel order). :func:`packed_attention` reads q/k/v straight out of that
tensor and writes token-major ``[B, T, C]``, so the surrounding projections
connect without layout copies. On a CUDA tensor it launches
``csrc/packed_attention.cu`` (which replaces the TPU kernel
``ivid_tpu/ops/attention.py:_attn_kernel``; the source note there says what
bounds it and how it is built); on a CPU tensor it runs
:func:`reference_attention`, the same function in plain PyTorch.
"""

from __future__ import annotations

import ctypes
import math

import torch

HEAD_DIM = 64
_LOG2E = math.log2(math.e)

# Kernel launches since the counter was last reset (chip_smoke.py reads it).
launches = 0


def reference_attention(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """Plain packed attention with an f32 softmax (the JAX package's
    ``reference_attention``): logits of ``q*scale`` and ``k*scale``, softmax in
    f32 cast back to the input type, then the value product."""
    b, t, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    q, k, v = qkv.reshape(b, t, heads, 3 * d).split(d, dim=-1)
    logits = torch.einsum("bthd,bshd->bhts", q * scale, k * scale)
    w = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
    return torch.einsum("bhts,bshd->bthd", w, v).reshape(b, t, c)


def _launch(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    from ivid_tpu_torch import cuda_build

    global launches
    b, t, c3 = qkv.shape
    c = c3 // 3
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"packed_attention takes float32 or bfloat16, got {qkv.dtype}")
    if c3 != 3 * heads * HEAD_DIM:
        raise ValueError(f"packed_attention needs {HEAD_DIM}-wide heads: 3C={c3}, heads={heads}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("packed_attention needs a contiguous, 16-byte aligned qkv tensor")
    lib = cuda_build.load("packed_attention")
    fn = lib.packed_attention_fwd_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    out = torch.empty((b, t, c), dtype=qkv.dtype, device=qkv.device)
    qscale = float(scale) * float(scale) * _LOG2E
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(
            qkv.data_ptr(), out.data_ptr(), b, t, heads, qscale,
            int(qkv.dtype == torch.bfloat16), stream,
        )
    if rc != 0:
        raise RuntimeError(f"packed_attention kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def packed_attention(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """Attention over a packed ``[B, T, 3C]`` qkv tensor with 64-wide heads.
    CUDA tensors go through the kernel (or raise); CPU tensors through
    :func:`reference_attention`."""
    if qkv.device.type == "cuda":
        return _launch(qkv, heads, scale)
    if qkv.device.type == "cpu":
        return reference_attention(qkv, heads, scale)
    raise ValueError(f"packed_attention: unsupported device {qkv.device}")
