"""Packed-qkv multi-head attention: the CUDA kernels, their plain version,
and the autograd function around them.

The UNet's attention blocks project tokens to one fused ``qkv [B, T, 3C]``
whose columns are head-major ``[h][q|k|v][D]`` groups (the reference's Conv1d
channel order). :func:`packed_attention` reads q/k/v straight out of that
tensor and writes token-major ``[B, T, C]``, so the surrounding projections
connect without layout copies. On a CUDA tensor the forward launches
``csrc/packed_attention.cu`` (K1, which replaces the TPU kernel
``ivid_tpu/ops/attention.py:_attn_kernel``) and, when a gradient is needed,
also stores each row's log-sum-exp; the backward launches
``csrc/packed_attention_bwd.cu`` (K4, which replaces the flash VJP that
``ivid_tpu/ops/attention.py:_packed_bwd`` calls). The source notes say what
bounds each and how it is built. On a CPU tensor both directions run
:func:`reference_attention` under autograd, the same function in plain
PyTorch. :func:`logsumexp_reference` and :func:`attention_backward_reference`
are the plain versions of K1's log-sum-exp and of K4 in its formula form.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ivid_tpu_torch import cuda_build
from ivid_tpu_torch.utils.profiling import span

HEAD_DIM = 64
_LOG2E = math.log2(math.e)


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


def _split_heads(x: torch.Tensor, heads: int):
    b, t, c3 = x.shape
    return x.reshape(b, t, heads, c3 // heads).split(HEAD_DIM, dim=-1)


def logsumexp_reference(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """Plain version of K1's second output: the natural log-sum-exp of each
    row's f32 logits ``scale² q·k``, ``[B, H, T]``."""
    q, k, _ = _split_heads(qkv.float(), heads)
    return torch.logsumexp(torch.einsum("bthd,bshd->bhts", q, k) * (scale * scale), dim=-1)


def attention_backward_reference(qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor,
                                 lse: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """Plain version of K4 in its formula form, in f32, returned in qkv's
    type: from the forward's ``qkv``, ``out`` and ``lse`` and the output
    gradient ``dout``, with ``P = exp(s² q·k - lse)`` and ``D = rowsum(dO∘O)``:
    ``dV = Pᵀ dO``, ``dS = P∘(dO Vᵀ - D)``, ``dQ = s² dS K``, ``dK = s² dSᵀ Q``."""
    b, t, c3 = qkv.shape
    s2 = scale * scale
    q, k, v = _split_heads(qkv.float(), heads)
    g = dout.float().reshape(b, t, heads, HEAD_DIM)
    o = out.float().reshape(b, t, heads, HEAD_DIM)
    p = torch.exp(torch.einsum("bthd,bshd->bhts", q, k) * s2 - lse.float()[..., None])
    dv = torch.einsum("bhts,bthd->bshd", p, g)
    d = (g * o).sum(-1).transpose(1, 2)[..., None]
    ds = p * (torch.einsum("bthd,bshd->bhts", g, v) - d)
    dq = torch.einsum("bhts,bshd->bthd", ds, k) * s2
    dk = torch.einsum("bhts,bthd->bshd", ds, q) * s2
    return torch.cat([dq, dk, dv], dim=-1).reshape(b, t, c3).to(qkv.dtype)


def _check(qkv: torch.Tensor, heads: int):
    if qkv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"packed_attention takes float32 or bfloat16, got {qkv.dtype}")
    if qkv.shape[-1] != 3 * heads * HEAD_DIM:
        raise ValueError(
            f"packed_attention needs {HEAD_DIM}-wide heads: 3C={qkv.shape[-1]}, heads={heads}")
    if not qkv.is_contiguous() or qkv.data_ptr() % 16:
        raise ValueError("packed_attention needs a contiguous, 16-byte aligned qkv tensor")


# C signatures (csrc/packed_attention{,_bwd}.cu): pointers and the stream as
# c_void_p, then ints and floats.
_FWD_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                                            ctypes.c_void_p]
_BWD_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2 + [
    ctypes.c_int, ctypes.c_void_p]


def _launch(qkv: torch.Tensor, heads: int, scale: float, with_lse: bool = False):
    """K1: ``out [B, T, C]`` and, with ``with_lse``, the natural log-sum-exp
    ``lse [B, H, T]`` (f32) of each row's logits ``scale² q·k``."""
    _check(qkv, heads)
    b, t, c3 = qkv.shape
    out = torch.empty((b, t, c3 // 3), dtype=qkv.dtype, device=qkv.device)
    lse = (torch.empty((b, heads, t), dtype=torch.float32, device=qkv.device)
           if with_lse else None)
    qscale = float(scale) * float(scale) * _LOG2E
    f32 = ("K1 f32",) if qkv.dtype == torch.float32 else ()
    cuda_build.launch(
        "packed_attention", "packed_attention_fwd_launch", _FWD_ARGS, qkv.device,
        qkv.data_ptr(), out.data_ptr(), 0 if lse is None else lse.data_ptr(), b, t, heads,
        qscale, int(qkv.dtype == torch.bfloat16), count=("K1", ("K1", c3), *f32))
    return out, lse


def _launch_bwd(qkv: torch.Tensor, out: torch.Tensor, dout: torch.Tensor, lse: torch.Tensor,
                heads: int, scale: float) -> torch.Tensor:
    """K4: ``dqkv [B, T, 3C]`` in the input type from the forward's ``qkv``,
    ``out`` and ``lse`` and the output gradient ``dout``."""
    _check(qkv, heads)
    b, t, c3 = qkv.shape
    if out.shape != (b, t, c3 // 3) or dout.shape != out.shape or lse.shape != (b, heads, t):
        raise ValueError("packed attention backward: shapes do not fit qkv")
    if out.dtype != qkv.dtype or dout.dtype != qkv.dtype or lse.dtype != torch.float32:
        raise TypeError("packed attention backward: out/dout must match qkv, lse must be f32")
    if not (out.is_contiguous() and dout.is_contiguous() and lse.is_contiguous()):
        raise ValueError("packed attention backward needs contiguous tensors")
    if out.data_ptr() % 16 or dout.data_ptr() % 16:
        raise ValueError("packed attention backward needs 16-byte aligned out and dout")
    if any(x.device != qkv.device for x in (out, dout, lse)):
        raise ValueError("packed attention backward: tensors on different devices")
    dqkv = torch.empty_like(qkv)
    # Per-row (lse·log2 e, D) pairs, T padded to the kernels' 64-row tiles.
    tpad = -(-t // 64) * 64
    scratch = torch.empty((b, heads, tpad, 2), dtype=torch.float32, device=qkv.device)
    s2 = float(scale) * float(scale)
    f32 = ("K4 f32",) if qkv.dtype == torch.float32 else ()
    cuda_build.launch(
        "packed_attention_bwd", "packed_attention_bwd_launch", _BWD_ARGS, qkv.device,
        qkv.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
        dqkv.data_ptr(), b, t, heads, s2 * _LOG2E, s2, int(qkv.dtype == torch.bfloat16),
        count=("K4", *f32))
    return dqkv


class _PackedAttention(torch.autograd.Function):
    """K1 forward with the log-sum-exp kept for K4's backward."""

    @staticmethod
    def forward(ctx, qkv, heads, scale):
        out, lse = _launch(qkv, heads, scale, with_lse=True)
        ctx.save_for_backward(qkv, out, lse)
        ctx.heads, ctx.scale = heads, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        with span("attention.bwd"):
            qkv, out, lse = ctx.saved_tensors
            return _launch_bwd(qkv, out, dout.contiguous(), lse, ctx.heads, ctx.scale), None, None


def packed_attention(qkv: torch.Tensor, heads: int, scale: float) -> torch.Tensor:
    """Attention over a packed ``[B, T, 3C]`` qkv tensor with 64-wide heads.
    CUDA tensors go through the kernels (or raise): K1 alone when no gradient
    is needed, K1 and K4 under autograd otherwise. CPU tensors go through
    :func:`reference_attention`. Under torch.profiler the call is the span
    ``attention.fwd`` (the host's preparation and launch on the card), and
    K4's backward the span ``attention.bwd``."""
    with span("attention.fwd"):
        if qkv.device.type == "cuda":
            if torch.is_grad_enabled() and qkv.requires_grad:
                return _PackedAttention.apply(qkv, heads, scale)
            return _launch(qkv, heads, scale)[0]
        if qkv.device.type == "cpu":
            return reference_attention(qkv, heads, scale)
    raise ValueError(f"packed_attention: unsupported device {qkv.device}")
