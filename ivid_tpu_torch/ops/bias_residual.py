"""The residual sum of the UNet's residual blocks with their convolutions'
biases: the CUDA kernel of the inference forward, its plain version, and the
dispatch between them.

A residual block returns ``skip(x) + conv(h)``, where ``conv`` is its last
3x3 convolution and ``skip`` the identity or a 1x1 convolution. In the
inference forward on the card both convolutions run without their biases and
:func:`bias_residual` adds them with the sum: ``skip + conv + (bias +
bias2)``, in f32, rounded once to the tensors' type. One launch of
``csrc/bias_residual.cu`` (which replaces no TPU kernel; its source notes say
why it exists and what bounds it) reads the two outputs once and writes the
sum once: the bytes of the residual add alone, where torch spent a broadcast
pass over each convolution's output on its bias first. The dispatch is the
GroupNorm kernel's rule (:func:`ivid_tpu_torch.cuda_build.kernel_applies`): a
CUDA tensor whose computation autograd does not record launches the kernel;
every other call takes :func:`plain`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ivid_tpu_torch import cuda_build

#: The kernel's types: the sum's inputs and output share one.
TYPES = (torch.bfloat16, torch.float32)

# C signature (csrc/bias_residual.cu): five pointers, the batch, the
# channels, H·W, whether bf16, the stream.
_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
                                  ctypes.c_int, ctypes.c_void_p])


def plain(skip: torch.Tensor, conv: torch.Tensor, bias: torch.Tensor,
          bias2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: ``skip + conv + (bias + bias2)`` in f32 (the
    biases per channel, ``bias2`` left out where None), cast to ``conv``'s
    type."""
    b = bias if bias2 is None else bias + bias2
    return (skip.float() + conv.float() + b[:, None, None]).to(conv.dtype)


def _check(skip, conv, bias, bias2):
    """Raise on what the kernel does not take."""
    if conv.dtype not in TYPES or skip.dtype != conv.dtype:
        raise TypeError(f"bias_residual kernel takes two bf16 or two f32 tensors, got "
                        f"{skip.dtype} and {conv.dtype}")
    if conv.dim() != 4 or skip.shape != conv.shape:
        raise ValueError(f"bias_residual kernel takes two NCHW tensors of one shape, got "
                         f"{tuple(skip.shape)} and {tuple(conv.shape)}")
    n, c, h, w = conv.shape
    elems = 16 // conv.element_size()
    if (h * w) % elems or conv.numel() // elems >= 2 ** 31:
        raise ValueError(f"bias_residual kernel: H·W = {h * w} must be a multiple of {elems}, "
                         f"and {tuple(conv.shape)} below 2^31 16-byte vectors")
    for name, t in (("skip", skip), ("conv", conv)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"bias_residual kernel needs an NCHW-contiguous, 16-byte aligned "
                             f"{name}, got strides {t.stride()}")
    for name, b in (("bias", bias), ("bias2", bias2)):
        if b is not None and (b.dtype != torch.float32 or b.shape != (c,)
                              or not b.is_contiguous()):
            raise ValueError(f"bias_residual kernel needs an f32 {name} of shape ({c},)")
    if any(t is not None and t.device != conv.device for t in (skip, bias, bias2)):
        raise ValueError("bias_residual kernel: tensors on different devices")


def _launch(skip, conv, bias, bias2) -> torch.Tensor:
    _check(skip, conv, bias, bias2)
    n, c, h, w = conv.shape
    y = torch.empty_like(conv)
    cuda_build.launch("bias_residual", "bias_residual_launch", _ARGS, conv.device,
                      skip.data_ptr(), conv.data_ptr(), y.data_ptr(), bias.data_ptr(),
                      0 if bias2 is None else bias2.data_ptr(), n, c, h * w,
                      int(conv.dtype == torch.bfloat16), count=("RES",))
    return y


def bias_residual(skip: torch.Tensor, conv: torch.Tensor, bias: torch.Tensor,
                  bias2: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``skip + conv + (bias + bias2)`` over NCHW ``skip`` and ``conv`` of
    one type, the f32 per-channel biases ``bias`` and ``bias2`` (None for
    none) added in f32 and the sum rounded once. Where
    :func:`~ivid_tpu_torch.cuda_build.kernel_applies` the kernel
    launches (or the call raises on a type, shape or layout it does not
    take); every other call is :func:`plain`."""
    if not cuda_build.kernel_applies(conv, skip, bias, bias2):
        return plain(skip, conv, bias, bias2)
    return _launch(skip, conv, bias, bias2)
