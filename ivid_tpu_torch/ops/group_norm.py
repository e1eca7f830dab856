"""GroupNorm with the SiLU and the scale-shift that follow it in the UNet:
the CUDA kernel of the inference forward, its plain version, and the
dispatch between them.

The ADM UNet normalises at 87 sites a forward, in three functions:
``silu(group_norm(x))`` (a residual block's input layers and the output
head), ``silu(group_norm(x) * (1 + scale) + shift)`` (a residual block's
output layers, ``scale`` and ``shift`` from the timestep embedding) and
``group_norm(x)`` (an attention block's norm). :func:`group_norm_act`
computes any of them, optionally of ``x + in_bias`` (a per-channel f32 bias
added as ``x`` is read: the bias of the convolution whose output ``x`` is,
which a residual block in inference on the card leaves to this call). A
CUDA tensor whose computation autograd does not record launches
``csrc/group_norm.cu`` (which replaces no TPU kernel; its source notes say
why it exists, what bounds it and how it is built): one launch reads the
input once, computes the statistics in f32 and writes the result once,
rounded to the output type after the SiLU. Every other tensor
(the CPU, the meta device, and a CUDA tensor while autograd records, as in
training) takes :func:`plain`, the composition the UNet computed before the
kernel existed: the input cast to f32, torch's GroupNorm, the result cast
back, the scale-shift in the torso's type, then the SiLU.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch
import torch.nn.functional as F

from ivid_tpu_torch import cuda_build

NORM, SILU, SCALE_SHIFT_SILU = 0, 1, 2
#: The kernel's supported (input, output) types.
TYPES = ((torch.bfloat16, torch.bfloat16), (torch.bfloat16, torch.float32),
         (torch.float32, torch.float32))
#: The largest slab, (C/G)·H·W elements of one image and group, in bytes
#: (the kernel's 16 blocks a cluster, each staging at most 192 KB).
MAX_SLAB_BYTES = 16 * 192 * 1024

# C signature (csrc/group_norm.cu): five pointers, the embedding's row
# stride, the input bias's pointer, seven ints, eps, the stream.
_ARGS = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_void_p] + [ctypes.c_int] * 7
         + [ctypes.c_float, ctypes.c_void_p])


def plain(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int, eps: float,
          act: bool = False, emb: Optional[torch.Tensor] = None,
          dtype: Optional[torch.dtype] = None,
          in_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The plain version: ``F.group_norm`` on ``x`` cast to f32 (plus
    ``in_bias`` per channel, in f32), the result cast to ``dtype`` (``x``'s
    type if None); with ``emb`` ([N, 2C], the scale then the shift) cast to
    that type, ``y * (1 + scale) + shift``; with ``act`` the SiLU."""
    x32 = x.float() if in_bias is None else x.float() + in_bias[:, None, None]
    y = F.group_norm(x32, groups, weight, bias, eps).to(dtype or x.dtype)
    if emb is not None:
        scale, shift = emb.to(y.dtype)[..., None, None].chunk(2, dim=1)
        y = y * (1 + scale) + shift
    return F.silu(y) if act else y


def _check(x, weight, bias, groups, act, emb, dtype, in_bias=None):
    """Raise on what the kernel does not take."""
    if emb is not None and not act:
        raise ValueError("group_norm_act kernel: the scale-shift comes with the SiLU")
    if (x.dtype, dtype) not in TYPES:
        raise TypeError(f"group_norm_act kernel takes bf16 -> bf16, bf16 -> f32 or f32 -> f32, "
                        f"got {x.dtype} -> {dtype}")
    if x.dim() != 4:
        raise ValueError(f"group_norm_act kernel takes NCHW input, got shape {tuple(x.shape)}")
    n, c, h, w = x.shape
    elems = 16 // x.element_size()
    if c % groups or (h * w) % elems:
        raise ValueError(f"group_norm_act kernel: {c} channels in {groups} groups, H·W = {h * w} "
                         f"must be a multiple of {elems}")
    if (c // groups) * h * w * x.element_size() > MAX_SLAB_BYTES:
        raise ValueError(f"group_norm_act kernel: a group of {tuple(x.shape)} exceeds "
                         f"{MAX_SLAB_BYTES} bytes")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError(f"group_norm_act kernel needs an NCHW-contiguous, 16-byte aligned input, "
                         f"got strides {x.stride()}")
    for name, p in (("weight", weight), ("bias", bias), ("input bias", in_bias)):
        if p is None:
            continue
        if p.dtype != torch.float32 or p.shape != (c,) or not p.is_contiguous():
            raise ValueError(f"group_norm_act kernel needs an f32 {name} of shape ({c},)")
    if emb is not None and (emb.dtype != torch.float32 or emb.shape != (n, 2 * c)
                            or emb.stride(1) != 1):
        raise ValueError(f"group_norm_act kernel needs an f32 scale-shift embedding of shape "
                         f"({n}, {2 * c}) with unit column stride, got {tuple(emb.shape)}")
    if any(t is not None and t.device != x.device for t in (weight, bias, emb, in_bias)):
        raise ValueError("group_norm_act kernel: tensors on different devices")


def _launch(x, weight, bias, groups, eps, act, emb, dtype, in_bias=None) -> torch.Tensor:
    _check(x, weight, bias, groups, act, emb, dtype, in_bias)
    n, c, h, w = x.shape
    y = torch.empty(x.shape, dtype=dtype, device=x.device)
    mode = SCALE_SHIFT_SILU if emb is not None else SILU if act else NORM
    cuda_build.launch("group_norm", "gn_act_launch", _ARGS, x.device,
                      x.data_ptr(), y.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                      0 if emb is None else emb.data_ptr(), 0 if emb is None else emb.stride(0),
                      0 if in_bias is None else in_bias.data_ptr(), n, c, groups, h * w,
                      int(x.dtype == torch.bfloat16), int(dtype == torch.bfloat16), mode,
                      float(eps), count=("GN",) if in_bias is None else ("GN", "GN bias"))
    return y


def group_norm_act(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int,
                   eps: float, act: bool = False, emb: Optional[torch.Tensor] = None,
                   dtype: Optional[torch.dtype] = None,
                   in_bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``group_norm(x)`` over ``groups`` groups with the f32 affine
    ``weight``, ``bias`` (of ``x + in_bias`` in f32 where a [C] f32
    ``in_bias`` is given); with ``emb`` ([N, 2C] f32, the scale then the
    shift) ``* (1 + scale) + shift``; with ``act`` the SiLU (the kernel
    takes ``emb`` only with it); returned in ``dtype`` (``x``'s type if None).
    Where :func:`~ivid_tpu_torch.cuda_build.kernel_applies` the kernel
    launches (or the call raises on
    a type, shape or layout it does not take); every other call is
    :func:`plain`."""
    dtype = dtype or x.dtype
    if not cuda_build.kernel_applies(x, weight, bias, emb, in_bias):
        return plain(x, weight, bias, groups, eps, act, emb, dtype, in_bias)
    return _launch(x, weight, bias, groups, eps, act, emb, dtype, in_bias)
