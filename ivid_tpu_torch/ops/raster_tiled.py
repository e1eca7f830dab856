"""Z-buffer resolve of sorted fragments on the GPU: the preparation around
the kernel and its launch.

Port of ``ivid_tpu/ops/raster_tiled.py:resolve_zbuffer_tiled``. The
preparation is the JAX function's: invalid fragments get the key ``npix``
and depth ``FAR`` and a zeroed payload (an invalid fragment may carry a
non-finite interpolated payload), the payload is padded to 4 channels, and
the fragments are sorted by pixel key on the device. Run starts come from a
search of the sorted keys, and ``csrc/zbuffer_resolve.cu`` (K3, which
replaces the TPU kernel ``ivid_tpu/ops/raster_tiled.py:_tile_kernel``; the
source note says what bounds it) resolves every pixel, averages the ties and
flips the rows. :func:`ivid_tpu_torch.ops.raster.resolve_zbuffer_scatter` is
its plain version.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ivid_tpu_torch import cuda_build
from ivid_tpu_torch.ops.raster import FragmentBatch, _concat
from ivid_tpu_torch.utils.profiling import span

FAR = 9.0  # depth of invalid fragments; valid window z lies in [0, 1]

# C signature (csrc/zbuffer_resolve.cu): six pointers, the pixel count,
# two ints, the stream.
_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def prepare(fragments: Sequence[FragmentBatch], payloads: Sequence[torch.Tensor],
            render_size: int, num_buffers: int = 1):
    """Kernel inputs: ``(starts [npix+1] int32, z [N] f32, payload [N, 4]
    f32, k)``, fragments sorted (stably) by pixel key."""
    npix = num_buffers * render_size * render_size
    if npix >= 2 ** 24:
        raise ValueError(f"{num_buffers} x {render_size}² pixels exceed the resolve's 2^24 ids")
    pix, d, valid, payload = _concat(fragments, payloads)
    k = payload.shape[-1]
    if k > 4:
        raise ValueError(f"the z-buffer resolve takes at most 4 payload channels, got {k}")
    if k < 4:
        payload = torch.cat([payload, payload.new_zeros(payload.shape[:-1] + (4 - k,))], -1)
    key = torch.where(valid, pix, torch.full_like(pix, npix))
    z = torch.where(valid, d, torch.full_like(d, FAR)).float()
    payload = torch.where(valid[:, None], payload, torch.zeros_like(payload)).float()
    key_s, order = torch.sort(key, stable=True)
    edges = torch.arange(npix + 1, dtype=key_s.dtype, device=key_s.device)
    starts = torch.searchsorted(key_s, edges).int()
    return starts, z[order].contiguous(), payload[order].contiguous(), k


def launch(starts, z, payload, k: int, render_size: int, num_buffers: int = 1):
    """K3 on prepared inputs: ``(payload [npix, k], depth_win [npix],
    covered [npix])`` in image row order (flat; see :func:`resolve_zbuffer_tiled`)."""
    npix = num_buffers * render_size * render_size
    if starts.shape != (npix + 1,) or starts.dtype != torch.int32:
        raise ValueError(f"starts must be int32 [{npix + 1}], got {starts.dtype} {tuple(starts.shape)}")
    if z.dtype != torch.float32 or payload.dtype != torch.float32:
        raise TypeError("z and payload must be float32")
    if payload.shape != (z.shape[0], 4) or z.dim() != 1:
        raise ValueError("payload must be [N, 4] beside z [N]")
    if not (starts.is_contiguous() and z.is_contiguous() and payload.is_contiguous()):
        raise ValueError("the resolve's inputs must be contiguous")
    if payload.data_ptr() % 16:
        raise ValueError("payload must be 16-byte aligned")
    if z.device != starts.device or payload.device != starts.device:
        raise ValueError("the resolve's inputs must lie on one device")
    dev = z.device
    out = torch.empty((npix, k), dtype=torch.float32, device=dev)
    depth = torch.empty((npix,), dtype=torch.float32, device=dev)
    covered = torch.empty((npix,), dtype=torch.bool, device=dev)
    cuda_build.launch("zbuffer_resolve", "zbuffer_resolve_launch", _ARGS, dev,
                      starts.data_ptr(), z.data_ptr(), payload.data_ptr(), out.data_ptr(),
                      depth.data_ptr(), covered.data_ptr(), npix, render_size, k, count=("K3",))
    return out, depth, covered


def resolve_zbuffer_tiled(fragments: Sequence[FragmentBatch], payloads: Sequence[torch.Tensor],
                          render_size: int, num_buffers: int = 1):
    """:func:`ivid_tpu_torch.ops.raster.resolve_zbuffer` on CUDA tensors
    (payload K ≤ 4): ``(payload [.., R, R, K], depth_win [.., R, R], covered
    [.., R, R])`` in image row order, with a leading buffer axis when
    ``num_buffers > 1``. Under torch.profiler the two steps are the spans
    ``raster_tiled.prepare`` and ``raster_tiled.resolve``."""
    if fragments[0].depth.device.type != "cuda":
        raise ValueError("resolve_zbuffer_tiled runs on CUDA tensors; "
                         "CPU tensors take raster.resolve_zbuffer_scatter")
    with span("raster_tiled.prepare"):
        starts, z, payload, k = prepare(fragments, payloads, render_size, num_buffers)
    with span("raster_tiled.resolve"):
        out, depth, covered = launch(starts, z, payload, k, render_size, num_buffers)
    r = render_size
    lead = (num_buffers,) if num_buffers > 1 else ()
    return (out.reshape(lead + (r, r, k)), depth.reshape(lead + (r, r)),
            covered.reshape(lead + (r, r)))
