"""Two per-tile z-buffer resolves: the A/B prototypes of K3 that the JAX
repository keeps in its bench scripts, and their kernels K5 and K6.

Both resolve 1024-pixel tiles and write ``[T, 5, 1024]`` f32 per tile: the
depth minimum over the tile's fragments at each pixel (clear depth ``FAR``),
then sums over the fragments whose depth is at most that minimum (the
equal-depth ties).

- Row 6, pre-binned tiles (``bench_micro.py:dense_kernel``): every tile
  holds ``F`` fragments in any order, each with a local pixel ``lp`` (one
  outside [0, 1024) matches no pixel), a depth and 4 payload channels; the
  output rows are the depth and 4 payload sums. :func:`binned_resolve`
  launches ``csrc/binned_resolve.cu`` (K5) on CUDA tensors;
  :func:`binned_resolve_reference` is its plain version.
- Row 7, sorted fragments (``bench_resolve.py:proto``):
  :func:`prepare_tiles` sorts the fragments by pixel key and cuts them into
  tiles by a search; each tile's range ``[bounds[t], bounds[t+1])`` is
  resolved whole (the prototype's cap of 24 chunks of 512 is not carried
  over). The output rows are the depth, 3 payload sums and the winner
  count. :func:`tile_resolve` launches ``csrc/tile_resolve.cu`` (K6) on
  CUDA tensors; :func:`tile_resolve_reference` is its plain version, and
  :func:`tile_finish` turns its output into the framebuffers of
  :func:`ivid_tpu_torch.ops.raster.resolve_zbuffer`.

The wrappers take the plain version for CPU tensors only; for CUDA tensors
they launch the kernel or raise.
"""

from __future__ import annotations

import ctypes

import torch

from ivid_tpu_torch import cuda_build
from ivid_tpu_torch.ops.raster import flip_to_image_rows
from ivid_tpu_torch.ops.raster_tiled import FAR

TILE = 1024  # pixels per tile (the kernels' shared-memory z-buffer)
# K6 streams a tile's range through TILE_STAGES chunks of TILE_CHUNK
# fragments in shared memory (csrc/tile_resolve.cu: kChunk, kStages); a
# longer range passes through them more than once.
TILE_CHUNK = 2048
TILE_STAGES = 2
TILE_STAGING = TILE_CHUNK * TILE_STAGES

# C signatures (csrc/binned_resolve.cu, csrc/tile_resolve.cu): pointers and
# the stream as c_void_p, counts as c_int.
_BINNED_ARGS = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
_TILE_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p]


def binned_resolve_reference(lp: torch.Tensor, z: torch.Tensor, pay: torch.Tensor) -> torch.Tensor:
    """Plain row-6 resolve of ``T`` tiles of ``F`` fragments: local pixels
    ``lp`` [T, F] (int), depths ``z`` [T, F] and payloads ``pay`` [T, F, 4].
    Returns [T, 5, 1024] f32: the depth minimum (``FAR`` where no fragment
    falls) and the sums of the 4 payload channels over the fragments with
    ``z <= minimum``."""
    t = lp.shape[0]
    inside = (lp >= 0) & (lp < TILE)
    idx = torch.where(inside, lp.long(), torch.full_like(lp, TILE, dtype=torch.long))
    z = z.float()
    zbuf = torch.full((t, TILE + 1), FAR, dtype=torch.float32, device=z.device)
    zbuf = zbuf.scatter_reduce(1, idx, z, reduce="amin")
    win = (inside & (z <= zbuf.gather(1, idx))).float()
    acc = torch.zeros((t, TILE + 1, 4), dtype=torch.float32, device=z.device)
    acc.scatter_add_(1, idx[..., None].expand(-1, -1, 4), pay.float() * win[..., None])
    return torch.cat([zbuf[:, None, :TILE], acc[:, :TILE].transpose(1, 2)], dim=1)


def prepare_tiles(pixel: torch.Tensor, depth: torch.Tensor, payload: torch.Tensor,
                  valid: torch.Tensor, npix: int):
    """The row-7 prototype's preparation of flat fragments with global pixel
    ids ``b·R² + y·R + x`` (so one call covers B stacked buffers) and a
    3-channel payload. Invalid fragments get the key ``npix`` and
    depth ``FAR`` (their payload is zeroed); the fragments are sorted by key
    (stably); tile ids are ``min(key // 1024, T - 1)``, so the invalid ones
    sit at the end of the last tile with the local pixel 1024, where they
    match nothing. Returns ``(bounds [T+1] int32, lp [N] int32, z [N] f32,
    payload [N, 3] f32)``, ``T = npix / 1024``."""
    if npix % TILE:
        raise ValueError(f"{npix} pixels are not a whole number of {TILE}-pixel tiles")
    if npix + TILE >= 2 ** 31 or pixel.numel() >= 2 ** 31:
        raise ValueError("the tile resolve takes int32 pixel ids and fragment indices")
    if payload.shape[-1] != 3:
        raise ValueError(f"the tile resolve takes 3 payload channels, got {payload.shape[-1]}")
    key = torch.where(valid, pixel, torch.full_like(pixel, npix))
    z = torch.where(valid, depth, torch.full_like(depth, FAR)).float()
    payload = torch.where(valid[:, None], payload, torch.zeros_like(payload)).float()
    key_s, order = torch.sort(key, stable=True)
    tiles = npix // TILE
    tid = torch.clamp(key_s // TILE, max=tiles - 1)
    edges = torch.arange(tiles + 1, dtype=tid.dtype, device=tid.device)
    bounds = torch.searchsorted(tid, edges).int()
    lp = (key_s - tid * TILE).int()
    return bounds, lp, z[order].contiguous(), payload[order].contiguous()


def tile_resolve_reference(bounds: torch.Tensor, lp: torch.Tensor, z: torch.Tensor,
                           pay: torch.Tensor) -> torch.Tensor:
    """Plain row-7 resolve: tile ``t`` takes the fragments ``[bounds[t],
    bounds[t+1])``. Returns [T, 5, 1024] f32: the depth minimum (``FAR``
    where no fragment falls), the sums of the 3 payload channels and the
    count of the fragments with ``z <= minimum``."""
    tiles = bounds.shape[0] - 1
    n = lp.shape[0]
    b = bounds.long()
    tid = torch.searchsorted(b, torch.arange(n, device=lp.device), right=True) - 1
    inside = (tid >= 0) & (tid < tiles) & (lp >= 0) & (lp < TILE)
    idx = torch.where(inside, tid * TILE + lp.long(), torch.full_like(tid, tiles * TILE))
    z = z.float()
    zbuf = torch.full((tiles * TILE + 1,), FAR, dtype=torch.float32, device=z.device)
    zbuf = zbuf.scatter_reduce(0, idx, z, reduce="amin")
    win = (inside & (z <= zbuf[idx])).float()
    acc = torch.zeros((tiles * TILE + 1, 4), dtype=torch.float32, device=z.device)
    acc.index_add_(0, idx, torch.cat([pay.float() * win[:, None], win[:, None]], dim=1))
    zbuf = zbuf[:-1].reshape(tiles, 1, TILE)
    return torch.cat([zbuf, acc[:-1].reshape(tiles, TILE, 4).transpose(1, 2)], dim=1)


def tile_finish(out: torch.Tensor, render_size: int, num_buffers: int = 1):
    """The ``[T, 5, 1024]`` of a row-7 resolve → ``(payload, depth_win,
    covered)`` as :func:`ivid_tpu_torch.ops.raster.resolve_zbuffer` returns
    them (3 payload channels): the sums averaged by the count, depth
    1.0 where no fragment won, image rows. A pixel is covered where a
    fragment won, which is wherever a valid fragment fell (valid depths lie
    below ``FAR``)."""
    npix = num_buffers * render_size * render_size
    if out.shape != (npix // TILE, 5, TILE) or npix % TILE:
        raise ValueError(f"{tuple(out.shape)} is not the tile output of {npix} pixels")
    cnt = out[:, 4].reshape(npix)
    covered = cnt > 0
    payload = out[:, 1:4].transpose(1, 2).reshape(npix, 3) / torch.clamp(cnt, min=1.0)[:, None]
    depth = torch.where(covered, out[:, 0].reshape(npix), torch.ones_like(cnt))
    return flip_to_image_rows(payload, depth, covered, render_size, num_buffers)


def _launch_binned(lp: torch.Tensor, z: torch.Tensor, pay: torch.Tensor) -> torch.Tensor:
    """K5 on CUDA tensors: lp int32 [T, F], z f32 [T, F], pay f32 [T, F, 4]."""
    if lp.dim() != 2:
        raise ValueError(f"binned_resolve takes lp [T, F], got {tuple(lp.shape)}")
    t, f = lp.shape
    if lp.dtype != torch.int32 or z.dtype != torch.float32 or pay.dtype != torch.float32:
        raise TypeError("binned_resolve takes int32 lp and float32 z and payload")
    if z.shape != (t, f) or pay.shape != (t, f, 4):
        raise ValueError(f"binned_resolve needs z [T, F] and payload [T, F, 4] beside lp {(t, f)}")
    if not all(x.is_contiguous() for x in (lp, z, pay)) or pay.data_ptr() % 16:
        raise ValueError("binned_resolve's inputs must be contiguous, the payload 16-byte aligned")
    if z.device != lp.device or pay.device != lp.device:
        raise ValueError("binned_resolve's inputs must lie on one device")
    if t < 1 or t * f >= 2 ** 31:
        raise ValueError(f"binned_resolve takes 1 <= T and T·F < 2^31, got {t} x {f}")
    out = torch.empty((t, 5, TILE), dtype=torch.float32, device=lp.device)
    cuda_build.launch("binned_resolve", "binned_resolve_launch", _BINNED_ARGS, lp.device,
                      lp.data_ptr(), z.data_ptr(), pay.data_ptr(), out.data_ptr(), t, f,
                      count=("K5",))
    return out


def _launch_tile(bounds: torch.Tensor, lp: torch.Tensor, z: torch.Tensor,
                 pay: torch.Tensor) -> torch.Tensor:
    """K6 on CUDA tensors: bounds int32 [T+1], lp int32 [N], z f32 [N],
    pay f32 [N, 3], each tile's range sorted by ``lp``."""
    tiles, n = bounds.shape[0] - 1, lp.shape[0]
    if bounds.dtype != torch.int32 or lp.dtype != torch.int32:
        raise TypeError("tile_resolve takes int32 bounds and lp")
    if z.dtype != torch.float32 or pay.dtype != torch.float32:
        raise TypeError("tile_resolve takes float32 z and payload")
    if bounds.dim() != 1 or tiles < 1 or lp.dim() != 1 or z.shape != (n,) or pay.shape != (n, 3):
        raise ValueError("tile_resolve needs bounds [T+1], lp [N], z [N] and payload [N, 3]")
    if not all(x.is_contiguous() for x in (bounds, lp, z, pay)):
        raise ValueError("tile_resolve's inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in (lp, z, pay)):
        raise ValueError("tile_resolve copies lp, z and the payload in 16-byte pieces: "
                         "they must be 16-byte aligned")
    if any(x.device != lp.device for x in (bounds, z, pay)):
        raise ValueError("tile_resolve's inputs must lie on one device")
    out = torch.empty((tiles, 5, TILE), dtype=torch.float32, device=lp.device)
    cuda_build.launch("tile_resolve", "tile_resolve_launch", _TILE_ARGS, lp.device,
                      bounds.data_ptr(), lp.data_ptr(), z.data_ptr(), pay.data_ptr(),
                      out.data_ptr(), tiles, count=("K6",))
    return out


def binned_resolve(lp: torch.Tensor, z: torch.Tensor, pay: torch.Tensor) -> torch.Tensor:
    """Row-6 resolve (see :func:`binned_resolve_reference`): K5 for CUDA
    tensors, the plain version for CPU tensors."""
    if lp.device.type == "cuda":
        return _launch_binned(lp, z, pay)
    if lp.device.type == "cpu":
        return binned_resolve_reference(lp, z, pay)
    raise ValueError(f"binned_resolve: unsupported device {lp.device}")


def tile_resolve(bounds: torch.Tensor, lp: torch.Tensor, z: torch.Tensor,
                 pay: torch.Tensor) -> torch.Tensor:
    """Row-7 resolve (see :func:`tile_resolve_reference`) of
    :func:`prepare_tiles`'s output: K6 for CUDA tensors, the plain version
    for CPU tensors."""
    if lp.device.type == "cuda":
        return _launch_tile(bounds, lp, z, pay)
    if lp.device.type == "cpu":
        return tile_resolve_reference(bounds, lp, z, pay)
    raise ValueError(f"tile_resolve: unsupported device {lp.device}")
