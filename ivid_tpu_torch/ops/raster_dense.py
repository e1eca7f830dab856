"""Per-pixel dense raster of stacked grid meshes or triangle sets: the plane
columns, the binned CUDA kernel K2 and its plain versions.

Port of the dense paths of ``ivid_tpu/ops/raster_dense.py``. :func:`grid_cols`
(``_grid_cols_t``) builds per-triangle affine plane coefficients straight from
grid slices, :func:`tri_cols` (``_planes_from_corners``) the same columns for
indexed triangles (the warp renders' skirt rings). :func:`raster` rasterizes
them into a :class:`DenseRaster`:

- On CUDA tensors, K2 (``csrc/dense_raster.cu``, which replaces the TPU
  kernels ``ivid_tpu/ops/raster_dense.py:_dense_kernel_impl`` and
  ``_dense_kernel`` and the finish after them; the source note says what
  bounds it): :func:`bin_tiles` lays the columns out triangle-major and
  lists each 16x16 screen tile's triangles, and :func:`raster_tiles` walks
  every tile's list with one thread per pixel and writes the finished
  fields.
- On CPU tensors, the plain version: :func:`prep_pack` (``_prep_pack``)
  y-sorts the columns into 128-triangle chunks with per-row chunk ranges,
  :func:`raster_rows_reference` z-tests every pixel centre against its row's
  chunks, and :func:`finish` (``_pallas_finish``) tie-averages the winners'
  payload planes and evaluates the attributes perspective-correctly.

:func:`bin_tiles_reference` and :func:`raster_tiles_reference` transcribe the
two halves of K2 in plain PyTorch (the bins, the depth-only walk, the tie
walk by triangle id and the finish). The tests hold them to the plain
version; no wrapper runs them.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple, Optional

import torch

from ivid_tpu_torch import cuda_build
from ivid_tpu_torch.ops.geometry import triangulate_face_type
from ivid_tpu_torch.ops.raster import gather_corners
from ivid_tpu_torch.utils.profiling import span

FAR = 9.0  # empty z-buffer value; valid window z lies in [0, 1]
TC = 128  # triangles per chunk
BIG_SPAN = 32.0  # window-y span above which a triangle skips y-binning

TILE = 16  # K2's screen tiles are TILE x TILE pixels
_U32 = 2.0 ** -24  # f32 unit roundoff
_U64 = 2.0 ** -53  # f64 unit roundoff

# Host seconds :func:`bin_tiles` has waited for the card to give the length
# of the tiles' lists (one wait per raster call), since last reset.
sync_s = 0.0


def pwp(A: int) -> int:
    """Payload planes per chunk for A attribute channels: 3A+5 (a/b/c per
    channel, the 1/w planes, front, ones) rounded up to a multiple of 8."""
    return -(-(3 * A + 5) // 8) * 8


class Cols(NamedTuple):
    """Per-triangle plane columns of B meshes, each [B, T]."""

    geom: list  # 18: x/y/const of e0, e1, e2, z, D (discard), front
    pay: list  # 3A+4: attr/w a (A), b (A), c (A), 1/w a, b, c, front
    ymin: torch.Tensor  # window-y span of the corners (+inf/-inf if invalid)
    ymax: torch.Tensor
    valid: torch.Tensor  # bool
    xmin: torch.Tensor  # window-x span of the corners (+inf/-inf if invalid)
    xmax: torch.Tensor


class DenseRaster(NamedTuple):
    """Per-pixel raster output in flat window order (row 0 = window bottom)."""

    attrs: torch.Tensor  # [npix, A] winner attrs (tie-averaged), 0 where empty
    depth: torch.Tensor  # [npix] window z, 1.0 where empty
    front: torch.Tensor  # [npix] bool, winners mostly front-facing
    covered: torch.Tensor  # [npix] bool


def grid_cols(win, w, attrs, positions, grid_size: int, discard_attr: Optional[int]):
    """Per-triangle plane columns of B regular-grid meshes.

    ``win`` [B, V, 3], ``w`` [B, V], ``attrs`` [B, V, A], ``positions``
    [B, V, 3] with V = g². Triangles come in block order (all first faces of
    the grid cells, then all second faces), matching ``geometry.triangulate``'s
    (tr, tl, ft ? br : bl) and (bl, br, ft ? tl : tr). Returns
    :class:`Cols`: 18 geometry columns (x/y/const of e0, e1, e2, z, D, front),
    3A+4 payload columns, the corners' spans and validity, all [B, T]."""
    g = grid_size
    B = win.shape[0]
    ft = triangulate_face_type(positions.reshape(B, g, g, 3)).reshape(B, -1)

    def corners(vals):
        G = vals.reshape(B, g, g)
        tl = G[:, :-1, :-1].reshape(B, -1)
        tr = G[:, :-1, 1:].reshape(B, -1)
        bl = G[:, 1:, :-1].reshape(B, -1)
        br = G[:, 1:, 1:].reshape(B, -1)
        c0 = torch.cat([tr, bl], dim=1)
        c1 = torch.cat([tl, br], dim=1)
        c2 = torch.cat([torch.where(ft, br, bl), torch.where(ft, tl, tr)], dim=1)
        return c0, c1, c2

    return _cols_from_corners(corners, win, w, attrs, discard_attr)


def tri_cols(win, w, attrs, tris, discard_attr: Optional[int]):
    """:func:`grid_cols` for an indexed triangle set (the JAX package's
    ``_planes_from_corners`` + ``_pallas_prep`` columns): ``win`` [B, V, 3],
    ``w`` [B, V], ``attrs`` [B, V, A]; ``tris`` [T, 3] shared or [B, T, 3]
    per buffer, in their own order."""
    B = win.shape[0]
    if tris.dim() == 2:
        tris = tris.expand(B, -1, -1)

    def corners(vals):
        c = gather_corners(vals[..., None], tris)[..., 0]  # [B, T, 3]
        return c[..., 0], c[..., 1], c[..., 2]

    return _cols_from_corners(corners, win, w, attrs, discard_attr)


def _cols_from_corners(corners, win, w, attrs, discard_attr: Optional[int]):
    """Plane columns from ``corners(vals [B, V]) -> 3 × [B, T]`` corner values:
    edge functions, window z, 1/w and attr/w planes, with the invalid-z and
    backface-discard folds, rounded in the JAX package's order."""
    A = attrs.shape[-1]
    x0, x1, x2 = corners(win[..., 0])
    y0, y1, y2 = corners(win[..., 1])
    z0, z1, z2 = corners(win[..., 2])
    w0, w1, w2 = corners(w)

    one = torch.ones_like(w0)
    valid = (w0 > 1e-6) & (w1 > 1e-6) & (w2 > 1e-6)
    iw0 = 1.0 / torch.where(w0 > 1e-6, w0, one)
    iw1 = 1.0 / torch.where(w1 > 1e-6, w1, one)
    iw2 = 1.0 / torch.where(w2 > 1e-6, w2, one)

    dx10, dy10 = x1 - x0, y1 - y0
    dx20, dy20 = x2 - x0, y2 - y0
    area2 = dx10 * dy20 - dx20 * dy10
    front = area2 > 0.0
    valid = valid & (area2.abs() > 1e-12)
    sgn = torch.where(area2 >= 0.0, one, -one)
    safe = torch.where(area2.abs() > 1e-12, area2, one)

    def edge(px, py, qx, qy):
        dx, dy = qx - px, qy - py
        return -dy * sgn, dx * sgn, (dy * px - dx * py) * sgn

    ea0, eb0, ec0 = edge(x0, y0, x1, y1)
    ea1, eb1, ec1 = edge(x1, y1, x2, y2)
    ea2, eb2, ec2 = edge(x2, y2, x0, y0)

    def plane(f0, f1, f2):
        a = ((f1 - f0) * dy20 - (f2 - f0) * dy10) / safe
        b = ((f2 - f0) * dx10 - (f1 - f0) * dx20) / safe
        return a, b, f0 - a * x0 - b * y0

    za, zb, zc = plane(z0, z1, z2)
    wa, wb, wc = plane(iw0, iw1, iw2)
    aa, ab, ac = [], [], []
    for i in range(A):
        a0, a1, a2 = corners(attrs[..., i])
        pa, pb, pc = plane(a0 * iw0, a1 * iw1, a2 * iw2)
        aa.append(pa)
        ab.append(pb)
        ac.append(pc)

    # Folds: an invalid triangle's z plane is the constant FAR (fails the
    # z-range test); the backface-padding discard is one plane D = dnum − 0.001·dden.
    zero = torch.zeros_like(w0)
    za_f = torch.where(valid, za, zero)
    zb_f = torch.where(valid, zb, zero)
    zc_f = torch.where(valid, zc, torch.full_like(zc, FAR))
    if discard_attr is not None:
        da = aa[discard_attr] - 0.001 * wa
        db = ab[discard_attr] - 0.001 * wb
        dc = ac[discard_attr] - 0.001 * wc
    else:
        da, db, dc = zero, zero, torch.full_like(zero, -1.0)
    frontf = front.float()

    geom_cols = [
        ea0, eb0, ec0, ea1, eb1, ec1, ea2, eb2, ec2,
        za_f, zb_f, zc_f, da, db, dc, zero, zero, frontf,
    ]
    pay_cols = aa + ab + ac + [wa, wb, wc, frontf]
    inf = torch.full_like(y0, float("inf"))

    def span(v0, v1, v2):
        return (torch.where(valid, torch.minimum(torch.minimum(v0, v1), v2), inf),
                torch.where(valid, torch.maximum(torch.maximum(v0, v1), v2), -inf))

    ymin, ymax = span(y0, y1, y2)
    xmin, xmax = span(x0, x1, x2)
    return Cols(geom_cols, pay_cols, ymin, ymax, valid, xmin, xmax)


def prep_pack(cols: Cols, r: int, A: int):
    """The plain version's tables from plane columns: y-sort (small triangles
    by ymin, then tall ones, then invalid), 128-triangle chunks, per-row chunk
    ranges. Returns, per buffer (leading B): ``lohi [B, r, 2]``, ``spans
    [B, nc, 2]``, ``glob [B, 2]`` (int32), ``geom [B, nc·8, 6·128]``, ``pay
    [B, nc·PWP, 128]`` (f32), in local chunk ids and window y."""
    geom_cols, pay_cols, ymin, ymax, valid = cols[:5]
    B, T = geom_cols[0].shape
    dev = geom_cols[0].device
    nc = -(-T // TC)
    Tp = nc * TC
    pad = Tp - T
    big = (ymax - ymin) > BIG_SPAN
    small = valid & ~big

    key = torch.where(
        small, torch.clamp(ymin, -1e6, 1e6),
        torch.where(valid, torch.full_like(ymin, 2e6), torch.full_like(ymin, 3e6)),
    )
    key_s, order = torch.sort(key, dim=1, stable=True)
    n_small = small.sum(dim=1)
    n_valid = valid.sum(dim=1)

    P = pwp(A)
    ng, npay = 18, 3 * A + 4
    packed = torch.stack(
        geom_cols + pay_cols
        + [torch.clamp(ymin, -1e6, 1e6), torch.clamp(ymax, -1e6, 1e6)],
        dim=-1,
    ).float()
    K = packed.shape[-1]
    packed = torch.gather(packed, 1, order[..., None].expand(B, T, K))
    if pad:
        # Padding rows: the z plane is the constant FAR, the y-span empty.
        fill = torch.zeros((B, pad, K), dtype=torch.float32, device=dev)
        fill[..., 11] = FAR
        fill[..., ng + npay] = 1e6
        fill[..., ng + npay + 1] = -1e6
        packed = torch.cat([packed, fill], dim=1)

    # geom [nc·8, 6·TC]: per chunk, rows 0-2 = x/y/const coefficients over
    # plane-major columns; rows 3-7 are zero (kept for the TPU table layout).
    g3 = packed[..., :ng].reshape(B, nc, TC, 6, 3).permute(0, 1, 4, 3, 2)
    geom = torch.zeros((B, nc, 8, 6 * TC), dtype=torch.float32, device=dev)
    geom[:, :, :3] = g3.reshape(B, nc, 3, 6 * TC)
    geom = geom.reshape(B, nc * 8, 6 * TC)

    # pay [nc·PWP, TC]: payload planes on rows, triangles on columns; the ones
    # (winner count) row follows the gathered columns.
    payp = torch.cat(
        [
            packed[..., ng: ng + npay],
            torch.ones((B, Tp, 1), device=dev),
            torch.zeros((B, Tp, P - npay - 1), device=dev),
        ],
        dim=-1,
    )
    pay = payp.reshape(B, nc, TC, P).permute(0, 1, 3, 2).reshape(B, nc * P, TC)

    ymin_s = packed[..., ng + npay]
    ymax_s = packed[..., ng + npay + 1]

    # Per-row band ranges over the small-triangle prefix. hi: first triangle
    # with ymin > row+1; lo: first index whose running-max ymax reaches the
    # row, so [lo, hi) is a superset of the row's small triangles.
    rows = torch.arange(r, dtype=torch.float32, device=dev).expand(B, r).contiguous()
    is_small = key_s < 1.5e6
    key_pad = torch.cat([key_s, torch.full((B, pad), 3e6, device=dev)], dim=1)
    hi_tri = torch.searchsorted(key_pad.contiguous(), rows + 1.0, right=True)
    small_pad = torch.cat([is_small, torch.zeros((B, pad), dtype=torch.bool, device=dev)], dim=1)
    cm = torch.cummax(
        torch.where(small_pad, ymax_s, torch.full_like(ymax_s, -float("inf"))), dim=1
    ).values
    lo_tri = torch.searchsorted(cm.contiguous(), rows, right=False)
    lohi = torch.stack([lo_tri // TC, -(-hi_tri // TC)], dim=-1).int()

    cymin = ymin_s.reshape(B, nc, TC).amin(dim=2)
    cymax = ymax_s.reshape(B, nc, TC).amax(dim=2)
    spans = torch.stack([torch.floor(cymin), torch.ceil(cymax)], dim=-1).int()
    glob = torch.stack([n_small // TC, -(-n_valid // TC)], dim=-1).int()
    return lohi, spans, glob, geom, pay


def finish(out: torch.Tensor, r: int, A: int) -> DenseRaster:
    """Winner z and tie-summed payload planes [npix, 1+PWP] → DenseRaster:
    average the ties and evaluate attr = (attr/w plane) / (1/w plane)."""
    npix = out.shape[0]
    zbuf = out[:, 0]
    acc = out[:, 1:]
    covered = zbuf < 1.5
    cnt = acc[:, 3 * A + 4]
    sel = acc / torch.clamp(cnt, min=1.0)[:, None]
    pid = torch.arange(npix, device=out.device)
    qx = (pid % r).float() + 0.5
    qy = ((pid // r) % r).float() + 0.5
    s_aa, s_ab, s_ac = sel[:, :A], sel[:, A:2 * A], sel[:, 2 * A:3 * A]
    num = qx[:, None] * s_aa + qy[:, None] * s_ab + s_ac
    den = qx * sel[:, 3 * A] + qy * sel[:, 3 * A + 1] + sel[:, 3 * A + 2]
    attr_px = num / torch.clamp(den, min=1e-12)[:, None]
    frontn = acc[:, 3 * A + 3]
    return DenseRaster(
        attrs=torch.where(covered[:, None], attr_px, torch.zeros_like(attr_px)),
        depth=torch.where(covered, zbuf, torch.ones_like(zbuf)),
        front=(frontn * 2 > cnt) & covered,
        covered=covered,
    )


def raster_rows_reference(tables, r: int, A: int) -> DenseRaster:
    """Plain version of K2 on :func:`prep_pack`'s tables:
    :func:`raster_rows_sums`, then :func:`finish`."""
    return finish(raster_rows_sums(tables, r, A), r, A)


def _row_panels(tables, r: int, block_rows: int = 8):
    """The plain version's evaluation (``_xla_raster``'s dense panels): for
    each buffer b and block of rows [y0, y1), every pixel centre of the block
    against every triangle of the chunks whose y-span meets it. Yields ``(b,
    y0, y1, tri, ok, z)``: the triangles' indices in the sorted table [L],
    and coverage and depth [pixels, L] (L may be 0)."""
    _, spans, _, geom, _ = tables
    B = geom.shape[0]
    nc = geom.shape[1] // 8
    dev = geom.device
    g = geom.reshape(B, nc, 8, 6, TC)[:, :, :3]
    g = g.permute(0, 3, 2, 1, 4).reshape(B, 6, 3, nc * TC)  # [B, plane, coef, tri]
    qx_row = torch.arange(r, dtype=torch.float32, device=dev) + 0.5
    for b in range(B):
        for y0 in range(0, r, block_rows):
            y1 = min(r, y0 + block_rows)
            keep = (spans[b, :, 0] <= y1 - 1) & (spans[b, :, 1] >= y0)
            tri = keep[:, None].expand(nc, TC).reshape(-1).nonzero().squeeze(1)
            gb = g[b][:, :, tri]
            qx = qx_row.repeat(y1 - y0)[:, None]
            qy = (torch.arange(y0, y1, dtype=torch.float32, device=dev) + 0.5
                  ).repeat_interleave(r)[:, None]
            e0, e1, e2, z, dpl, fr = (
                qx * gb[k, 0] + (qy * gb[k, 1] + gb[k, 2]) for k in range(6)
            )
            ok = ((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (z >= 0.0) & (z <= 1.0)
                  & ~((fr < 0.5) & (dpl > 0.0)))
            yield b, y0, y1, tri, ok, z


def raster_rows_sums(tables, r: int, A: int, block_rows: int = 8) -> torch.Tensor:
    """The plain version's panels (:func:`_row_panels`), GL '<' depth test,
    equal-depth winners summed: ``[B·r², 1+PWP]``, the winning z, then the
    summed payload planes and the winner count (column 3A+5)."""
    pay = tables[4]
    B = pay.shape[0]
    nc = pay.shape[1] // pwp(A)
    P = pwp(A)
    p = pay.reshape(B, nc, P, TC).permute(0, 2, 1, 3).reshape(B, P, nc * TC)
    out = torch.empty((B, r, r, 1 + P), dtype=torch.float32, device=pay.device)
    for b, y0, y1, tri, ok, z in _row_panels(tables, r, block_rows):
        if tri.numel() == 0:
            out[b, y0:y1, :, 0] = FAR
            out[b, y0:y1, :, 1:] = 0.0
            continue
        zm = torch.where(ok, z, torch.full_like(z, FAR))
        zmin = zm.amin(dim=1)
        win = (ok & (zm == zmin[:, None])).float()
        sums = win @ p[b][:, tri].T
        out[b, y0:y1] = torch.cat([zmin[:, None], sums], dim=1).reshape(y1 - y0, r, 1 + P)
    return out.reshape(B * r * r, 1 + P)


def covered_pairs(tables, r: int) -> int:
    """The (pixel, triangle) pairs in which the triangle covers the pixel
    centre, by the plain version's evaluation on :func:`prep_pack`'s tables."""
    return sum(int(ok.sum()) for *_, ok, _ in _row_panels(tables, r))


def _tile_bins(geom: torch.Tensor, r: int):
    """Transcription of the bin kernels' per-triangle test (``make_bin``,
    ``may_cover`` in ``csrc/dense_raster.cu``, the same f64 operations in the
    same order): ``[B, T, nt²]`` bool, True where the triangle's pixel centres
    may lie in the tile (invalid triangles not yet removed)."""
    dev = geom.device
    R = float(r)
    nt = -(-r // TILE)
    g = geom[..., :9].double().reshape(geom.shape[:-1] + (3, 3))
    a, b, c = g[..., 0], g[..., 1], g[..., 2]  # [B, T, edge]
    mag = R * (a.abs() + b.abs()) + c.abs()
    risky = ~(mag < 1e37).all(-1)
    C = c + (8 * _U32 * mag + 1e-30)
    i, j = [0, 1, 2], [1, 2, 0]
    det = a[..., i] * b[..., j] - a[..., j] * b[..., i]
    bounded = (det > 0).all(-1) | (det < 0).all(-1)
    p, q = b[..., i] * C[..., j], b[..., j] * C[..., i]
    u, v = a[..., j] * C[..., i], a[..., i] * C[..., j]
    inv = 1.0 / det
    x, y = (p - q) * inv, (u - v) * inv
    ex = 4 * _U64 * ((p.abs() + q.abs()) * inv.abs() + x.abs())
    ey = 4 * _U64 * ((u.abs() + v.abs()) * inv.abs() + y.abs())
    finite = (x.isfinite() & y.isfinite() & ex.isfinite() & ey.isfinite()).all(-1)
    box = bounded & finite & ~risky

    def pixels(lo, hi):
        top = R + 2.0
        p0 = torch.ceil(lo.clamp(-2.0, top) - 0.5).clamp(min=0)
        p1 = torch.floor(hi.clamp(-2.0, top) - 0.5).clamp(max=r - 1)
        return p0, p1

    px0, px1 = pixels((x - ex).amin(-1), (x + ex).amax(-1))
    py0, py1 = pixels((y - ey).amin(-1), (y + ey).amax(-1))
    nonempty = (px0 <= px1) & (py0 <= py1)
    t = torch.arange(nt, device=dev)
    tx, ty = t.repeat(nt), t.repeat_interleave(nt)  # tile id = ty * nt + tx

    def in_range(p0, p1, tt):
        lo = torch.where(box, torch.div(p0, TILE, rounding_mode="floor"), 0.0)
        hi = torch.where(box, torch.div(p1, TILE, rounding_mode="floor"), nt - 1.0)
        return (tt >= lo[..., None]) & (tt <= hi[..., None])

    keep = in_range(px0, px1, tx) & in_range(py0, py1, ty) & (nonempty | ~box)[..., None]
    cx0 = (tx * TILE + 0.5).double()
    cx1 = (torch.clamp(tx * TILE + TILE, max=r) - 0.5).double()
    cy0 = (ty * TILE + 0.5).double()
    cy1 = (torch.clamp(ty * TILE + TILE, max=r) - 0.5).double()
    for k in range(3):
        ak, bk, ck = a[..., k, None], b[..., k, None], C[..., k, None]
        m = ak * torch.where(ak >= 0, cx1, cx0) + bk * torch.where(bk >= 0, cy1, cy0) + ck
        keep &= ~(m < 0) | risky[..., None]
    return keep


def bin_tiles_reference(geom: torch.Tensor, valid: torch.Tensor, r: int,
                        capacity: Optional[int] = None):
    """Plain version of K2's bins: ``(offsets [B·nt² + 1], ids)`` int32, tile
    ``b·nt² + ty·nt + tx`` (nt = ceil(r/16)) listing the valid triangles whose
    pixel centres may lie in it, in ascending triangle id (the kernel's lists
    hold the same ids in the order its atomics gave). With ``capacity``, ids
    keeps only its first ``capacity`` entries, as the fill kernel writes no
    entry past it, and the offsets still hold the true total."""
    keep = _tile_bins(geom, r) & valid[..., None]
    counts = keep.sum(1).reshape(-1)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).int()
    ids = keep.permute(0, 2, 1).nonzero()[:, 2].int()
    return offsets, ids if capacity is None else ids[:capacity]


def _walk(g, qx, qy):
    """Coverage and depth of pixel centres ``qx``/``qy`` [P] against
    triangles ``g`` [L, 18], as K2 evaluates them: ``(ok, z)`` [P, L]."""
    e0, e1, e2, z, dpl, fr = (
        qx[:, None] * g[:, 3 * k] + (qy[:, None] * g[:, 3 * k + 1] + g[:, 3 * k + 2])
        for k in range(6)
    )
    ok = ((e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0) & (z >= 0.0) & (z <= 1.0)
          & ~((fr < 0.5) & (dpl > 0.0)))
    return ok, z


def raster_tiles_reference(geom, pay, offsets, ids, r: int, A: int) -> DenseRaster:
    """Plain version of K2's raster over the bins: per tile, the depth-only
    walk of its list (zbuf, winner count, first winner), the payload of a
    lone winner, the tie sums added in ascending triangle id, then
    :func:`finish`."""
    B, T = geom.shape[:2]
    nt = -(-r // TILE)
    npay = 3 * A + 4
    dev = geom.device
    zbuf = torch.full((B * r * r,), FAR, dtype=torch.float32, device=dev)
    acc = torch.zeros((B * r * r, npay), dtype=torch.float32, device=dev)
    cnt = torch.zeros((B * r * r,), dtype=torch.float32, device=dev)
    local = torch.arange(TILE * TILE, device=dev)
    offsets = offsets.tolist()
    for blk in range(B * nt * nt):
        lst = ids[offsets[blk]:offsets[blk + 1]].long()
        if lst.numel() == 0:
            continue
        b, tile = divmod(blk, nt * nt)
        px = (tile % nt) * TILE + local % TILE
        py = (tile // nt) * TILE + local // TILE
        inside = (px < r) & (py < r)
        px, py = px[inside], py[inside]
        pix = (b * r + py) * r + px
        order = torch.argsort(lst)  # the tie sums run in ascending id
        lst = lst[order]
        ok, z = _walk(geom[b, lst], px.float() + 0.5, py.float() + 0.5)
        zm = torch.where(ok, z, torch.full_like(z, FAR))
        zb = zm.amin(dim=1)
        win = ok & (zm == zb[:, None])
        n = win.sum(dim=1)
        p = pay[b, lst]
        sums = torch.zeros((pix.numel(), npay), dtype=torch.float32, device=dev)
        lone = n == 1
        sums[lone] = p[win[lone].float().argmax(dim=1)]
        tied = (n > 1).nonzero().squeeze(1)
        if tied.numel():
            wt = win[tied]
            for k in wt.any(dim=0).nonzero().squeeze(1).tolist():
                sel = tied[wt[:, k]]
                sums[sel] = sums[sel] + p[k]
        zbuf[pix], acc[pix], cnt[pix] = zb, sums, n.float()
    return finish(torch.cat([zbuf[:, None], acc, cnt[:, None]], dim=1), r, A)


# C signatures (csrc/dense_raster.cu): pointers and the stream as c_void_p,
# counts and sizes as c_int.
_BINS_ARGS = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int]
              + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
_TILES_ARGS = ([ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 4
               + [ctypes.c_int] * 4 + [ctypes.c_void_p])


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def bin_tiles(cols: Cols, r: int, capacity: Optional[int] = None):
    """K2's bins of plane columns on the card: ``(geom [B, T, 18], pay [B, T,
    3A+4])``, the columns triangle-major, and ``(offsets, ids)`` as
    :func:`bin_tiles_reference` gives them (each list in another order). The
    count kernel (which also writes geom and pay), the scan of the counts,
    then the fill kernel into lists of the length read back from the card:
    the call waits for the count. With ``capacity``, ids gets that length
    and the call does not wait (a timed run passes the length an earlier
    call on the same columns gave); the kernels write and read no entry of
    ids past it, so a shorter one cuts lists short, and the caller checks
    the returned offsets with :func:`check_capacity` once its timing is
    done. Raises unless the columns are CUDA tensors."""
    global sync_s
    valid = cols.valid
    dev = valid.device
    B, T = valid.shape
    npay = len(cols.pay)
    _check(dev.type == "cuda", f"bin_tiles runs on CUDA tensors only, got {dev}")
    _check(len(cols.geom) == 18 and 7 <= npay <= 37, "bin_tiles takes 18 geometry and 7 to 37 "
           f"payload columns, got {len(cols.geom)} and {npay}")
    columns = list(cols.geom) + list(cols.pay)
    _check(all(c.shape == (B, T) and c.dtype == torch.float32 and c.is_contiguous()
               and c.device == dev for c in columns),
           f"the plane columns must be contiguous float32 [{B}, {T}] on {dev}")
    _check(valid.dtype == torch.bool and valid.is_contiguous(), "valid must be contiguous bool")
    _check(capacity is None or 0 <= capacity < 2 ** 31, f"capacity {capacity} out of range")
    nt = -(-r // TILE)
    ptrs = (ctypes.c_void_p * len(columns))(*[c.data_ptr() for c in columns])
    geom = torch.empty((B, T, 18), dtype=torch.float32, device=dev)
    pay = torch.empty((B, T, npay), dtype=torch.float32, device=dev)
    counts = torch.zeros(B * nt * nt, dtype=torch.int32, device=dev)
    big = torch.empty(B * T, dtype=torch.int32, device=dev)  # ids of the triangles
    nbig = torch.zeros(1, dtype=torch.int32, device=dev)  # with many candidate tiles
    cuda_build.launch("dense_raster", "dense_raster_bins", _BINS_ARGS, dev, ptrs, npay,
                      valid.data_ptr(), geom.data_ptr(), pay.data_ptr(), counts.data_ptr(),
                      None, None, 0, big.data_ptr(), nbig.data_ptr(), B, T, r, 0, count=())
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0, dtype=torch.int32)])
    if capacity is None:
        t0 = time.perf_counter()
        capacity = int(offsets[-1])
        sync_s += time.perf_counter() - t0
    ids = torch.empty(capacity, dtype=torch.int32, device=dev)
    counts.zero_()
    cuda_build.launch("dense_raster", "dense_raster_bins", _BINS_ARGS, dev, ptrs, npay,
                      valid.data_ptr(), geom.data_ptr(), pay.data_ptr(), counts.data_ptr(),
                      offsets.data_ptr(), ids.data_ptr(), capacity, big.data_ptr(),
                      nbig.data_ptr(), B, T, r, 1, count=("K2 bins",))
    return geom, pay, offsets, ids


def check_capacity(offsets: torch.Tensor, capacity: int) -> None:
    """Raises unless the bins' lists fit in ``capacity`` ids: ``offsets[-1]``
    of a :func:`bin_tiles` call holds the true total, and a call given a
    smaller capacity dropped the ids past it. Reading it waits for the card,
    so a timed caller checks the offsets of its last call after the timing."""
    listed = int(offsets[-1])
    if listed > capacity:
        raise RuntimeError(f"K2's bins hold {listed} ids but were given room for {capacity}: "
                           f"{listed - capacity} were dropped")


def raster_tiles(geom, pay, offsets, ids, r: int, A: int) -> DenseRaster:
    """K2's raster over the bins on the card (its plain version is
    :func:`raster_tiles_reference`). Returns a DenseRaster over B·r² flat
    pixels; buffer b owns ids [b·r², (b+1)·r²). Raises unless the inputs are
    CUDA tensors."""
    dev = geom.device
    _check(dev.type == "cuda", f"raster_tiles runs on CUDA tensors only, got {dev}")
    _check(1 <= A <= 11, f"the dense raster kernel takes 1 to 11 attributes, got {A}")
    B, T = geom.shape[:2]
    nt = -(-r // TILE)
    _check(geom.shape == (B, T, 18) and pay.shape == (B, T, 3 * A + 4),
           f"geom/pay must be [B, T, 18]/[B, T, {3 * A + 4}], got "
           f"{tuple(geom.shape)}/{tuple(pay.shape)}")
    _check(offsets.shape == (B * nt * nt + 1,) and ids.dim() == 1 and ids.numel() < 2 ** 31,
           f"offsets must be [{B * nt * nt + 1}] beside ids [N], N < 2^31")
    _check(geom.dtype == pay.dtype == torch.float32 and offsets.dtype == ids.dtype == torch.int32,
           "geom and pay must be float32, offsets and ids int32")
    _check(all(x.is_contiguous() and x.device == dev for x in (pay, offsets, ids))
           and geom.is_contiguous() and geom.data_ptr() % 8 == 0,
           "the raster's inputs must be contiguous on one device (geom 8-byte aligned)")
    npix = B * r * r
    attrs = torch.empty((npix, A), dtype=torch.float32, device=dev)
    depth = torch.empty((npix,), dtype=torch.float32, device=dev)
    front = torch.empty((npix,), dtype=torch.bool, device=dev)
    covered = torch.empty((npix,), dtype=torch.bool, device=dev)
    cuda_build.launch("dense_raster", "dense_raster_tiles", _TILES_ARGS, dev,
                      geom.data_ptr(), pay.data_ptr(), offsets.data_ptr(), ids.data_ptr(),
                      ids.numel(), attrs.data_ptr(), depth.data_ptr(), front.data_ptr(),
                      covered.data_ptr(), B, T, r, A, count=("K2",))
    return DenseRaster(attrs=attrs, depth=depth, front=front, covered=covered)


def raster(cols: Cols, r: int, A: int) -> DenseRaster:
    """Rasterize plane columns into B stacked r x r buffers: K2 (bins, then
    the raster) for CUDA tensors, which launches or raises; the plain version
    (:func:`prep_pack`, :func:`raster_rows_reference`) for CPU tensors.
    Returns a DenseRaster over B·r² flat pixels; buffer b owns ids
    [b·r², (b+1)·r²). Under torch.profiler K2's two calls are the spans
    ``raster_dense.bins`` (with its wait for the lists' length) and
    ``raster_dense.raster``."""
    dev = cols.valid.device
    if dev.type == "cuda":
        with span("raster_dense.bins"):
            bins = bin_tiles(cols, r)
        with span("raster_dense.raster"):
            return raster_tiles(*bins, r, A)
    if dev.type == "cpu":
        return raster_rows_reference(prep_pack(cols, r, A), r, A)
    raise ValueError(f"raster: unsupported device {dev}")


def rasterize_grid_dense_batched(
    win: torch.Tensor,
    w: torch.Tensor,
    attrs: torch.Tensor,
    positions: torch.Tensor,
    grid_size: int,
    render_size: int,
    discard_attr: Optional[int] = None,
) -> DenseRaster:
    """B regular-grid depth meshes (e.g. one per aggregation view slot) in one
    raster launch. ``win`` [B,V,3], ``w`` [B,V], ``attrs`` [B,V,A],
    ``positions`` [B,V,3]. ``discard_attr``: the attribute whose
    perspective-correct value > 0.001 on a back face discards the candidate
    (the aggregation shader's backface-padding discard)."""
    return raster(grid_cols(win, w, attrs, positions, grid_size, discard_attr), render_size,
                  attrs.shape[-1])


def rasterize_tris_dense_batched(
    win: torch.Tensor,
    w: torch.Tensor,
    attrs: torch.Tensor,
    tris: torch.Tensor,
    render_size: int,
    discard_attr: Optional[int] = None,
) -> DenseRaster:
    """One triangle set per vertex set (e.g. one skirt ring per warp sample)
    into B stacked framebuffers with one raster launch. ``win`` [B,V,3], ``w``
    [B,V], ``attrs`` [B,V,A]; ``tris`` [T,3] shared or [B,T,3] per buffer.
    Buffer b owns flat pixels [b·r², (b+1)·r²), the global ids of the batched
    fragment resolve, so :func:`merge_dense` applies per buffer."""
    return raster(tri_cols(win, w, attrs, tris, discard_attr), render_size, attrs.shape[-1])


def rasterize_tris_dense(
    win: torch.Tensor,
    w: torch.Tensor,
    attrs: torch.Tensor,
    tris: torch.Tensor,
    render_size: int,
    discard_attr: Optional[int] = None,
) -> DenseRaster:
    """Exact per-pixel raster of one indexed triangle set: ``win`` [V,3],
    ``w`` [V], ``attrs`` [V,A], ``tris`` [T,3] (the raster launch at B=1)."""
    return rasterize_tris_dense_batched(
        win[None], w[None], attrs[None], tris, render_size, discard_attr
    )


def merge_dense(payload, depth_win, covered, dense_payload, dense: DenseRaster,
                render_size: int):
    """Z-test merge of resolved fragment framebuffers (image row order,
    ``[.., R, R, ·]``) with a dense raster pass over the same buffers (flat
    window order): the strictly nearer source wins; fragment winners keep
    ties."""
    r = render_size
    lead = depth_win.shape[:-2]
    d_depth = torch.flip(dense.depth.reshape(lead + (r, r)), dims=[-2])
    d_cov = torch.flip(dense.covered.reshape(lead + (r, r)), dims=[-2])
    d_pay = torch.flip(dense_payload.reshape(lead + (r, r, -1)), dims=[-3])
    use = d_cov & (~covered | (d_depth < depth_win))
    return (
        torch.where(use[..., None], d_pay, payload),
        torch.where(use, d_depth, depth_win),
        covered | d_cov,
    )
