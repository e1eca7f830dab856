"""Per-pixel dense raster of stacked grid meshes or triangle sets, plain
PyTorch: the plane columns (:func:`grid_cols`, :func:`tri_cols`), the
y-sorted chunk tables (:func:`prep_pack`), the row-panel z-test
(:func:`raster_rows_reference`) and the tie-averaging finish
(:func:`finish`).

A frozen copy of the plain version of ``ivid_tpu_torch/ops/raster_dense.py``
(which the port's CPU tests hold to the JAX package), without its CUDA
kernel K2: the benchmark's reference runs it on whatever device it is
given."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from port_bench.reference.geometry import triangulate_face_type
from port_bench.reference.raster import gather_corners

FAR = 9.0  # empty z-buffer value; valid window z lies in [0, 1]
TC = 128  # triangles per chunk
BIG_SPAN = 32.0  # window-y span above which a triangle skips y-binning



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


def raster(cols: Cols, r: int, A: int) -> DenseRaster:
    """Rasterize plane columns into B stacked r x r buffers by the plain
    version (:func:`prep_pack`, :func:`raster_rows_reference`), on any
    device. Returns a DenseRaster over B·r² flat pixels; buffer b owns ids
    [b·r², (b+1)·r²)."""
    return raster_rows_reference(prep_pack(cols, r, A), r, A)


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
