"""Port dense raster of indexed triangles (the warp renders' skirt rings) vs
the JAX package (CPU).

- Tables: the port's ``tri_cols`` + ``prep_pack`` equal JAX's
  ``_tri_planes`` + ``_pallas_prep`` bit for bit (the same f32 elementwise
  arithmetic, eager on the JAX side, and a stable sort on both), at B=1 and
  per buffer at B=2.
- The plain raster (what a CPU tensor takes, the kernel's plain version)
  against the JAX XLA form and the Pallas kernel interpreted on the CPU:
  coverage, front and depth may differ on at most 0.1% of pixels (pixel-
  centre ties are measure-zero), attributes within 1e-4 where both agree on
  the depth (perspective division and tie-sum order).
- The batched raster equals the per-sample one exactly (the same tables per
  buffer), and ``merge_dense`` equals JAX's exactly (selects only).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivid_tpu.ops import camera as jcam
from ivid_tpu.ops import geometry as jgeom
from ivid_tpu.ops import raster as jraster
from ivid_tpu.ops import raster_dense as jrd
from ivid_tpu.ops import renderer as jrend
from ivid_tpu_torch import cuda_build
from ivid_tpu_torch.ops import raster_dense as trd
from ivid_tpu_torch.ops import renderer as trend

torch.set_num_threads(2)
PIXEL_FRAC, ATTR_TOL = 1e-3, 1e-4


@functools.lru_cache(maxsize=None)
def _rings(s=16, n=2, seed=0):
    """Skirt rings of n seeded depth maps lifted with an s-pixel skirt (the
    warp's first render), seen from jittered views at r = 3s: JAX
    (win, w, attrs, ring faces) per sample."""
    rng = np.random.default_rng(seed)
    ii = np.linspace(0, 1, s)
    yy, xx = np.meshgrid(ii, ii, indexing="ij")
    r = 3 * s
    out = []
    for _ in range(n):
        d01 = np.clip(0.4 + 0.2 * yy + 0.05 * np.sin(xx * 7 + rng.uniform(0, 6)), 0.05, 0.95)
        mesh = jgeom.depth_to_mesh(jgeom.linearize_depth(jnp.asarray(d01[..., None], jnp.float32)),
                                   padding=s, modelview=jcam.look_at(
                                       jnp.array([0.0, 0.0, 1.0]), jnp.zeros(3),
                                       jnp.array([0.0, 1.0, 0.0])))
        eye = np.array([rng.uniform(-0.2, 0.2), rng.uniform(-0.1, 0.1), 1.0], np.float32)
        mv = jcam.look_at(jnp.asarray(eye), jnp.zeros(3), jnp.array([0.0, 1.0, 0.0]))
        mvp = jcam.perspective(45.0, 1.0, 0.1, 200.0) @ mv
        win, w = jraster.project_vertices(mesh.positions, mvp, r)
        attrs = jnp.concatenate([mesh.uv, jrend._unpacked_flags(mesh.flag)[:, :1]], -1)
        _, ring_idx = jrend._ring_face_split(s + 2)
        out.append((win, w, attrs, mesh.faces[jnp.asarray(ring_idx)]))
    return out, r


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def test_ring_split_matches_jax():
    for g in (5, 18):
        for a, b in zip(trend._ring_face_split(g), jrend._ring_face_split(g)):
            np.testing.assert_array_equal(a, b)


def test_tri_tables_equal_jax():
    samples, r = _rings()
    A = 3
    batched = trd.prep_pack(trd.tri_cols(
        *[torch.stack(x) for x in zip(*[_t(*smp) for smp in samples])], None), r, A)
    for b, (win, w, attrs, tris) in enumerate(samples):
        want = jrd._pallas_prep(jrd._tri_planes(win, w, attrs, tris, None), r, A)
        tw, tww, ta, tt = _t(win, w, attrs, tris)
        got = trd.prep_pack(trd.tri_cols(tw[None], tww[None], ta[None], tt, None), r, A)
        for name, g, gb, x in zip(["lohi", "spans", "glob", "geom", "pay"], got, batched, want):
            x = np.asarray(x)
            assert g.shape[1:] == x.shape and str(g.numpy().dtype) == str(x.dtype), name
            np.testing.assert_array_equal(g[0].numpy(), x, err_msg=name)
            np.testing.assert_array_equal(gb[b].numpy(), x, err_msg=name)
    assert (batched[2][:, 1] > batched[2][:, 0]).all()  # tall skirt triangles exist


def _compare(got, want, tag):
    cov_w = np.asarray(want.covered)
    cov_g = got.covered.numpy()
    assert cov_w.mean() > 0.02, tag
    assert (cov_g != cov_w).mean() <= PIXEL_FRAC, tag
    assert (got.front.numpy() != np.asarray(want.front)).mean() <= PIXEL_FRAC, tag
    dz = np.abs(got.depth.numpy() - np.asarray(want.depth))
    assert (dz > 1e-6).mean() <= PIXEL_FRAC, tag
    both = cov_g & cov_w & (dz <= 1e-6)
    err = np.abs(got.attrs.numpy() - np.asarray(want.attrs))[both]
    assert err.max() <= ATTR_TOL, (tag, err.max())


def test_plain_raster_matches_xla_and_pallas_interpret(monkeypatch):
    samples, r = _rings()
    win, w, attrs, tris = samples[0]
    before = cuda_build.launches.copy()
    got = trd.rasterize_tris_dense(*_t(win, w, attrs, tris), r)
    assert cuda_build.launches == before
    _compare(got, jrd.rasterize_tris_dense(win, w, attrs, tris, r, interpret=True), "pallas")
    monkeypatch.setenv("IVID_TPU_SKIRT_IMPL", "xla")
    _compare(got, jrd.rasterize_tris_dense(win, w, attrs, tris, r), "xla")


def test_batched_raster_equals_per_sample():
    samples, r = _rings()
    per = [trd.rasterize_tris_dense(*_t(*smp), r) for smp in samples]
    stacked = [torch.stack(x) for x in zip(*[_t(*smp) for smp in samples])]
    batched = trd.rasterize_tris_dense_batched(*stacked, r)
    for field, a in zip(trd.DenseRaster._fields, batched):
        b = torch.cat([getattr(p, field) for p in per])
        assert torch.equal(a, b), field


def test_merge_dense_matches_jax():
    rng = np.random.default_rng(1)
    r = 8
    pay = rng.uniform(size=(r, r, 4)).astype(np.float32)
    depth = rng.uniform(size=(r, r)).astype(np.float32)
    cov = rng.uniform(size=(r, r)) > 0.3
    dpay = rng.uniform(size=(r * r, 4)).astype(np.float32)
    dense = (rng.uniform(size=(r * r, 3)).astype(np.float32),
             rng.uniform(size=r * r).astype(np.float32), rng.uniform(size=r * r) > 0.5,
             rng.uniform(size=r * r) > 0.5)
    want = jrd.merge_dense(jnp.asarray(pay), jnp.asarray(depth), jnp.asarray(cov),
                           jnp.asarray(dpay), jrd.DenseRaster(*map(jnp.asarray, dense)), r)
    got = trd.merge_dense(*_t(pay, depth, cov, dpay), trd.DenseRaster(*_t(*dense)), r)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # With a leading buffer axis: the same merge per buffer.
    two = trd.merge_dense(*[torch.stack([x, x]) for x in _t(pay, depth, cov)],
                          torch.from_numpy(np.concatenate([dpay, dpay])),
                          trd.DenseRaster(*[torch.cat([x, x]) for x in _t(*dense)]), r)
    for a, b in zip(two, got):
        assert torch.equal(a[1], b)
