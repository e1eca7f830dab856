"""Port dense grid raster vs the JAX package (CPU).

Live aggregation slots: seeded RGBD lifted to frustum-skirt meshes, projected
from another orbit view. The same window-space inputs go to both packages.

- The port's table prep (``grid_cols`` + ``prep_pack``) equals JAX's
  ``_grid_cols_t`` + ``_prep_pack`` exactly: the same f32 elementwise
  arithmetic and a stable sort on both sides.
- The port's plain raster (what its wrapper runs on a CPU tensor, the CUDA
  kernel's plain version) matches the Pallas kernel interpreted on the CPU
  and the XLA form: coverage, front and depth may differ on at most 0.1% of
  pixels (pixel-centre ties are measure-zero), attributes within 1e-4 where
  both cover (perspective division and tie-sum order).
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

torch.set_num_threads(2)
PIXEL_FRAC, ATTR_TOL = 1e-3, 1e-4


def scene(s, n, spread, seed, with_normals=True):
    """JAX window-space inputs of n slots rendered at r = 3s."""
    rng = np.random.default_rng(seed)
    ii = np.linspace(0, 1, s)
    yy, xx = np.meshgrid(ii, ii, indexing="ij")
    d01 = np.stack([
        np.clip(0.35 + 0.3 * yy + 0.04 * np.sin(xx * 9 + rng.uniform(0, 6))
                + 0.05 * np.sin(xx * 21) * np.sin(yy * 17), 0.05, 0.95)[..., None]
        for _ in range(n)
    ]).astype(np.float32)
    mvs = np.stack([
        np.asarray(jcam.orbit_modelview(rng.uniform(-spread, spread),
                                        rng.uniform(-spread / 2, spread / 2)))
        for _ in range(n)
    ])
    r = 3 * s
    mvp = jcam.perspective(45.0, 1.0, 0.01, 200.0) @ jcam.orbit_modelview(0.1, -0.05)

    @jax.jit
    @jax.vmap
    def one(d, mv):
        mesh = jgeom.depth_to_mesh(
            jgeom.linearize_depth(d, 0.6, 5.0), padding="frustum", modelview=mv,
            atol=0.03, rtol=0.03, erode_rgb=3, cal_normal=with_normals,
        )
        win, w = jraster.project_vertices(mesh.positions, mvp, r)
        if with_normals:
            a = jrend._aggregation_attrs(mesh, "fragment")
        else:
            a = jnp.concatenate([mesh.uv, jrend._unpacked_flags(mesh.flag)[:, :1]], -1)
        return win, w, a, mesh.positions

    return one(jnp.asarray(d01), jnp.asarray(mvs)), s + 2, r


CASES = {
    "agg-16": dict(s=16, n=2, spread=0.3, seed=0, with_normals=True, discard=3),
    "agg-24-wide": dict(s=24, n=2, spread=0.7, seed=1, with_normals=True, discard=3),
    "uv-edge-nodiscard": dict(s=16, n=1, spread=0.3, seed=2, with_normals=False, discard=None),
}


@functools.lru_cache(maxsize=None)
def _inputs(case):
    """JAX inputs, the same as torch tensors, and the port's tables."""
    c = CASES[case]
    (win, w, attrs, pos), g, r = scene(c["s"], c["n"], c["spread"], c["seed"], c["with_normals"])
    A = attrs.shape[-1]
    t = [torch.from_numpy(np.array(x)) for x in (win, w, attrs, pos)]
    tt = trd.prep_pack(trd.grid_cols(*t, g, c["discard"]), r, A)
    return (win, w, attrs, pos), t, g, r, A, tt


@pytest.mark.parametrize("case", ["agg-24-wide", "uv-edge-nodiscard"])
def test_prep_tables_equal_jax(case):
    (win, w, attrs, pos), _, g, r, A, tt = _inputs(case)
    # Eager (op by op), so XLA fuses nothing: under jit it contracts the plane
    # arithmetic differently and its own tables move by ~1e-4.
    jt = jax.vmap(lambda a, b, cc, d: jrd._prep_pack(
        *jrd._grid_cols_t(a, b, cc, d, g, CASES[case]["discard"]), r, A))(win, w, attrs, pos)
    for name, a, b in zip(["lohi", "spans", "glob", "geom", "pay"], jt, tt):
        a = np.asarray(a)
        assert b.shape == a.shape and str(b.numpy().dtype) == str(a.dtype), name
        np.testing.assert_array_equal(b.numpy(), a, err_msg=name)
    if case == "agg-24-wide":
        lohi, glob = tt[0], tt[2]
        assert (glob[:, 1] > glob[:, 0]).all()  # tall triangles in the global range
        assert ((lohi[..., 1] - lohi[..., 0]) > 1).any()  # rows spanning several chunks


def _compare(got: trd.DenseRaster, want, tag):
    cov_w = np.asarray(want.covered)
    cov_g = got.covered.numpy()
    assert cov_w.mean() > 0.3, tag
    assert (cov_g != cov_w).mean() <= PIXEL_FRAC, tag
    assert (got.front.numpy() != np.asarray(want.front)).mean() <= PIXEL_FRAC, tag
    dz = np.abs(got.depth.numpy() - np.asarray(want.depth))
    assert (dz > 1e-6).mean() <= PIXEL_FRAC, tag
    both = cov_g & cov_w & (dz <= 1e-6)
    err = np.abs(got.attrs.numpy() - np.asarray(want.attrs))[both]
    assert err.max() <= ATTR_TOL, (tag, err.max())


@pytest.mark.parametrize("case", list(CASES))
def test_plain_raster_matches_pallas_interpret_and_xla(case, monkeypatch):
    (win, w, attrs, pos), t, g, r, A, tt = _inputs(case)
    discard = CASES[case]["discard"]
    before = cuda_build.launches.copy()
    got = trd.rasterize_grid_dense_batched(*t, g, r, discard_attr=discard)
    assert cuda_build.launches == before  # a CPU tensor never reaches the kernel wrapper's launch
    direct = trd.raster_rows_reference(tt, r, A)
    for a, b in zip(got, direct):
        assert torch.equal(a, b)
    pallas = jrd.rasterize_grid_dense_batched(win, w, attrs, pos, g, r,
                                              discard_attr=discard, interpret=True)
    _compare(got, pallas, "pallas-interpret")
    monkeypatch.setenv("IVID_TPU_SKIRT_IMPL", "xla")
    xla = jrd.rasterize_grid_dense_batched(win, w, attrs, pos, g, r, discard_attr=discard)
    _compare(got, xla, "xla")


def test_non_cuda_accelerator_raises():
    _, t, g, r, A, _ = _inputs("uv-edge-nodiscard")
    cols = trd.grid_cols(*[x.to("meta") for x in t], g, None)
    with pytest.raises(ValueError):
        trd.raster(cols, r, A)
    with pytest.raises(ValueError):
        trd.bin_tiles(cols, r)
