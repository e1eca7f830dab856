"""Port geometry, image ops and condition aggregation vs the JAX package (CPU).

Tolerances and why:
- geometry: positions/normals 1e-5 (f32 matrix inverse and products in
  another order), uv/flags/faces exactly;
- image ops: exactly, except the Lanczos resize, which may move a value by one
  8-bit step where the f32 resampling sum lands on a rounding boundary;
- ``aggregate_conditions`` (JAX under ``IVID_TPU_RASTER_MODE=full``, its
  dense XLA raster): masks differ on at most 1% of pixels and color/depth by
  at most 0.01 in mean where both masks agree (pixel-centre ties on mesh
  edges and the skirt's 1e-8-weight depth branch are knife edges).
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ivid_tpu.ops import camera as jcam
from ivid_tpu.ops import geometry as jgeom
from ivid_tpu.ops import image as jim
from ivid_tpu.ops import warp as jwarp
from ivid_tpu_torch.ops import geometry as tgeom
from ivid_tpu_torch.ops import image as tim
from ivid_tpu_torch.ops import warp as twarp

torch.set_num_threads(2)
NEAR, FAR, FOV = 0.6, 5.0, 45.0


def depth01(s, seed, step=False):
    rng = np.random.default_rng(seed)
    ii = np.linspace(0, 1, s)
    yy, xx = np.meshgrid(ii, ii, indexing="ij")
    d = 0.35 + 0.15 * yy + 0.03 * np.sin(xx * 4 + rng.uniform(0, 6))
    if step:  # so the discontinuity and erosion flags fire
        d = d + 0.25 * (xx > 0.6)
    return np.clip(d, 0.05, 0.95).astype(np.float32)[..., None]


def mesh_pair(d01, mv):
    kw = dict(padding="frustum", fov=FOV, atol=0.03, rtol=0.03, erode_rgb=3, cal_normal=True)
    j = jgeom.depth_to_mesh(jgeom.linearize_depth(jnp.asarray(d01), NEAR, FAR),
                            modelview=jnp.asarray(mv), **kw)
    t = tgeom.depth_to_mesh(tgeom.linearize_depth(torch.from_numpy(d01), NEAR, FAR),
                            modelview=torch.from_numpy(np.array(mv)), **kw)
    return j, t


def test_depth_to_mesh_with_frustum_skirt_matches():
    j, t = mesh_pair(depth01(16, 0, step=True), np.asarray(jcam.orbit_modelview(0.2, -0.1)))
    for f in ("uv", "flag", "faces", "depth", "modelview"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), err_msg=f)
    for f in ("positions", "normal"):
        np.testing.assert_allclose(getattr(t, f).numpy(), np.asarray(getattr(j, f)),
                                   atol=1e-5, rtol=0, err_msg=f)
    flag = t.flag.numpy()
    edge, pad, eroded = (np.mod(np.floor(flag / b), 2) == 1 for b in (1, 2, 4))
    assert pad.sum() == 4 * 17 and edge.any() and eroded.any() and not edge.all()
    assert t.positions.shape == (18 * 18, 3) and t.faces.shape == (2 * 17 * 17, 3)


def test_image_ops_match():
    rng = np.random.default_rng(1)
    img = rng.uniform(-0.1, 1.1, (2, 48, 48, 3)).astype(np.float32)
    got = tim.resize_lanczos_8bit(torch.from_numpy(img), 16).numpy()
    want = np.stack([np.asarray(jim.resize_lanczos_8bit(jnp.asarray(x), 16)) for x in img])
    assert np.abs(got - want).max() <= 1.0 / 255 + 1e-6
    assert (got != want).mean() < 0.01
    np.testing.assert_array_equal(
        tim.ssaa_subsample(torch.from_numpy(img), 3).numpy(),
        np.stack([np.asarray(jim.ssaa_subsample(jnp.asarray(x), 3)) for x in img]))
    mask = rng.uniform(size=(48, 48, 1)) > 0.3
    np.testing.assert_array_equal(tim.coverage_mask(torch.from_numpy(mask), 3).numpy(),
                                  np.asarray(jim.coverage_mask(jnp.asarray(mask), 3)))
    d = depth01(16, 2)
    np.testing.assert_array_equal(tgeom.depth_edge(torch.from_numpy(d), 0.03, 0.03).numpy(),
                                  np.asarray(jgeom.depth_edge(jnp.asarray(d), 0.03, 0.03)))
    m = (rng.uniform(size=(16, 16, 1)) > 0.2).astype(np.float32)
    np.testing.assert_array_equal(tgeom.erode(torch.from_numpy(m), 2).numpy(),
                                  np.asarray(jgeom.erode(jnp.asarray(m), 2)))
    np.testing.assert_allclose(
        tgeom.project_depth(tgeom.linearize_depth(torch.from_numpy(d), NEAR, FAR), NEAR, FAR).numpy(),
        np.asarray(jgeom.project_depth(jgeom.linearize_depth(jnp.asarray(d), NEAR, FAR), NEAR, FAR)),
        atol=1e-6, rtol=0)


def _scene(n_views, s, seed):
    rng = np.random.default_rng(seed)
    mvs = [np.asarray(jcam.orbit_modelview(rng.uniform(-0.35, 0.35), rng.uniform(-0.2, 0.2)))
           for _ in range(n_views + 1)]
    pairs = [mesh_pair(depth01(s, seed * 10 + v), mvs[v]) for v in range(n_views)]
    colors = rng.uniform(0, 1, (n_views, s, s, 3)).astype(np.float32)
    return pairs, colors, mvs[n_views]


def test_aggregate_conditions_matches_jax_full_mode(monkeypatch):
    monkeypatch.setenv("IVID_TPU_RASTER_MODE", "full")
    s, n = 16, 2
    pairs, colors, target = _scene(n, s, seed=3)
    kw = dict(fov=FOV, near=NEAR, far=FAR, atol=0.03, rtol=0.03, erode_rgb=3, ssaa=3)
    jm = jax.tree.map(lambda *x: jnp.stack(x), *[p[0] for p in pairs])
    want = jax.jit(lambda m, c, mv: jwarp.aggregate_conditions(
        m, c, jnp.ones((n,), bool), mv, **kw))(jm, jnp.asarray(colors), jnp.asarray(target))
    tm = tgeom.stack_meshes([p[1] for p in pairs])
    got = twarp.aggregate_conditions(tm, torch.from_numpy(colors),
                                     torch.from_numpy(np.array(target)), **kw)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert want["mask"].mean() > 0.3 and want["mask_rgb"].mean() > 0.2
    for k in ("mask", "mask_rgb"):
        assert (got[k] != want[k]).mean() <= 0.01, k
    agree = (got["mask"] == want["mask"]) & (got["mask_rgb"] == want["mask_rgb"])
    for k in ("color", "depth", "depth_convex"):
        a = np.broadcast_to(agree, got[k].shape)
        assert np.abs(got[k] - want[k])[a].mean() <= 0.01, k


def test_render_aggregation_matches_jax_full_mode(monkeypatch):
    """The fused render before the condition tail, at r=48 (SSAA 3 of 16²):
    masks differ on at most 1% of pixels, color and linear depth by at most
    1e-4 where both masks agree (the same edge-tie knife edges as above;
    measured: equal masks, 1.7e-5 at most)."""
    from ivid_tpu.ops import renderer as jrend
    from ivid_tpu_torch.ops import renderer as trend

    monkeypatch.setenv("IVID_TPU_RASTER_MODE", "full")
    s, n, r = 16, 3, 48
    pairs, colors, target = _scene(n, s, seed=6)
    jm = jax.tree.map(lambda *x: jnp.stack(x), *[p[0] for p in pairs])
    want = jrend.render_aggregation(jm, jnp.asarray(colors), jnp.ones((n,), bool),
                                    jnp.asarray(target), FOV, r)
    got = trend.render_aggregation(tgeom.stack_meshes([p[1] for p in pairs]),
                                   torch.from_numpy(colors), torch.from_numpy(np.array(target)),
                                   FOV, r)
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    assert got["color"].shape == (r, r, 3) and got["depth"].shape == (r, r, 1)
    assert want["mask_depth"].mean() > 0.3
    for k in ("mask_color", "mask_depth"):
        assert (got[k] != want[k]).mean() <= 0.01, k
    agree = (got["mask_color"] == want["mask_color"]) & (got["mask_depth"] == want["mask_depth"])
    for k in ("color", "depth"):
        a = np.broadcast_to(agree, got[k].shape)
        np.testing.assert_allclose(got[k][a], want[k][a], atol=1e-4, rtol=1e-4, err_msg=k)


def test_batched_conditions_equal_per_sample():
    """One launch over B samples' slots gives each sample's own result."""
    s, n = 16, 2
    scenes = [_scene(n, s, seed) for seed in (4, 5)]
    kw = dict(fov=FOV, near=NEAR, far=FAR, atol=0.03, rtol=0.03, erode_rgb=3, ssaa=3)
    meshes = [tgeom.stack_meshes([p[1] for p in sc[0]]) for sc in scenes]
    colors = [torch.from_numpy(sc[1]) for sc in scenes]
    targets = [torch.from_numpy(np.array(sc[2])) for sc in scenes]
    batched = twarp.aggregate_conditions_batch(
        tgeom.stack_meshes(meshes), torch.stack(colors), torch.stack(targets), **kw)
    for b in range(2):
        single = twarp.aggregate_conditions(meshes[b], colors[b], targets[b], **kw)
        for k, v in single.items():
            torch.testing.assert_close(batched[k][b], v, rtol=0, atol=0)


def test_camera_ops_match():
    """Projection, homogeneous and direction transforms, camera positions
    (f32; 1e-5 for the inverse-based camera position)."""
    from ivid_tpu_torch.ops import camera as tcam

    mv = np.array(jcam.orbit_modelview(0.3, -0.2))
    pts = np.random.default_rng(0).standard_normal((5, 3)).astype(np.float32)
    np.testing.assert_array_equal(tcam.perspective(45.0, 1.0, 0.01, 200.0).numpy(),
                                  np.asarray(jcam.perspective(45.0, 1.0, 0.01, 200.0)))
    tmv, tp = torch.from_numpy(mv), torch.from_numpy(pts)
    for t_fn, j_fn in ((tcam.transform_points, jcam.transform_points),
                       (tcam.transform_points_h, jcam.transform_points_h),
                       (tcam.transform_dirs, jcam.transform_dirs)):
        np.testing.assert_allclose(t_fn(tmv, tp).numpy(), np.asarray(j_fn(mv, pts)),
                                   atol=1e-6, rtol=0)
    np.testing.assert_allclose(tcam.camera_position(tmv).numpy(),
                               np.asarray(jcam.camera_position(mv)), atol=1e-5, rtol=0)
