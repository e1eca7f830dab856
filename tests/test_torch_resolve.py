"""Port fragment raster and z-buffer resolve vs the JAX package (CPU).

- ``generate_fragments``: the port's barycentric-lattice fragments equal the
  JAX ones on the same triangles (positions, pixels, depth and validity
  exactly up to f32 sum order: at most 0.1% of pixel ids may differ, where a
  sample sits on a pixel edge; attributes within 1e-5 relative: a
  perspective division by interpolated 1/w).
- The resolve: the port's plain version (``resolve_zbuffer_scatter``, what a
  CPU tensor takes, and K3's plain version) against the JAX scatter resolve
  and the JAX tiled Pallas resolve interpreted on the CPU, on fragments with
  empty tiles, a pixel with 1,500 stacked fragments and depth ties, invalid
  fragments carrying NaN payloads, and two buffers. Depth and coverage are
  one minimum and must be equal; the payload is a tie average whose sum
  order differs (1e-6).
- ``raster_tiled.prepare`` (the sort and run starts around K3) fed to a
  numpy walk of the kernel's per-pixel loop gives the same framebuffers: the
  kernel's preparation is held here, its arithmetic on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivid_tpu.ops import raster as jraster
from ivid_tpu.ops import raster_tiled as jtiled
from ivid_tpu_torch.ops import raster as traster
from ivid_tpu_torch.ops import raster_tiled as ttiled

torch.set_num_threads(2)
PAY_TOL = 1e-6


def _fragments(seed, r=16, buffers=2, n=6000):
    """Fragment arrays with global pixel ids over ``buffers`` r² framebuffers:
    uniform pixels over the first half of buffer 0 and buffer 1's first row
    (the rest stays empty), 1,500 fragments on one pixel over three depth
    levels (ties), depths rounded to 1/64 (more ties), ~10% invalid ones
    with NaN payloads and the sentinel pixel id."""
    rng = np.random.default_rng(seed)
    npix = buffers * r * r
    pix = rng.integers(0, r * r // 2, n)
    if buffers > 1:
        pix[: n // 10] = r * r + rng.integers(0, r, n // 10)
    pix[n // 10: n // 10 + 1500] = 37
    depth = np.round(rng.uniform(0, 1, n) * 64) / 64
    depth[n // 10: n // 10 + 1500] = rng.choice([0.25, 0.5, 0.75], 1500)
    valid = rng.uniform(size=n) > 0.1
    payload = rng.uniform(-1, 1, (n, 4)).astype(np.float32)
    payload[~valid] = np.nan
    pix = np.where(valid, pix, npix)
    front = rng.uniform(size=n) > 0.5
    return dict(pixel=pix.astype(np.int64), depth=depth.astype(np.float32), valid=valid,
                front=front, payload=payload), npix


def _port(f, k):
    frag = traster.FragmentBatch(
        pixel=torch.from_numpy(f["pixel"]), depth=torch.from_numpy(f["depth"]),
        attrs=torch.zeros((len(f["depth"]), 1)), front=torch.from_numpy(f["front"]),
        valid=torch.from_numpy(f["valid"]))
    return [frag], [torch.from_numpy(f["payload"][:, :k])]


def _jax(f, k):
    frag = jraster.FragmentBatch(
        pixel=jnp.asarray(f["pixel"], jnp.int32), depth=jnp.asarray(f["depth"]),
        attrs=jnp.zeros((len(f["depth"]), 1)), front=jnp.asarray(f["front"]),
        valid=jnp.asarray(f["valid"]))
    return [frag], [jnp.asarray(f["payload"][:, :k])]


def _assert_same(got, want):
    pay, depth, cov = (np.asarray(x) for x in want)
    g_pay, g_depth, g_cov = (x.numpy() for x in got)
    assert g_pay.shape == pay.shape and g_depth.shape == depth.shape
    np.testing.assert_array_equal(g_cov, cov)
    np.testing.assert_array_equal(g_depth, depth)
    np.testing.assert_allclose(g_pay, pay, atol=PAY_TOL, rtol=0)


@pytest.mark.parametrize("k", [4, 3])
def test_scatter_resolve_matches_jax_scatter_and_tiled(k):
    f, _ = _fragments(0)
    r, b = 16, 2
    got = traster.resolve_zbuffer(*_port(f, k), r, num_buffers=b)
    cov = got[2].numpy()
    # Image rows are flipped: GL's bottom rows come last.
    assert cov[0, r // 2:].all() and not cov[0, : r // 2].any() and cov[1, -1].all()
    assert not cov[1, :-1].any()  # empty tiles stay empty
    _assert_same(got, jraster.resolve_zbuffer_scatter(*_jax(f, k), r, num_buffers=b))
    _assert_same(got, jtiled.resolve_zbuffer_tiled(*_jax(f, k), r, interpret=True,
                                                   num_buffers=b))


def test_single_buffer_resolve_matches_jax():
    f, npix = _fragments(1, r=32, buffers=1)
    got = traster.resolve_zbuffer_scatter(*_port(f, 4), 32)
    assert got[0].shape == (32, 32, 4) and got[1].shape == (32, 32)
    _assert_same(got, jtiled.resolve_zbuffer_tiled(*_jax(f, 4), 32, interpret=True))


def _kernel_walk(starts, z, payload, k, r, buffers):
    """The per-pixel loop of ``csrc/zbuffer_resolve.cu`` in numpy."""
    npix = buffers * r * r
    out = np.zeros((npix, k), np.float32)
    depth = np.ones(npix, np.float32)
    cov = np.zeros(npix, bool)
    for p in range(npix):
        s, e = starts[p], starts[p + 1]
        zmin = np.float32(ttiled.FAR)
        for i in range(s, e):
            zmin = min(zmin, z[i])
        acc = np.zeros(4, np.float32)
        cnt = np.float32(0)
        for i in range(s, e):
            if z[i] == zmin:
                acc += payload[i]
                cnt += 1
        b, q = divmod(p, r * r)
        y, x = divmod(q, r)
        dst = b * r * r + (r - 1 - y) * r + x
        if zmin < 1.5:
            out[dst] = acc[:k] / max(cnt, 1)
            depth[dst] = zmin
            cov[dst] = True
    return (torch.from_numpy(out.reshape(buffers, r, r, k)),
            torch.from_numpy(depth.reshape(buffers, r, r)),
            torch.from_numpy(cov.reshape(buffers, r, r)))


def test_prepared_inputs_resolve_like_the_scatter():
    f, npix = _fragments(2)
    frags, pays = _port(f, 3)
    starts, z, payload, k = ttiled.prepare(frags, pays, 16, num_buffers=2)
    assert k == 3 and starts.dtype == torch.int32 and starts.shape == (npix + 1,)
    assert int(starts[-1]) == int(f["valid"].sum())  # invalid ones sort past every run
    assert torch.isfinite(payload).all()  # invalid payloads were zeroed
    got = _kernel_walk(starts.numpy(), z.numpy(), payload.numpy(), k, 16, 2)
    _assert_same(got, traster.resolve_zbuffer_scatter(frags, pays, 16, num_buffers=2))


def test_tiled_resolve_refuses_what_the_kernel_cannot_take():
    f, _ = _fragments(3)
    frags, pays = _port(f, 4)
    with pytest.raises(ValueError):
        ttiled.resolve_zbuffer_tiled(frags, pays, 16, num_buffers=2)  # a CPU tensor
    with pytest.raises(ValueError):
        ttiled.prepare(frags, [torch.zeros(len(f["depth"]), 5)], 16, num_buffers=2)
    with pytest.raises(ValueError):
        ttiled.prepare(frags, pays, 4096, num_buffers=2)  # 2^25 pixel ids


def test_generate_fragments_matches_jax():
    rng = np.random.default_rng(4)
    r, level = 24, 4
    win = np.concatenate([rng.uniform(-4, r + 4, (60, 2)), rng.uniform(-0.1, 1.1, (60, 1))],
                         -1).astype(np.float32)
    w = rng.uniform(-0.2, 2.0, 60).astype(np.float32)
    attrs = rng.uniform(-1, 1, (60, 3)).astype(np.float32)
    faces = rng.integers(0, 60, (80, 3))
    got = traster.generate_fragments(torch.from_numpy(win), torch.from_numpy(w),
                                     torch.from_numpy(attrs), torch.from_numpy(faces), r, level)
    want = jraster.generate_fragments(jnp.asarray(win), jnp.asarray(w), jnp.asarray(attrs),
                                      jnp.asarray(faces), r, level)
    assert got.pixel.shape == (80 * level * level,)
    valid = np.asarray(want.valid)
    assert 0.2 < valid.mean() < 0.9
    assert (got.valid.numpy() != valid).mean() <= 1e-3
    assert (got.pixel.numpy() != np.asarray(want.pixel)).mean() <= 1e-3
    np.testing.assert_array_equal(got.front.numpy(), np.asarray(want.front))
    np.testing.assert_allclose(got.depth.numpy(), np.asarray(want.depth), atol=1e-6, rtol=0)
    both = valid & got.valid.numpy()
    np.testing.assert_allclose(got.attrs.numpy()[both], np.asarray(want.attrs)[both],
                               atol=1e-5, rtol=1e-5)
    # Batched meshes: the same fragments per mesh.
    batched = traster.generate_fragments(
        torch.from_numpy(np.stack([win, win])), torch.from_numpy(np.stack([w, w])),
        torch.from_numpy(np.stack([attrs, attrs])), torch.from_numpy(np.stack([faces, faces])),
        r, level)
    assert torch.equal(batched.pixel[1], got.pixel) and torch.equal(batched.attrs[0], got.attrs)
