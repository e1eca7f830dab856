"""The resolve prototypes K5 and K6 (``ivid_tpu_torch/ops/resolve_variants.py``)
vs the JAX repository (CPU).

The two Pallas kernels are closures inside the bench scripts
(``bench_micro.py:main``, ``bench_resolve.py:proto``) and cannot be imported,
so this file copies their bodies (``_dense_kernel``, ``_proto_kernel``) and
runs them with ``pl.pallas_call(..., interpret=True)``. Row 7's launch takes
``pl.ANY`` for the script's deprecated ``pltpu.ANY``, the out index map
``(tile, 0, 0)`` (the script's map at ``bench_resolve.py:194-195`` receives
``(tile, chunk, bounds_ref)`` and so picks the chunk's block), and a chunk
grid deep enough for every tile (the script caps it at 24 chunks).

Tolerances: the depth minimum and the winner count are exact; the payload
sums may differ by 1e-5 (f32 sums in another order; depths rounded to 1/64
make many ties).
"""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ivid_tpu.ops import raster as jraster
from ivid_tpu_torch import bench_micro, bench_resolve, cuda_build
from ivid_tpu_torch.ops import resolve_variants as rv

torch.set_num_threads(2)
SUM_TOL = 1e-5
P = 1024
CH = 512


def _dense_kernel(f_per_t):
    """``bench_micro.py:131-158``, with ``F_PER_T`` as a parameter."""
    F_PER_T = f_per_t

    def dense_kernel(lp_ref, z_ref, pay_ref, out_ref):
        iota = jax.lax.broadcasted_iota(jnp.int32, (1, 1024), 1)
        CH = 512
        nch = F_PER_T // CH

        def body(i, zbuf):
            lp = lp_ref[0, pl.ds(i * CH, CH), :]
            z = z_ref[0, pl.ds(i * CH, CH), :]
            m = lp == iota
            zm = jnp.where(m, z, 9.0)
            return jnp.minimum(zbuf, jnp.min(zm, axis=0, keepdims=True))

        zbuf = jax.lax.fori_loop(0, nch, body, jnp.full((1, 1024), 9.0))

        def body2(i, acc):
            lp = lp_ref[0, pl.ds(i * CH, CH), :]
            z = z_ref[0, pl.ds(i * CH, CH), :]
            pay = pay_ref[0, pl.ds(i * CH, CH), :]
            m = lp == iota
            win = (m & (z <= zbuf)).astype(jnp.float32)
            contrib = jnp.concatenate(
                [jnp.sum(win * pay[:, c:c + 1], axis=0, keepdims=True)
                 for c in range(4)], 0)
            return acc + contrib

        acc = jax.lax.fori_loop(0, nch, body2, jnp.zeros((4, 1024)))
        out_ref[0, 0:1, :] = zbuf
        out_ref[0, 1:5, :] = acc

    return dense_kernel


def _row6_pallas(lp, z, pay):
    """The launch of ``bench_micro.py:160-170`` in interpret mode on
    [T, F, 1] / [T, F, 1] / [T, F, 4] inputs."""
    t, f = lp.shape[:2]
    call = pl.pallas_call(
        _dense_kernel(f),
        grid=(t,),
        in_specs=[pl.BlockSpec((1, f, 1), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, f, 1), lambda i: (i, 0, 0)),
                  pl.BlockSpec((1, f, 4), lambda i: (i, 0, 0))],
        out_specs=pl.BlockSpec((1, 5, 1024), lambda i: (i, 0, 0)),
        out_shape=jax.ShapeDtypeStruct((t, 5, 1024), jnp.float32),
        interpret=True,
    )
    return np.asarray(call(jnp.asarray(lp), jnp.asarray(z), jnp.asarray(pay)))


def _proto_kernel(bounds_ref, lp_ref, z_ref, pay_ref, out_ref, zbuf, acc):
    """``bench_resolve.py:136-184``."""
    t = pl.program_id(0)
    c = pl.program_id(1)
    start = bounds_ref[t]
    end = bounds_ref[t + 1]

    @pl.when(c == 0)
    def _():
        zbuf[:] = jnp.full_like(zbuf, 9.0)
        acc[:] = jnp.zeros_like(acc)

    off = start + c * CH
    iota = jax.lax.broadcasted_iota(jnp.int32, (1, P), 1)

    @pl.when(off < end)
    def _():
        nvalid = end - off
        lpc = lp_ref[pl.ds(off, CH), :]
        zc = z_ref[pl.ds(off, CH), :]
        pc = pay_ref[pl.ds(off, CH), :]  # noqa: F841 (loaded, unused, as in the script)
        ridx = jax.lax.broadcasted_iota(jnp.int32, (CH, 1), 0)
        ok = ridx < nvalid
        m = (lpc == iota) & ok
        zm = jnp.where(m, zc, 9.0)
        zbuf[:] = jnp.minimum(zbuf[:], jnp.min(zm, axis=0, keepdims=True))

    @pl.when(c == pl.num_programs(1) - 1)
    def _():
        # second pass: winners accumulate
        def body(j, carry):
            off2 = start + j * CH
            lpc = lp_ref[pl.ds(off2, CH), :]
            zc = z_ref[pl.ds(off2, CH), :]
            pc = pay_ref[pl.ds(off2, CH), :]
            ridx = jax.lax.broadcasted_iota(jnp.int32, (CH, 1), 0)
            ok = ridx < (end - off2)
            m = (lpc == iota) & ok
            win = (m & (zc <= zbuf[:])).astype(jnp.float32)
            a = carry
            for ch in range(3):
                a = a.at[ch:ch + 1, :].add(
                    jnp.sum(win * pc[:, ch:ch + 1], axis=0, keepdims=True))
            a = a.at[3:4, :].add(jnp.sum(win, axis=0, keepdims=True))
            return a

        nch = (end - start + CH - 1) // CH
        res = jax.lax.fori_loop(0, nch, body, jnp.zeros((4, P)))
        out_ref[0, 0:1, :] = zbuf[:]
        out_ref[0, 1:5, :] = res


def _proto_prep(pixel, depth, pay, valid, npix):
    """``bench_resolve.py:116-130``: key, depth 9.0 where invalid, the sort,
    tile ids with the last-tile clamp, tile bounds, and the tail pad."""
    T = npix // P
    key = jnp.where(valid, pixel, npix).astype(jnp.int32)
    z = jnp.where(valid, depth, 9.0).astype(jnp.float32)
    ks, z_s, p0, p1, p2 = jax.lax.sort((key, z, pay[:, 0], pay[:, 1], pay[:, 2]), num_keys=1)
    tid = jnp.minimum(ks // P, T - 1)
    bounds = jnp.searchsorted(tid, jnp.arange(T + 1, dtype=jnp.int32))
    lp = jnp.pad((ks - tid * P).astype(jnp.int32), (0, CH), constant_values=P)
    zp = jnp.pad(z_s, (0, CH), constant_values=9.0)
    pp = jnp.pad(jnp.stack([p0, p1, p2], -1), ((0, CH), (0, 0)))
    return bounds.astype(jnp.int32), lp, zp, pp


def _row7_pallas(bounds, lp, zp, pp):
    """The launch of ``bench_resolve.py:186-205`` in interpret mode, out map
    ``(tile, 0, 0)``, with as many chunk steps as the longest tile needs."""
    T = bounds.shape[0] - 1
    maxch = max(1, int(np.max(-(-np.diff(np.asarray(bounds)) // CH))))
    grid_spec = pltpu.PrefetchScalarGridSpec(
        num_scalar_prefetch=1,
        grid=(T, maxch),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)] * 3,
        out_specs=pl.BlockSpec((1, 5, P), lambda t, c, bounds_ref: (t, 0, 0)),
        scratch_shapes=[pltpu.VMEM((1, P), jnp.float32), pltpu.VMEM((4, P), jnp.float32)],
    )
    out = pl.pallas_call(
        _proto_kernel, grid_spec=grid_spec,
        out_shape=jax.ShapeDtypeStruct((T, 5, P), jnp.float32), interpret=True,
    )(bounds, lp[:, None], zp[:, None], pp)
    return np.asarray(out)


def _fragments(seed, r=64, buffers=1, n=6000, nan_invalid=True):
    """Flat fragments over ``buffers`` r² framebuffers: uniform pixels over
    each buffer's lower half, 600 on one pixel over three depth levels
    (ties), depths rounded to 1/64 (more ties), ~10% invalid ones (NaN
    payloads with ``nan_invalid``) with the sentinel pixel id."""
    rng = np.random.default_rng(seed)
    npix = buffers * r * r
    b = rng.integers(0, buffers, n)
    pix = b * r * r + rng.integers(0, r * r // 2, n)
    pix[:600] = 37
    depth = np.round(rng.uniform(0, 1, n) * 64) / 64
    depth[:600] = rng.choice([0.25, 0.5, 0.75], 600)
    valid = rng.uniform(size=n) > 0.1
    payload = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    if nan_invalid:
        payload[~valid] = np.nan
    pix = np.where(valid, pix, npix)
    return dict(pixel=pix, depth=depth.astype(np.float32), valid=valid, payload=payload), npix


def _port_prep(f, npix):
    return rv.prepare_tiles(torch.from_numpy(f["pixel"]), torch.from_numpy(f["depth"]),
                            torch.from_numpy(f["payload"]), torch.from_numpy(f["valid"]), npix)


def _assert_tiles_equal(got, want, sums):
    """Depth (row 0) exact; rows ``sums`` within SUM_TOL; the rest exact."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    exact = [i for i in range(5) if i not in sums]
    np.testing.assert_array_equal(got[:, exact], want[:, exact])
    np.testing.assert_allclose(got[:, sums], want[:, sums], atol=SUM_TOL, rtol=0)


def _binned(seed, t=4, f=1024, negative=False):
    """Row-6 inputs: local pixels in [-8, 1032) (some outside the tile),
    depths rounded to 1/64 (ties; below zero too with ``negative``)."""
    rng = np.random.default_rng(seed)
    lp = rng.integers(-8, P + 8, (t, f)).astype(np.int32)
    lp[:, :300] = rng.integers(0, 4, (t, 300))  # many fragments on a few pixels
    lo = -1.0 if negative else 0.0
    z = (np.round(rng.uniform(lo, 1, (t, f)) * 64) / 64).astype(np.float32)
    pay = rng.uniform(-1, 1, (t, f, 4)).astype(np.float32)
    return lp, z, pay


def test_binned_reference_matches_the_pallas_kernel():
    lp, z, pay = _binned(0)
    want = _row6_pallas(lp[..., None], z[..., None], pay)
    got = rv.binned_resolve_reference(torch.from_numpy(lp), torch.from_numpy(z),
                                      torch.from_numpy(pay))
    assert (want[:, 0] < 9.0).mean() > 0.3 and (want[:, 0] == 9.0).any()
    _assert_tiles_equal(got.numpy(), want, sums=[1, 2, 3, 4])


@pytest.mark.parametrize("negative", [False, True])
def test_binned_kernel_walk_matches_the_reference(negative):
    """K5's two passes in numpy: atomicMin on the depth's bits mapped to
    ordered unsigned keys (negative depths too), then the winners' sums."""
    lp, z, pay = _binned(1, negative=negative)
    bits = z.view(np.uint32)
    keys = np.where(bits & 0x80000000, ~bits, bits | 0x80000000).astype(np.uint32)
    far = np.float32(rv.FAR).view(np.uint32) | np.uint32(0x80000000)
    out = np.zeros((lp.shape[0], 5, P), np.float32)
    for t in range(lp.shape[0]):
        inside = (lp[t] >= 0) & (lp[t] < P)
        zkey = np.full(P, far, np.uint32)
        np.minimum.at(zkey, lp[t][inside], keys[t][inside])
        zbits = np.where(zkey & 0x80000000, zkey & 0x7FFFFFFF, ~zkey).astype(np.uint32)
        zbuf = zbits.view(np.float32)
        win = inside & (z[t] <= zbuf[np.clip(lp[t], 0, P - 1)])
        out[t, 0] = zbuf
        for c in range(4):
            np.add.at(out[t, 1 + c], lp[t][win], pay[t][win, c])
    want = rv.binned_resolve_reference(torch.from_numpy(lp), torch.from_numpy(z),
                                       torch.from_numpy(pay))
    assert (want[:, 0] < 0).any() == negative
    _assert_tiles_equal(out, want.numpy(), sums=[1, 2, 3, 4])


def test_tile_reference_matches_the_pallas_kernel():
    f, npix = _fragments(2, buffers=2, nan_invalid=False)
    jin = _proto_prep(jnp.asarray(f["pixel"], jnp.int32), jnp.asarray(f["depth"]),
                      jnp.asarray(f["payload"]), jnp.asarray(f["valid"]), npix)
    want = _row7_pallas(*jin)
    bounds, lp, z, pay = _port_prep(f, npix)
    n = len(f["depth"])
    # The same tiles and sorted keys as the prototype's preparation.
    np.testing.assert_array_equal(bounds.numpy(), np.asarray(jin[0]))
    np.testing.assert_array_equal(lp.numpy(), np.asarray(jin[1])[:n])
    got = rv.tile_resolve_reference(bounds, lp, z, pay)
    assert got.shape == (npix // P, 5, P) and (want[:, 4] > 1).any()
    _assert_tiles_equal(got.numpy(), want, sums=[1, 2, 3])


def _kernel_constants():
    """K6's ``constexpr int`` constants, read from its source."""
    src = (Path(rv.__file__).resolve().parents[1] / "csrc" / "tile_resolve.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def _combine(a, b):
    """K6's operator on [..., 5] f32 (depth, 3 sums, count), ``a`` then
    ``b``: the smaller depth, and the sums of the sides tied at it."""
    m = np.fmin(a[..., 0], b[..., 0])
    ta = (a[..., 0] == m)[..., None]
    tb = (b[..., 0] == m)[..., None]
    rest = np.where(ta, a[..., 1:], np.float32(0)) + np.where(tb, b[..., 1:], np.float32(0))
    return np.concatenate([m[..., None], rest], -1).astype(np.float32)


def _search_end(lp, s, e):
    """Warp 0's search for the first lp >= 1024 in [s, e): 32 probes a
    round, then one probe per lane. Returns (index, rounds)."""
    lo, hi, rounds = s, e - 1, 0
    while hi - lo > 31:
        probe = lo + (hi - lo) * np.arange(1, 33) // 33
        ge = lp[probe] >= P
        first = int(np.argmax(ge)) if ge.any() else 32
        if first == 32:
            lo = int(probe[31]) + 1
        else:
            hi = int(probe[first])
            if first:
                lo = int(probe[first - 1]) + 1
        rounds += 1
    i = lo + np.arange(32)
    ge = (i <= hi) & (lp[np.minimum(i, hi)] >= P)
    return lo + int(np.argmax(ge)), rounds + 1


def _tile_kernel_walk(bounds, lp, z, pay):
    """K6 in numpy, in its order of work: per tile, the search where the range
    ends in fragments on no pixel; the range from a 4-aligned start through
    chunks of ``kChunk`` staged fragments, ``kItems`` per thread. Runs of
    equal lp are segments; a pixel's result is stored once, from the total
    of its segment. Per chunk each thread reduces its fragments in order and
    stores the segments that start and end among them; a segment that comes
    in from earlier threads takes its carry from an inclusive scan of the
    threads' totals over the 32 lanes (shifts of 1, 2, 4, 8, 16), the warps
    before in warp order and, past them, the segment left open at the
    previous chunk's end, and is stored by the thread where it ends. Returns
    the output and counts of what the walk met."""
    c = _kernel_constants()
    items, lanes, threads = c["kItems"], 32, c["kThreads"]
    chunk, warps = threads * items, threads // 32
    tiles = len(bounds) - 1
    out = np.zeros((tiles, 5, P), np.float32)
    seen = dict(carried=0, ended_at_chunk_end=0, open_at_range_end=0, spans_warps=0,
                search_rounds=0, longest=0)
    ident = np.array([np.inf, 0, 0, 0, 0], np.float32)

    def store(res, p, a, where):
        p, a = np.atleast_1d(p)[where], np.atleast_2d(a)[where]
        ok = (p >= 0) & (p < P) & (a[:, 0] <= rv.FAR)
        assert len(np.unique(p[ok])) == ok.sum() and not written[p[ok]].any()  # once a pixel
        written[p[ok]] = True
        res[p[ok]] = a[ok]

    def from_before(w, open_a):
        pre = ident
        for u in range(w - 1, -1, -1):
            pre = _combine(inc[u, -1], pre)
            if f[u, -1]:
                return pre
        return _combine(open_a, pre)

    for t in range(tiles):
        s, e = int(bounds[t]), int(bounds[t + 1])
        end = e
        if e > s and lp[e - 1] >= P:
            end, rounds = _search_end(lp, s, e)
            seen["search_rounds"] = max(seen["search_rounds"], rounds)
        seen["longest"] = max(seen["longest"], end - s)
        res = np.zeros((P, 5), np.float32)
        res[:, 0] = rv.FAR
        written = np.zeros(P, bool)
        base = s & ~3
        nchunks = -(-(end - base) // chunk) if end > s else 0
        open_key, open_a = -1, ident
        for j in range(nchunks):
            g = base + j * chunk + np.arange(chunk)
            inside = (g >= s) & (g < end)
            gi = np.clip(g, 0, len(lp) - 1)
            key = np.where(inside, lp[gi], -1)
            val = np.zeros((chunk, 5), np.float32)
            val[:, 0], val[:, 1:4], val[:, 4] = z[gi], pay[gi], 1
            val[~inside] = ident
            head = key != np.concatenate([[open_key], key[:-1]])
            tail = key != np.concatenate([key[1:], key[-1:]])  # the last stays open
            if head[0]:
                store(res, open_key, open_a, np.array([True]))
                seen["ended_at_chunk_end"] += int(0 <= open_key < P)
            key_t, val_t = key.reshape(threads, items), val.reshape(threads, items, 5)
            head_t, tail_t = head.reshape(threads, items), tail.reshape(threads, items)
            # Each thread in order: the lead (before its first head), the run
            # since its last head, and the segments that end after a head.
            run = np.broadcast_to(ident, (threads, 5)).copy()
            lead = run.copy()
            has_head = np.zeros(threads, bool)
            for k in range(items):
                h = head_t[:, k]
                lead = np.where((h & ~has_head)[:, None], run, lead)
                run = np.where(h[:, None], val_t[:, k], _combine(run, val_t[:, k]))
                has_head |= h
                store(res, key_t[:, k], run, tail_t[:, k] & has_head)
            lead = np.where(has_head[:, None], lead, run)
            # Inclusive segmented scan of the threads' totals over each warp.
            f = has_head.reshape(warps, lanes)
            inc = run.reshape(warps, lanes, 5)
            for d in (1, 2, 4, 8, 16):
                o = np.concatenate([np.broadcast_to(ident, (warps, d, 5)), inc[:, :-d]], 1)
                of = np.concatenate([np.zeros((warps, d), bool), f[:, :-d]], 1)
                inc = np.where(f[..., None], inc, _combine(o, inc))
                f = f | of
            carry = np.concatenate([np.broadcast_to(ident, (warps, 1, 5)), inc[:, :-1]], 1)
            cf = np.concatenate([np.zeros((warps, 1), bool), f[:, :-1]], 1)
            for w in range(warps):
                carry[w] = np.where(cf[w, :, None], carry[w], _combine(from_before(w, open_a),
                                                                      carry[w]))
            ends_here = ~head_t[:, 0] & (has_head | tail_t[:, -1])
            store(res, key_t[:, 0], _combine(carry.reshape(threads, 5), lead), ends_here)
            last = inc[-1, -1] if f[-1, -1] else _combine(from_before(warps - 1, open_a),
                                                          inc[-1, -1])
            open_key, open_a = key[-1], last
            seen["spans_warps"] += int(np.sum(~head[::lanes * items] & inside[::lanes * items]))
            if inside[-1] and j + 1 < nchunks and key[-1] == lp[g[-1] + 1]:
                seen["carried"] += 1
        if nchunks:
            store(res, open_key, open_a, np.array([True]))
            seen["open_at_range_end"] += int(0 <= open_key < P)
        out[t] = res.T
    return out, seen


def _stacked(seed, runs, tile_fill=(0, 0)):
    """``_fragments(seed, buffers=2)`` plus, for each ``(pixel, n)`` of
    ``runs``, ``n`` fragments on that pixel at 8 depth levels (exact ties),
    and ``tile_fill = (tile, n)``: n more spread over the lower half of that
    tile."""
    f, npix = _fragments(seed, buffers=2)
    rng = np.random.default_rng(seed + 100)
    tile, n_fill = tile_fill
    pix = np.concatenate([np.full(n, p) for p, n in runs]
                         + [tile * P + rng.integers(0, P // 2, n_fill)])
    m, n_runs = len(pix), sum(n for _, n in runs)
    depth = np.concatenate([rng.choice(np.linspace(0.1, 0.8, 8), n_runs),
                            np.round(rng.uniform(0, 1, n_fill) * 64) / 64]).astype(np.float32)
    return dict(pixel=np.concatenate([f["pixel"], pix]), depth=np.concatenate([f["depth"], depth]),
                valid=np.concatenate([f["valid"], np.ones(m, bool)]),
                payload=np.concatenate([f["payload"],
                                        rng.uniform(-1, 1, (m, 3)).astype(np.float32)])), npix


def _walk_case(name):
    if name == "clustered":
        return _fragments(3, buffers=2)
    if name == "stacked pixel":  # one pixel's run longer than a chunk
        return _stacked(3, [(5 * P + 77, rv.TILE_CHUNK + 500)])
    if name == "range over the staging budget":
        return _stacked(3, [(2 * P + 5, 400)], tile_fill=(2, rv.TILE_STAGING))
    # Pixel 3's run ends exactly at the end of tile 0's first chunk, and tile
    # 2's range (one pixel) at the end of its only chunk.
    f, _ = _fragments(3, buffers=2)
    n1 = rv.TILE_CHUNK - int(np.sum(f["valid"] & (f["pixel"] <= 3)))
    s2 = int(np.sum(f["valid"] & (f["pixel"] < 2 * P))) + n1
    return _stacked(3, [(3, n1), (2 * P + 10, rv.TILE_CHUNK - s2 % 4)])


@pytest.mark.parametrize("case", ["clustered", "stacked pixel", "range over the staging budget",
                                  "segment ending at a chunk's end"])
def test_tile_kernel_walk_matches_the_reference(case):
    f, npix = _walk_case(case)
    bounds, lp, z, pay = _port_prep(f, npix)
    assert int(bounds[-1]) == len(f["depth"]) and int(lp[-1]) == P  # invalid ones last, lp P
    assert torch.isfinite(pay).all()
    got, seen = _tile_kernel_walk(bounds.numpy(), lp.numpy(), z.numpy(), pay.numpy())
    want = rv.tile_resolve_reference(bounds, lp, z, pay).numpy()
    assert seen["search_rounds"] >= 2 and seen["spans_warps"] >= 1  # the last tile's search
    if case in ("stacked pixel", "range over the staging budget"):
        assert seen["carried"] >= 1 and (want[:, 4] > 1).any()  # ties carried across chunks
    if case == "range over the staging budget":
        assert seen["longest"] > rv.TILE_STAGING
    if case == "segment ending at a chunk's end":
        assert seen["ended_at_chunk_end"] >= 1 and seen["open_at_range_end"] >= 1
    _assert_tiles_equal(got, want, sums=[1, 2, 3])


def test_tile_kernel_constants_match_the_source():
    c = _kernel_constants()
    assert c["kThreads"] * c["kItems"] == rv.TILE_CHUNK and c["kStages"] == rv.TILE_STAGES
    assert c["kP"] == P and c["kItems"] % 4 == 0  # lp read as int4


@pytest.mark.parametrize("buffers", [1, 3])
def test_tile_chain_matches_jax_scatter_resolve(buffers):
    f, npix = _fragments(4, buffers=buffers)
    r = 64
    got = rv.tile_finish(rv.tile_resolve(*_port_prep(f, npix)), r, buffers)
    frag = jraster.FragmentBatch(
        pixel=jnp.asarray(f["pixel"], jnp.int32), depth=jnp.asarray(f["depth"]),
        attrs=jnp.zeros((len(f["depth"]), 1)), front=jnp.asarray(f["valid"]),
        valid=jnp.asarray(f["valid"]))
    want = jraster.resolve_zbuffer_scatter([frag], [jnp.asarray(f["payload"])], r,
                                           num_buffers=buffers)
    pay, depth, cov = (np.asarray(x) for x in want)
    assert got[0].shape == pay.shape and got[1].shape == depth.shape
    assert 0.2 < cov.mean() < 0.5
    np.testing.assert_array_equal(got[2].numpy(), cov)
    np.testing.assert_array_equal(got[1].numpy(), depth)
    np.testing.assert_allclose(got[0].numpy(), pay, atol=SUM_TOL, rtol=0)


def test_wrappers_take_the_plain_version_on_the_cpu():
    lp, z, pay = (torch.from_numpy(x) for x in _binned(5))
    f, npix = _fragments(5)
    prepared = _port_prep(f, npix)
    before = cuda_build.launches.copy()
    assert torch.equal(rv.binned_resolve(lp, z, pay), rv.binned_resolve_reference(lp, z, pay))
    assert torch.equal(rv.tile_resolve(*prepared), rv.tile_resolve_reference(*prepared))
    assert cuda_build.launches == before
    meta = [x.to("meta") for x in (lp, z, pay)]
    with pytest.raises(ValueError):
        rv.binned_resolve(*meta)
    with pytest.raises(ValueError):
        rv.tile_resolve(*(x.to("meta") for x in prepared))


def test_prepare_and_finish_refuse_what_the_tiles_cannot_take():
    f, _ = _fragments(6, r=48)
    args = [torch.from_numpy(f[k]) for k in ("pixel", "depth", "payload", "valid")]
    with pytest.raises(ValueError):
        rv.prepare_tiles(*args, 48 * 48)  # 2,304 pixels: not whole 1024-pixel tiles
    with pytest.raises(ValueError):
        rv.prepare_tiles(args[0], args[1], torch.zeros(len(f["depth"]), 4), args[3], 4096)
    with pytest.raises(ValueError):
        rv.tile_finish(torch.zeros(4, 5, P), 64, num_buffers=2)


@pytest.mark.parametrize("stack", [False, True])
def test_bench_resolve_runs_on_the_cpu(capsys, stack):
    argv = ["--device", "cpu", "--n", "6144", "--r", "64", "--buffers", "2"]
    if stack:  # 8 tiles: 8 stacked pixels, each beside this checkout's K6 as the other
        argv += ["--stack", "--other", str(Path(__file__).resolve().parents[1])]
    res = bench_resolve.main(argv)
    names = [row["name"] for row in res["rows"]]
    assert "prototype kernel K6" in names and "resolve_zbuffer_scatter" in names
    assert all("cpu_ms" in row and "ms" not in row for row in res["rows"])
    assert res["max_payload_err"]["prototype"] <= SUM_TOL
    k6 = res["k6"]
    assert k6["bit_equal"] and k6["max_sum_err"] <= SUM_TOL and "ms" not in k6
    assert k6["max_sum_rel"] <= k6["max_sum_err"] and k6["plain_self_diff"] == 0.0
    if stack:
        assert k6["fragments"] == 6144 + 8 * bench_resolve.STACK_PER_PIXEL
        assert k6["longest_tile"] > max(bench_resolve.STACK_PER_PIXEL, rv.TILE_STAGING)
        assert set(k6["cpu_ms"]) == {"this", "other"}
        assert k6["vs_other"] == {"depth_count_differ": 0, "max_sum_diff": 0.0, "max_sum_rel": 0.0}
    assert "prototype kernel K6" in capsys.readouterr().out


def test_stacked_fragments_stack_ties_on_one_pixel_per_tile():
    gen = torch.Generator().manual_seed(0)
    fb, pay = bench_resolve.make_stacked(gen, 1000, 64, buffers=2, pixels=5, per_pixel=300)
    extra = fb.pixel[1000:]
    assert fb.pixel.shape == (2500,) and pay.shape == (2500, 3) and bool(fb.valid.all())
    assert len(torch.unique(extra)) == 5 and len(torch.unique(extra // P)) == 5
    assert len(torch.unique(fb.depth[1000:])) <= bench_resolve.STACK_LEVELS
    bounds, lp, z, p = rv.prepare_tiles(fb.pixel, fb.depth, pay, fb.valid, 2 * 64 * 64)
    assert bench_resolve.tile_bytes(bounds, lp) == 9 * 4 + 2500 * 20 + 8 * 5 * P * 4


def test_bench_micro_runs_on_the_cpu():
    res = bench_micro.main(["--device", "cpu", "--n", "8192", "--r", "64"])
    names = [row["name"] for row in res["rows"]]
    assert "K5 binned resolve" in names and len(names) == 12
    assert res["k5_max_sum_err"] == 0.0
    with pytest.raises(SystemExit):
        bench_micro.main(["--device", "cpu", "--n", "1000", "--r", "64"])


def test_bench_rank_by_matmul_counts_earlier_fragments_of_each_tile():
    tid = torch.from_numpy(np.random.default_rng(7).integers(0, 5, 4096))
    rank = bench_micro.rank_by_matmul(tid, 5).reshape(-1)
    want = [int((tid[:i] == tid[i]).sum()) for i in range(len(tid))]
    assert rank.tolist() == want
