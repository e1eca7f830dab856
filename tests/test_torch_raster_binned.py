"""K2's binned raster, transcribed in plain PyTorch (CPU), against the plain
version and the JAX package.

K2 (``csrc/dense_raster.cu``) bins each triangle into the 16x16 screen tiles
whose pixel centres it may cover, then walks each tile's list: depth only,
the payload of a lone winner, the ties summed again by triangle id, and the
finish in place. ``bin_tiles_reference`` and ``raster_tiles_reference``
transcribe the two halves; ``bin_tiles`` and ``raster_tiles`` launch the
kernels and refuse CPU tensors.

- On the same plane columns the transcription equals the plain version
  (``prep_pack`` + ``raster_rows_reference``): depth, coverage and front on
  every pixel, attributes within 1e-6 (only the tie sums' order differs).
- It matches the Pallas kernel interpreted on the CPU at the plain version's
  tolerances (0.1% of pixels, attributes 1e-4).
- The bins are conservative: every (pixel, triangle) pair that the plain
  version's evaluation finds covering lies in one of that triangle's tiles,
  for grid meshes, skirt rings, triangles off-screen, huge, degenerate or
  invalid, slivers, and a seeded mix of all of them.
- The bins are deterministic, and a tie sums every winner.
- ``bench_raster``'s bound counts the covering pairs that the conservative
  bins' check counts, and its ``Other`` runs another checkout's package
  beside this one.
"""

import functools
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from ivid_tpu.ops import raster_dense as jrd
from ivid_tpu_torch import bench_raster as br
from ivid_tpu_torch import cuda_build
from ivid_tpu_torch.ops import raster_dense as trd

import test_torch_raster_dense as dense_cases
import test_torch_raster_tris as ring_cases

torch.set_num_threads(2)
ATTR_EQ = 1e-6


def _bins(cols, r):
    """The transcription of K2's bins: the columns triangle-major (geom, pay)
    and the tiles' lists (offsets, ids)."""
    geom = torch.stack(cols.geom, dim=-1)
    pay = torch.stack(cols.pay, dim=-1)
    return (geom, pay) + trd.bin_tiles_reference(geom, cols.valid, r)


def _binned(cols, r, A):
    """The transcription of K2 on plane columns, with its bins."""
    geom, pay, offsets, ids = _bins(cols, r)
    return (trd.raster_tiles_reference(geom, pay, offsets, ids, r, A),
            (geom, cols.valid, offsets, ids))


def _assert_equal_to_plain(got, want, tag):
    for field in ("depth", "covered", "front"):
        assert torch.equal(getattr(got, field), getattr(want, field)), (tag, field)
    err = (got.attrs - want.attrs).abs().max().item()
    assert err <= ATTR_EQ, (tag, err)


def _assert_bins_conservative(geom, valid, offsets, ids, r):
    """Every covering (pixel, triangle) pair of the plain evaluation lies in
    one of the triangle's tiles."""
    B, T = valid.shape
    nt = -(-r // trd.TILE)
    member = torch.zeros((B * nt * nt, T), dtype=torch.bool)
    for blk in range(B * nt * nt):
        member[blk, ids[offsets[blk]:offsets[blk + 1]].long()] = True
    pid = torch.arange(r * r)
    px, py = pid % r, pid // r
    tile = (py // trd.TILE) * nt + px // trd.TILE
    pairs = 0
    for b in range(B):
        ok, _ = trd._walk(geom[b], px.float() + 0.5, py.float() + 0.5)
        ok &= valid[b][None]
        pairs += int(ok.sum())
        assert not (ok & ~member[b * nt * nt + tile]).any(), "a covering pair outside the bins"
    return pairs


@functools.lru_cache(maxsize=None)
def _dense_case(case):
    _, t, g, r, A, _ = dense_cases._inputs(case)
    cols = trd.grid_cols(*t, g, dense_cases.CASES[case]["discard"])
    return cols, r, A


@functools.lru_cache(maxsize=None)
def _ring_case():
    samples, r = ring_cases._rings()
    stacked = [torch.stack(x) for x in zip(*[ring_cases._t(*smp) for smp in samples])]
    return trd.tri_cols(*stacked, None), r, 3


def _case(name):
    return _ring_case() if name == "skirt-rings" else _dense_case(name)


CASE_NAMES = list(dense_cases.CASES) + ["skirt-rings"]


@pytest.mark.parametrize("case", CASE_NAMES)
def test_binned_walk_equals_plain_version(case):
    cols, r, A = _case(case)
    got, bins = _binned(cols, r, A)
    want = trd.raster(cols, r, A)  # the CPU path: prep_pack + raster_rows_reference
    _assert_equal_to_plain(got, want, case)
    assert got.covered.float().mean() > 0.02
    assert _assert_bins_conservative(*bins, r) > 0


@functools.lru_cache(maxsize=None)
def _pallas(case):
    if case == "skirt-rings":
        samples, r = ring_cases._rings()
        outs = [jrd.rasterize_tris_dense(*smp, r, interpret=True) for smp in samples]
        return jrd.DenseRaster(*[np.concatenate([np.asarray(getattr(o, f)) for o in outs])
                                 for f in jrd.DenseRaster._fields])
    (win, w, attrs, pos), _, g, r, _, _ = dense_cases._inputs(case)
    return jrd.rasterize_grid_dense_batched(win, w, attrs, pos, g, r, interpret=True,
                                            discard_attr=dense_cases.CASES[case]["discard"])


@pytest.mark.parametrize("case", ["agg-24-wide", "uv-edge-nodiscard", "skirt-rings"])
def test_binned_walk_matches_pallas_interpret(case):
    cols, r, A = _case(case)
    got, _ = _binned(cols, r, A)
    compare = ring_cases._compare if case == "skirt-rings" else dense_cases._compare
    compare(got, _pallas(case), f"{case} pallas-interpret")


R_HAZ = br.R_HAZ
HAZARDS = br.HAZARDS


def test_binned_walk_on_hazards():
    cols = br.tri_set(HAZARDS, R_HAZ)
    got, bins = _binned(cols, R_HAZ, 2)
    _assert_equal_to_plain(got, trd.raster(cols, R_HAZ, 2), "hazards")
    assert _assert_bins_conservative(*bins, R_HAZ) > 0
    geom, valid, offsets, ids = bins
    assert not valid[0, -2:].any() and valid[0, :-2].all()
    # The skirt-like and the huge triangles are listed in every tile.
    tiles = offsets.numel() - 1
    listed = torch.bincount(ids.long(), minlength=len(HAZARDS))
    assert listed[7] >= tiles - 1 and (listed[8:10] == tiles).all()
    assert listed[6] == 0  # off-screen: in no tile


def _at(ras, x, y, r=R_HAZ):
    i = y * r + x
    return ras.attrs[i, 0].item(), ras.depth[i].item(), bool(ras.front[i]), bool(ras.covered[i])


def test_ties_on_shared_edges_and_stacks():
    """The tie path sums every winner: on the shared diagonal of the two
    halves (count 2) the attribute is the mean of 1 and 3 and front is 1 of 2
    (False); on the stack of three (count 3) the mean of 4, 6 and 8; on the
    stack of six (more winners than the kernel keeps) the mean of 1 to 6."""
    cols = br.tri_set(HAZARDS, R_HAZ)
    got, _ = _binned(cols, R_HAZ, 2)
    want = trd.raster(cols, R_HAZ, 2)
    for ras in (got, want):
        for k in (5, 12, 20, 33):
            assert _at(ras, k, k) == (2.0, 0.5, False, True)
        assert _at(ras, 20, 10) == (1.0, 0.5, True, True)  # the front half alone
        assert _at(ras, 10, 20) == (3.0, 0.5, False, True)  # the back half alone
        assert _at(ras, 34, 8) == (6.0, pytest.approx(0.4), True, True)
        assert _at(ras, 8, 28) == (3.5, pytest.approx(0.45), True, True)


@pytest.mark.parametrize("seed", [0, 1])
def test_bins_conservative_on_random_triangles(seed):
    tris, r = br.random_tris(seed)
    cols = br.tri_set(tris, r)
    got, bins = _binned(cols, r, 2)
    pairs = _assert_bins_conservative(*bins, r)
    assert pairs > 1000
    _assert_equal_to_plain(got, trd.raster(cols, r, 2), f"random-{seed}")


def test_bins_deterministic_and_sorted():
    cols, r, _ = _case("agg-24-wide")
    a = _bins(cols, r)
    b = _bins(cols, r)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    offsets, ids = a[2:]
    nt = -(-r // trd.TILE)
    assert r % trd.TILE and offsets.numel() == 2 * nt * nt + 1  # ragged tiles
    assert offsets.dtype == ids.dtype == torch.int32 and int(offsets[-1]) == ids.numel()
    for blk in range(offsets.numel() - 1):
        lst = ids[offsets[blk]:offsets[blk + 1]]
        assert (lst[1:] > lst[:-1]).all()
    # A long list: the frustum skirt's triangles reach across many tiles.
    assert (offsets[1:] - offsets[:-1]).max() > 100


def test_cpu_wrappers_launch_nothing():
    """On CPU tensors the public raster takes the plain version and counts no
    launch; the kernels' own wrappers refuse them."""
    cols, r, A = _case("uv-edge-nodiscard")
    before = cuda_build.launches.copy(), trd.sync_s
    trd.raster(cols, r, A)
    assert (cuda_build.launches, trd.sync_s) == before
    with pytest.raises(ValueError, match="CUDA tensors only"):
        trd.bin_tiles(cols, r)
    geom, pay, offsets, ids = _bins(cols, r)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        trd.raster_tiles(geom, pay, offsets, ids, r, A)


def test_bound_counts_covered_pairs():
    """The bound counts the plain version's covering (pixel, triangle) pairs,
    6 planes of 4 operations each, and the bytes of the valid triangles'
    columns and of the DenseRaster."""
    cols = br.tri_set(HAZARDS, R_HAZ)
    _, bins = _binned(cols, R_HAZ, 2)
    pairs = _assert_bins_conservative(*bins, R_HAZ)
    ms, by, work = br.bound_ms(cols, R_HAZ, 2)
    nv = len(HAZARDS) - 2
    assert work == {"bytes": nv * (18 + 10) * 4 + R_HAZ * R_HAZ * 14, "operations": 24 * pairs,
                    "covered_pairs": pairs, "valid_triangles": nv}
    assert by == "bytes" and ms == pytest.approx(work["bytes"] / br.PEAK_BYTES * 1e3)


REPO = Path(__file__).resolve().parents[1]


def test_other_checkout_runs_beside_this_one():
    """``bench_raster.Other`` imports a second copy of the package (here this
    checkout's own) whose modules stand in ``sys.modules`` only inside
    ``with``; its public raster call gives this one's result."""
    before = {k: v for k, v in sys.modules.items() if k.startswith("ivid_tpu_torch")}
    other = br.Other(REPO)
    assert {k: v for k, v in sys.modules.items() if k.startswith("ivid_tpu_torch")} == before
    assert other.rd is not trd and other.rd.__file__ == trd.__file__
    case = dense_cases._inputs("uv-edge-nodiscard")
    _, t, g, r, _, _ = case
    with other:
        assert sys.modules["ivid_tpu_torch.ops.raster_dense"] is other.rd
        got = other.rd.rasterize_grid_dense_batched(*t, g, r)
    assert sys.modules["ivid_tpu_torch.ops.raster_dense"] is trd
    want = trd.rasterize_grid_dense_batched(*t, g, r)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_capacity_check_raises_when_bins_were_cut_short():
    """K2's bins given a capacity one below their true total drop the last
    id, and the caller's check of the returned offsets raises instead of
    letting it pass (``bench_raster.measure`` checks after its timing); at
    the true total or above, the lists are whole and the check passes."""
    cols = br.tri_set(HAZARDS, R_HAZ)
    geom = torch.stack(cols.geom, dim=-1)
    offsets, ids = trd.bin_tiles_reference(geom, cols.valid, R_HAZ)
    listed = int(offsets[-1])
    assert listed == ids.numel() > 0
    for capacity in (listed, listed + 7):
        got_offsets, got_ids = trd.bin_tiles_reference(geom, cols.valid, R_HAZ, capacity)
        assert torch.equal(got_offsets, offsets) and torch.equal(got_ids, ids)
        trd.check_capacity(got_offsets, capacity)
    got_offsets, got_ids = trd.bin_tiles_reference(geom, cols.valid, R_HAZ, listed - 1)
    assert got_ids.numel() == listed - 1 and int(got_offsets[-1]) == listed
    with pytest.raises(RuntimeError, match="1 were dropped"):
        trd.check_capacity(got_offsets, listed - 1)
