"""Check and time K2, the dense raster, on the card, optionally beside another
version of it:

    python -m ivid_tpu_torch.bench_raster [--other DIR]

Inputs, made on the card from seeds: the aggregation's view slots
(:func:`live_slots`: 128² seeded RGBD maps lifted to frustum-skirt meshes,
seen from an orbit view at r = 384) at 4 slots and at 26 (the last view of a
``3x9`` scene), and the skirt rings of a training step's first warp render
(:func:`warp_render_inputs`: 8 SyntheticRGBDWarp items of the cond config,
r = 384) at B = 8 and B = 1.

For each, :func:`check` holds K2 to its plain version (depth, coverage and
front equal on every pixel, attributes within ``ATTR_MAX``, two launches
bit-equal) and :func:`measure` times it: the columns (``grid_cols`` or
``tri_cols``), the bins, the raster, the kernels with the glue between them,
the public call (``rasterize_grid_dense_batched`` or
``rasterize_tris_dense_batched``, columns included), the host's wait for the
bins' length, and the plain version. :func:`aggregation_view` times a
26-slot aggregation view.

With ``--other DIR``, the root of another checkout (e.g. an earlier commit
unpacked with ``git archive``), that checkout's package is imported beside
this one (:class:`Other`), and its public calls run on the same inputs, in
turns with this version's (other, this, this, other): the raster calls and
the aggregation view, whatever kernel each version has behind them.

Device times are ``ivid_tpu_torch.timing``'s; one JSON line per input, then
the card's name and power limit as nvidia-smi reads them.
"""

from __future__ import annotations

import argparse
import importlib
import json
import re
import sys
import warnings
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from ivid_tpu_torch import cuda_build, timing
from ivid_tpu_torch.host_noise import HostNoise
from ivid_tpu_torch.ops import raster_dense as rd

COND_CFG = Path(__file__).resolve().parents[1] / "configs" / "rgbd_singlecategory_adm_128_small_cond.json"
# The card's published peaks (NVIDIA H100 SXM data sheet) for the bound: the
# memory rate, and the f32 rate outside the tensor cores, 67 TFLOP/s with an
# FMA counted as two operations. K2 rounds each product and each sum on its
# own (no FMA), so its operations issue at half that rate.
PEAK_BYTES = 3.35e12
PEAK_F32_UNFUSED = 67e12 / 2
# K2 against its plain version: the same planes with the same f32 roundings,
# so the same winners; the tie sums may add in another order.
ATTR_MAX = 1e-3


class Input(NamedTuple):
    """One raster input: ``cols()`` makes this version's plane columns,
    ``call(module)`` runs a ``raster_dense`` module's public call on the
    inputs the columns come from."""

    name: str
    cols: Callable
    call: Callable
    r: int
    A: int


def live_slots(dev, n=4, s=128, seed=0):
    """n seeded s² depth maps lifted to frustum-skirt meshes from orbit
    cameras, stacked, and the render camera."""
    from ivid_tpu_torch.inference.viewsets import _orbit
    from ivid_tpu_torch.ops import geometry as geom

    rng = np.random.default_rng(seed)
    ii = np.linspace(0, 1, s)
    yy, xx = np.meshgrid(ii, ii, indexing="ij")
    meshes = []
    for _ in range(n):
        ph = rng.uniform(0, 6.28)
        d01 = np.clip(0.35 + 0.3 * yy + 0.04 * np.sin(xx * 9 + ph)
                      + 0.05 * np.sin(xx * 21) * np.sin(yy * 17), 0.05, 0.95)
        mv = _orbit(rng.uniform(-0.35, 0.35), rng.uniform(-0.2, 0.2))
        depth = torch.from_numpy(d01.astype(np.float32)[..., None]).to(dev)
        meshes.append(geom.depth_to_mesh(
            geom.linearize_depth(depth, 0.6, 5.0), padding="frustum", fov=45.0,
            modelview=torch.from_numpy(mv).to(dev), atol=0.03, rtol=0.03,
            erode_rgb=3, cal_normal=True,
        ))
    target = torch.from_numpy(_orbit(0.2, 0.1)).to(dev)
    return geom.stack_meshes(meshes), target


def slot_input(dev, n, r=384, s=128):
    """The aggregation's raster of ``n`` live slots of s² views at r², as
    ``renderer._aggregation_view_buffers_all`` makes it."""
    from ivid_tpu_torch.ops import camera as cam
    from ivid_tpu_torch.ops import raster, renderer

    meshes, target = live_slots(dev, n, s)
    g = int(round(meshes.positions.shape[1] ** 0.5))
    attrs = renderer._aggregation_attrs(meshes)
    mvp = (cam.perspective(45.0, 1.0, 0.01, 200.0, device=dev) @ target).expand(n, 4, 4)
    win, w = raster.project_vertices(meshes.positions, mvp, r)
    pos = meshes.positions
    return Input(f"{n} slots of {s}² at {r}²", lambda: rd.grid_cols(win, w, attrs, pos, g, 3),
                 lambda m: m.rasterize_grid_dense_batched(win, w, attrs, pos, g, r, discard_attr=3),
                 r, attrs.shape[-1])


def warp_render_inputs(dev, batch=8, s=128, seed=0):
    """The first render of a training step's warp: ``batch`` SyntheticRGBDWarp
    items of the cond config at s², each lifted with an s-pixel skirt and seen
    from a drawn orbit pose, as ``renderer.simple_fragments`` gives them at
    r = 3s."""
    from ivid_tpu_torch.config import Config
    from ivid_tpu_torch.data import SyntheticRGBDWarp
    from ivid_tpu_torch.ops import geometry as geom
    from ivid_tpu_torch.ops import renderer
    from ivid_tpu_torch.ops import warp as warp_ops
    from ivid_tpu_torch.training import warp_cond

    args = dict(Config.load(str(COND_CFG)).dataset["args"], image_size=s)
    ds = SyntheticRGBDWarp(**args)
    x01 = torch.stack([torch.from_numpy(ds[i]["x_0"]) for i in range(batch)]).to(dev) * 0.5 + 0.5
    rng = HostNoise(seed, dev)
    pre = [warp_cond.presample(x, rng, augments=ds.augments, pose_std=ds.std) for x in x01]
    mv0 = warp_ops.default_modelview(dev)
    mesh = geom.stack_meshes([
        geom.depth_to_mesh(geom.linearize_depth(p[0][..., 3:], ds.near, ds.far), padding=s,
                           modelview=mv0)
        for p in pre
    ])
    mv1 = torch.stack([p[1] for p in pre])
    return renderer.simple_fragments(mesh, mv1, 45.0, 3 * s, 0.1, 200.0), 3 * s


def ring_input(f, r, sl=slice(None), name="8 rings"):
    """The skirt rings of the warp render ``f`` (buffers ``sl``), as
    ``render_simple_batch`` rasters them."""
    win, w, attrs, ring = f["win"][sl], f["w"][sl], f["attrs"][sl], f["ring"][sl]
    return Input(name, lambda: rd.tri_cols(win, w, attrs, ring, None),
                 lambda m: m.rasterize_tris_dense_batched(win, w, attrs, ring, r),
                 r, attrs.shape[-1])


def tri_set(tris, r, device="cpu", A=2):
    """Plane columns of an indexed set, one triangle per entry of ``tris``:
    ``(corners ((x, y), ...) x 3, z, attr, w)``, its own three vertices each
    (so attributes may jump across a shared edge). Channel 0 holds ``attr``,
    channel 1 a slope in x."""
    win, w, attrs = [], [], []
    for corners, z, attr, wv in tris:
        for x, y in corners:
            win.append([x, y, z])
            w.append(wv)
            attrs.append([attr, 0.25 * x / r][:A])
    win = torch.tensor([win], dtype=torch.float32, device=device)
    w = torch.tensor([w], dtype=torch.float32, device=device)
    attrs = torch.tensor([attrs], dtype=torch.float32, device=device)
    faces = torch.arange(win.shape[1], device=device).reshape(-1, 3)
    return rd.tri_cols(win, w, attrs, faces, None)


R_HAZ = 40
# Triangles of every hazard of the bins and the tie walk, at r = R_HAZ.
HAZARDS = [
    # A front-facing half quad and its back-facing other half: the shared
    # diagonal passes through the pixel centres (k+0.5, k+0.5) with both
    # edge functions exactly 0 and both depths 0.5, so they tie there.
    (((4, 4), (36, 4), (36, 36)), 0.5, 1.0, 1.0),
    (((4, 4), (4, 36), (36, 36)), 0.5, 3.0, 1.0),
    # Three copies of one triangle, nearer: a tie of three on every pixel.
    (((26, 6), (36, 6), (36, 16)), 0.4, 4.0, 1.0),
    (((26, 6), (36, 6), (36, 16)), 0.4, 6.0, 1.0),
    (((26, 6), (36, 6), (36, 16)), 0.4, 8.0, 1.0),
    # Partly off-screen, wholly off-screen.
    (((-10, 37), (10, 50), (12, 38)), 0.3, 7.0, 1.0),
    (((100, 100), (120, 100), (110, 120)), 0.2, 7.0, 1.0),
    # A skirt-like triangle reaching far beyond the buffer, over many tiles.
    (((-5000, 20), (38, 2), (38, 38)), 0.95, 2.0, 1.0),
    # Huge: corners beyond 1e6 and 1e8 pixels, and so large that the plane
    # coefficients overflow f32.
    (((-1e7, -1e7), (1e7, -1e7 + 5), (0, 1e7)), 0.8, 5.0, 1.0),
    (((-3e8, 10.3), (3e8, 10.7), (0.2, 3e8)), 0.9, 6.0, 1.0),
    (((-1e20, 0), (1e20, 1), (0, 1e20)), 0.7, 9.0, 1.0),
    # A sliver along the pixel centres of row 38.
    (((1.5, 38.5), (38.5, 38.5), (20, 38.50001)), 0.1, 9.0, 1.0),
] + [
    # Six copies of one triangle: more winners than K2 keeps per pixel.
    (((6, 26), (14, 26), (6, 34)), 0.45, float(k), 1.0) for k in range(1, 7)
] + [
    # Invalid: a corner behind the eye (w = 0), and a zero-area triangle.
    (((8, 20), (30, 20), (20, 30)), 0.05, 9.0, 0.0),
    (((5, 5), (10, 10), (15, 15)), 0.05, 9.0, 1.0),
]


def random_tris(seed, n=600, r=36):
    """Seeded triangles of every kind for :func:`tri_set`: small and large,
    slivers, corners on pixel centres, huge and off-screen ones, depths in
    and out of [0, 1]. Returns (tris, r)."""
    rng = np.random.default_rng(seed)
    tris = []
    for i in range(n):
        scale = 10 ** rng.uniform(-2, 7) if i % 5 else 10 ** rng.uniform(0, 1.5)
        c = rng.uniform(-10, r + 10, 2)
        p = c + rng.normal(size=(3, 2)) * scale
        if i % 7 == 0:  # sliver: the third corner near the others' midpoint
            p[2] = (p[0] + p[1]) / 2 + rng.normal(size=2) * 1e-4
        if i % 3 == 0:  # corners on pixel centres
            p = np.round(p - 0.5) + 0.5
        tris.append((tuple(map(tuple, p)), rng.uniform(-0.1, 1.1), rng.uniform(-2, 2),
                     rng.uniform(0.5, 2.0)))
    return tris, r


def bound_ms(cols, r, A):
    """Least time for the function on these columns, whatever the design: the
    bytes it must move (each valid triangle's 18 + 3A+4 floats read once, the
    DenseRaster written once: 4A + 6 bytes a pixel) at the memory rate, or
    the plane evaluations it must make (6 planes of 2 products and 2 sums at
    each pair of a pixel centre and a triangle that covers it, counted by the
    plain version's evaluation) at the unfused f32 rate, whichever is
    larger. Returns (ms, "bytes" or "operations", the counts)."""
    valid = cols.valid
    B = valid.shape[0]
    pairs = rd.covered_pairs(rd.prep_pack(cols, r, A), r)
    nv = int(valid.sum())
    nbytes = nv * (18 + 3 * A + 4) * 4 + B * r * r * (4 * A + 6)
    ops = pairs * 6 * 4
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_F32_UNFUSED
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations",
            {"bytes": nbytes, "operations": ops, "covered_pairs": pairs, "valid_triangles": nv})


def check(cols, r, A):
    """K2 on the card against its plain version on the same columns: depth,
    coverage and front equal on every pixel, attributes within ATTR_MAX, two
    launches bit-equal. Raises on a difference; returns the numbers, the
    bins' statistics and the plain version's ties (pixels with more than one
    winner, and the tiles holding one)."""
    got = rd.raster(cols, r, A)
    again = rd.raster(cols, r, A)
    sums = rd.raster_rows_sums(rd.prep_pack(cols, r, A), r, A)
    want = rd.finish(sums, r, A)
    *_, offsets, ids = rd.bin_tiles(cols, r)
    torch.cuda.synchronize()
    differ = {f: int((getattr(got, f) != getattr(want, f)).sum())
              for f in ("depth", "covered", "front")}
    err = (got.attrs - want.attrs).abs().max().item()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    per_tile = (offsets[1:] - offsets[:-1]).float()
    cnt = sums[:, 3 * A + 5]
    pid = torch.arange(cnt.numel(), device=cnt.device)
    nt = -(-r // rd.TILE)
    tile = (pid // (r * r)) * nt * nt + ((pid // r) % r // rd.TILE) * nt + pid % r // rd.TILE
    tied_tiles = torch.zeros(per_tile.numel(), dtype=torch.bool, device=cnt.device)
    tied_tiles[tile[cnt > 1]] = True
    out = {"pixels": got.depth.numel(), "covered": got.covered.float().mean().item(),
           "pixels_differing": differ, "max_abs_err": err, "bit_equal_relaunch": same,
           "bins_per_tile_mean": per_tile.mean().item(), "bins_per_tile_max": int(per_tile.max()),
           "listed": ids.numel(), "tied_pixels": int((cnt > 1).sum()),
           "most_winners": int(cnt.max()), "tiles_with_a_tie": int(tied_tiles.sum())}
    if any(differ.values()) or not err <= ATTR_MAX or not same:
        raise RuntimeError(f"K2 disagrees with its plain version: {out}")
    return out


def hazard_checks(dev):
    """:func:`check` on :data:`HAZARDS` and on two :func:`random_tris` sets:
    ties of 2, 3 and 6 winners, triangles off-screen, huge, invalid or
    slivers. Returns {name: check's numbers}."""
    sets = {"hazards": (HAZARDS, R_HAZ)}
    sets.update({f"random {seed}": random_tris(seed) for seed in (0, 1)})
    return {name: check(tri_set(tris, r, dev), r, 2) for name, (tris, r) in sets.items()}


_PKG = "ivid_tpu_torch"


def _take_package():
    """Take the package's modules (whichever version is loaded) out of
    ``sys.modules`` and return them."""
    names = [k for k in sys.modules if k == _PKG or k.startswith(_PKG + ".")]
    return {k: sys.modules.pop(k) for k in names}


class Other:
    """The ``ivid_tpu_torch`` package of another checkout at ``root``,
    imported beside this one. Its modules stand in ``sys.modules`` only
    inside ``with other:``, so the imports its functions make when called
    reach its own modules, and its kernels build from its own sources into
    its own build directory. ``rd`` and ``warp`` are its
    ``ops.raster_dense`` and ``ops.warp``, :meth:`module` any other of its
    modules: call them inside ``with``."""

    def __init__(self, root):
        self.root = Path(root).resolve()
        self.mods = {}
        with self:
            sys.path.insert(0, str(self.root))
            try:
                self.rd = importlib.import_module(f"{_PKG}.ops.raster_dense")
                self.warp = importlib.import_module(f"{_PKG}.ops.warp")
            finally:
                sys.path.remove(str(self.root))
        if not Path(self.rd.__file__).resolve().is_relative_to(self.root):
            raise RuntimeError(f"{self.rd.__file__} is not under {self.root}")

    def module(self, name):
        """Its module ``ivid_tpu_torch.<name>`` (e.g. ``"ops.resolve_variants"``)."""
        with self:
            return importlib.import_module(f"{_PKG}.{name}")

    def __enter__(self):
        self.saved = _take_package()
        sys.modules.update(self.mods)
        return self

    def __exit__(self, *exc):
        self.mods = _take_package()
        sys.modules.update(self.saved)


def _host_and_sync_ms(fn, reps=20, warmup=3):
    """Host ms per call of ``fn`` (CUDA events), and the host ms per call that
    this version's bins waited for the card (``raster_dense.sync_s``)."""
    rd.sync_s = 0.0
    ms = timing.host_ms(fn, reps, warmup)
    return ms, rd.sync_s * 1e3 / (reps + warmup)


def _call_ms(fn):
    """Device ms per call of a whole raster call, or None (not measured).
    Such a call runs hundreds of kernels: more than the stream's queue holds
    behind the spin kernel of ``timing.queued_ms``, and enough that the
    profiler sometimes loses some. So a reading is two calls under the
    profiler, taken up to ten times until a session holds every launch."""
    try:
        return timing.device_ms(fn, reps=2, warmup=1, sessions=10)
    except timing.NotQueued as e:
        warnings.warn(f"a raster call's device time was not measured: {e}", stacklevel=2)
        return None


def measure(inp: Input, listed: int, other: Other | None = None, plain=True, plain_reps=3):
    """Times of this version (``this``) on one input, in device ms unless the
    key says ``host_ms`` (CUDA events). ``listed`` is the length of the bins'
    lists (from :func:`check`), given to the timed calls so that they do not
    wait for it. ``kernels`` is the bins and the raster, ``all`` the same
    with the glue between them (from the columns to the DenseRaster),
    ``call_host_ms`` the public call on the host and ``sync_host_ms`` its
    wait for the lists' length. With ``other``, ``call`` is the public
    call's device work, columns included, of each version in turns (this
    version's with the lists' length given), and ``other_vs_this`` how far
    the other's output lies from this version's. ``plain_ms`` is the plain
    version over ``plain_reps`` calls after one."""
    cols, r, A = inp.cols(), inp.r, inp.A
    last = {}  # the offsets of the last timed call, checked once the timing is done

    def kernels():
        geom, pay, last["offsets"], ids = rd.bin_tiles(cols, r, listed)
        return rd.raster_tiles(geom, pay, last["offsets"], ids, r, A)

    res = {"this": {
        "columns_host_ms": timing.host_ms(inp.cols),
        "bins": timing.device_ms(kernels, match="k2_bin"),
        "bins_big": timing.device_ms(kernels, match="k2_bin_big"),
        "raster": timing.device_ms(kernels, match="k2_raster"),
        "kernels": timing.device_ms(kernels, match="k2_"),
        # Few calls per profiler session: sessions over thousands of kernels
        # have come back incomplete.
        "all": timing.device_ms(kernels, reps=5),
    }}
    if other is not None:
        def other_call():
            with other:
                return inp.call(other.rd)

        got, want = other_call(), inp.call(rd)
        res["other"] = {"other_vs_this": {
            "pixels_differing": sum(int((getattr(got, f) != getattr(want, f)).sum())
                                    for f in ("depth", "covered", "front")),
            "max_abs_diff": (got.attrs - want.attrs).abs().max().item()}}
        def this_call():
            geom, pay, last["offsets"], ids = rd.bin_tiles(inp.cols(), r, listed)
            return rd.raster_tiles(geom, pay, last["offsets"], ids, r, A)

        calls = {"this": this_call, "other": other_call}
        for name in ("other", "this", "this", "other"):
            res[name].setdefault("call", []).append(_call_ms(calls[name]))
    rd.check_capacity(last["offsets"], listed)
    res["this"]["call_host_ms"], res["this"]["sync_host_ms"] = _host_and_sync_ms(
        lambda: inp.call(rd))
    if plain:
        res["plain_ms"] = timing.host_ms(
            lambda: rd.raster_rows_reference(rd.prep_pack(cols, r, A), r, A), reps=plain_reps,
            warmup=1)
    return res


def aggregation_view(dev, other: Other | None = None, n=26, s=128):
    """Host ms (CUDA events, 5 calls) of one aggregation view of ``n`` live
    slots, ``warp.aggregate_conditions`` with the sampling pipeline's
    settings, as the ``3x9`` scene's last view makes it, and the host ms per
    view that K2's bins waited for the card; with ``other``, the other
    version's view in turns with this one's, and the largest difference of
    the two conditions."""
    from ivid_tpu_torch.ops import warp as warp_ops

    meshes, target = live_slots(dev, n, s)
    gen = torch.Generator(device=dev).manual_seed(3)
    colors = torch.rand((n, s, s, 3), generator=gen, device=dev)
    kw = dict(fov=45.0, near=0.6, far=5.0, atol=0.03, rtol=0.03, erode_rgb=3, ssaa=3)
    views = {"this": lambda: warp_ops.aggregate_conditions(meshes, colors, target, **kw)}
    if other is not None:
        def other_view():
            with other:
                return other.warp.aggregate_conditions(meshes, colors, target, **kw)

        views["other"] = other_view
    res = {"input": f"aggregation view, {n} slots"}
    order = ["other", "this", "this", "other"] if other is not None else ["this"]
    for name in order:
        ms, sync = _host_and_sync_ms(views[name], reps=5, warmup=2)
        res.setdefault(f"{name}_host_ms", []).append(ms)
        if name == "this":
            res.setdefault("this_sync_host_ms", []).append(sync)
    if other is not None:
        a, b = views["this"](), views["other"]()
        res["max_abs_diff"] = max((a[k].float() - b[k].float()).abs().max().item() for k in a)
    return res


def k2_registers():
    """ptxas's registers and spilled bytes (stores) of each K2 kernel, from the
    build log."""
    regs, name = {}, None
    for line in cuda_build.build_log.get("dense_raster", "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            k = re.search(r"(k2_\w+?)(?:ILi(\d+)E|ILb(\d)E|P|E)", m.group(1))
            name = (k.group(1) + "".join(f"<{g}>" for g in k.groups()[1:] if g)) if k else m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            regs.setdefault(name, [None, 0])[1] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs.setdefault(name, [None, 0])[0] = int(m.group(1))
    return regs


def inputs(dev, f=None, r_warp=None):
    """The four inputs: 4 and 26 slots, 8 rings and 1."""
    out = [slot_input(dev, n) for n in (4, 26)]
    if f is None:
        f, r_warp = warp_render_inputs(dev)
    return out + [ring_input(f, r_warp, slice(None), "8 rings"),
                  ring_input(f, r_warp, slice(0, 1), "1 ring")]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", default=None, help="root of another checkout to compare with")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_raster: no CUDA device")
    cuda_build.build(["dense_raster"])
    print(json.dumps({"registers": k2_registers()}), flush=True)
    other = Other(args.other) if args.other else None
    dev = torch.device("cuda")
    for name, stats in hazard_checks(dev).items():
        print(json.dumps({"input": name, **stats}), flush=True)
    for inp in inputs(dev):
        cols = inp.cols()
        stats = check(cols, inp.r, inp.A)
        bound, by, work = bound_ms(cols, inp.r, inp.A)
        del cols
        print(json.dumps({"input": inp.name, "r": inp.r, "A": inp.A, **stats, "bound_ms": bound,
                          "bound_by": by, **work}), flush=True)
        print(json.dumps({"input": inp.name, **measure(inp, stats["listed"], other)}),
              flush=True)
    print(json.dumps(aggregation_view(dev, other)), flush=True)
    print(timing.card_line(), flush=True)


if __name__ == "__main__":
    main()
