"""Time the z-buffer resolves on fragments with a rasterizer's statistics:

    python -m ivid_tpu_torch.bench_resolve [--device cuda|cpu] [--n N] [--r R] [--buffers B]
        [--stack | --warp] [--other DIR]

Port of the repository's ``bench_resolve.py``. ``N`` fragments (default
733,184, about one 384² aggregation slot) over ``B`` framebuffers of ``R``²
(defaults 384 and 1): a smooth curve down each buffer with 6-pixel Gaussian
jitter, so consecutive fragments land near each other, and uniform depth and
3-channel payload. The same statistics as the JAX script, not the same
numbers (``torch.Generator``, seeded). ``--stack`` adds 4,096 fragments on
each of 64 pixels in 64 tiles, at 8 depth levels (:func:`make_stacked`);
``--warp`` takes the first render of a training step's warp instead
(``bench_raster.warp_render_inputs``: 8 x 384², the first 3 payload channels).

First the sort-then-tile prototype (``prepare_tiles``, then K6 and
``tile_finish``) and, on the card, K3 are held against the plain two-scatter
resolve on these fragments: depth and coverage equal on every pixel, payload
within 1e-5 (tie sums in another order). Then one JSON line per timed call:
fragment generation, ``resolve_zbuffer_scatter``, K3's preparation (sort and
run search) and kernel, the sort alone, K3's run search alone (a search of
the sorted keys for every pixel), and the prototype's preparation (sort and
tile search) and kernel K6. Last, K6's own line (:func:`k6_line`): K6 held to
its plain version (depth and count equal on every pixel, sums within 1e-5 of
the sum or of 1, two launches bit-equal), its device time warm and with the L2 cache cleared
before each call, the bytes bound and the plain version's time; with
``--other DIR``, the root of another checkout (e.g. an earlier commit
unpacked with ``git archive``), that checkout's K6 too
(``bench_raster.Other``), its output held to this one's, the two timed in
turns (other, this, this, other). On the card each line holds device time
``ms`` and CUDA events ``host_ms`` (``ivid_tpu_torch.timing``), and the
card's name and power limit follow; on the CPU (``--device cpu``, where K3
does not run) only ``cpu_ms``, host time of PyTorch's CPU kernels.
"""

from __future__ import annotations

import argparse
import json

import torch

from ivid_tpu_torch import timing
from ivid_tpu_torch.ops import raster, raster_tiled, resolve_variants

N = 733_184
R = 384
PAY_TOL = 1e-5  # tie averages summed in another order
SEED = 5
# --stack: fragments on each of STACK_PIXELS pixels (one per tile), depths
# drawn from STACK_LEVELS levels, so exact ties stack.
STACK_PIXELS = 64
STACK_PER_PIXEL = 4096
STACK_LEVELS = 8
PEAK_BYTES = 3.35e12  # H100 SXM memory rate (NVIDIA data sheet), for the bound


def make_batch(gen: torch.Generator, n: int, r: int, buffers: int = 1):
    """``n`` valid fragments with global pixel ids ``b·r² + y·r + x``: buffer
    ``b`` takes the ``b``-th ``n / buffers`` of them along a curve ``x = (0.5 +
    0.4 sin 37t) r``, ``y = t r`` (t from 0 to 1) with N(0, 6²)-pixel jitter;
    depth and 3 payload channels uniform in [0, 1). Returns the
    ``FragmentBatch`` and the payload [n, 3]."""
    dev = gen.device
    u = torch.arange(n, dtype=torch.float64, device=dev) * (buffers / n)
    b = torch.clamp(u.floor(), max=buffers - 1)
    t = (u - b).float()
    cx = (0.5 + 0.4 * torch.sin(t * 37)) * r
    cy = t * r
    x = torch.clamp(cx + torch.randn(n, generator=gen, device=dev) * 6, 0, r - 1).long()
    y = torch.clamp(cy + torch.randn(n, generator=gen, device=dev) * 6, 0, r - 1).long()
    pix = b.long() * (r * r) + y * r + x
    depth = torch.rand(n, generator=gen, device=dev)
    pay = torch.rand((n, 3), generator=gen, device=dev)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    return raster.FragmentBatch(pixel=pix, depth=depth, attrs=pay, front=valid, valid=valid), pay


def make_stacked(gen: torch.Generator, n: int, r: int, buffers: int = 1,
                 pixels: int = STACK_PIXELS, per_pixel: int = STACK_PER_PIXEL):
    """:func:`make_batch`'s fragments, then ``per_pixel`` more on each of
    ``pixels`` pixels (at most one per 1024-pixel tile, the tiles spread
    evenly, the pixel in each drawn), what a mesh seen edge-on or the folds
    of a warp's skirt put on one pixel: depths drawn from ``STACK_LEVELS``
    uniform levels, so exact ties stack, and uniform payload."""
    fb, pay = make_batch(gen, n, r, buffers)
    dev = gen.device
    tiles = buffers * r * r // resolve_variants.TILE
    k = min(pixels, tiles)
    tile = torch.arange(k, device=dev) * tiles // k
    pix = tile * resolve_variants.TILE + torch.randint(0, resolve_variants.TILE, (k,),
                                                       generator=gen, device=dev)
    m = k * per_pixel
    levels = torch.rand(STACK_LEVELS, generator=gen, device=dev)
    depth = levels[torch.randint(0, STACK_LEVELS, (m,), generator=gen, device=dev)]
    spay = torch.rand((m, 3), generator=gen, device=dev)
    valid = torch.ones(n + m, dtype=torch.bool, device=dev)
    pay = torch.cat([pay, spay])
    return raster.FragmentBatch(pixel=torch.cat([fb.pixel, pix.repeat_interleave(per_pixel)]),
                                depth=torch.cat([fb.depth, depth]), attrs=pay, front=valid,
                                valid=valid), pay


def tile_bytes(bounds, lp):
    """The bytes K6 must move on these inputs: the bounds, lp, z and payload
    (20 bytes) of each fragment in the tiles' ranges that falls on a pixel
    (the others sort last in their tile and are cut off by a search), and
    the [T, 5, 1024] f32 output."""
    seg = lp[int(bounds[0]):int(bounds[-1])]
    falls = int(((seg >= 0) & (seg < resolve_variants.TILE)).sum())
    tiles = bounds.numel() - 1
    return bounds.numel() * 4 + falls * 20 + tiles * 5 * resolve_variants.TILE * 4


def tile_diff(got, want):
    """Two ``[T, 5, 1024]`` row-7 outputs: the values that differ in depth
    (row 0) or count (row 4), the sums' largest difference, and their
    largest difference relative to the sum where that is above 1 (f32 holds
    a sum of ~256, a stacked pixel's, to 3e-5: no 1e-5 there)."""
    bad = int((got[:, [0, 4]] != want[:, [0, 4]]).sum())
    diff = (got[:, 1:4] - want[:, 1:4]).abs()
    rel = diff / want[:, 1:4].abs().clamp(min=1.0)
    return bad, diff.max().item(), rel.max().item()


def ptxas_notes(cb) -> list:
    """ptxas's lines on K6's registers, shared memory and spills, from the
    build log of a ``cuda_build`` module (a build in this process)."""
    return [line.strip() for line in cb.build_log.get("tile_resolve", "").splitlines()
            if "Used" in line or "spill" in line]


def _k6_ms(fn, cold=False):
    """Device ms of K6's own kernel per call of ``fn``. None for a ``cold``
    call (the L2 write before it) whose reading fell back to queued events,
    which would count the write too."""
    before = timing.fallbacks
    ms = timing.device_ms(fn, match="tile_resolve")
    return None if cold and timing.fallbacks != before else ms


def k6_line(prepared, dev, other=None) -> dict:
    """K6 on ``prepare_tiles``'s output: held to its plain version (raises
    unless depth and count agree on every pixel, the sums within
    ``PAY_TOL`` of the sum or of 1, the larger (:func:`tile_diff`), and two
    launches are bit-equal), with ``other`` (a ``bench_raster.Other``) that
    checkout's K6 held to this one's. ``plain_self_diff`` is the plain
    version's own spread: two calls' largest sum difference (on the card it
    adds by atomics, in an order that varies). On the
    card: device ms warm (``ms``) and with the L2 cache cleared before each
    call (``cold_ms``), per version in turns (other, this, this, other); the
    bytes bound (:func:`tile_bytes` at ``PEAK_BYTES``); the plain version's
    ms by CUDA events. On the CPU: ``cpu_ms`` of each version."""
    rv = resolve_variants
    bounds, lp = prepared[:2]
    got = rv.tile_resolve(*prepared)
    want = rv.tile_resolve_reference(*prepared)
    bad, err, rel = tile_diff(got, want)
    bit_equal = torch.equal(got, rv.tile_resolve(*prepared))
    if bad or not rel <= PAY_TOL or not bit_equal:
        raise RuntimeError(f"K6 disagrees with its plain version: {bad} depth/count values "
                           f"differ, max|sum err| {err:.3e} ({rel:.3e} of the sum or 1), two "
                           f"launches bit-equal {bit_equal}")
    calls = {"this": lambda: rv.tile_resolve(*prepared)}
    line = {"tiles": bounds.numel() - 1, "fragments": lp.numel(),
            "longest_tile": int((bounds[1:] - bounds[:-1]).max()),
            "staging": rv.TILE_STAGING, "max_sum_err": err, "max_sum_rel": rel,
            "plain_self_diff": tile_diff(rv.tile_resolve_reference(*prepared), want)[1],
            "bit_equal": bit_equal}
    if other is not None:
        orv = other.module("ops.resolve_variants")

        def other_call():
            with other:
                return orv.tile_resolve(*prepared)

        obad, oerr, orel = tile_diff(other_call(), got)
        if obad or not orel <= PAY_TOL:
            raise RuntimeError(f"the other K6 disagrees with this one: {obad} depth/count "
                               f"values differ, max|sum diff| {oerr:.3e} ({orel:.3e} relative)")
        calls["other"] = other_call
        line["vs_other"] = {"depth_count_differ": obad, "max_sum_diff": oerr, "max_sum_rel": orel}
    order = ["other", "this", "this", "other"] if other is not None else ["this", "this"]
    if dev.type != "cuda":
        line["cpu_ms"] = {n: timing.call_ms(fn, dev)["cpu_ms"] for n, fn in calls.items()}
        return line
    cold = {n: timing.l2_cleared(fn, dev) for n, fn in calls.items()}
    line["ms"] = {n: [] for n in calls}
    line["cold_ms"] = {n: [] for n in calls}
    for n in order:
        line["ms"][n].append(_k6_ms(calls[n]))
        line["cold_ms"][n].append(_k6_ms(cold[n], cold=True))
    del cold
    nbytes = tile_bytes(bounds, lp)
    line.update(bytes=nbytes, bound_ms=nbytes / PEAK_BYTES * 1e3, bound_by="bytes",
                plain_ms=timing.host_ms(lambda: rv.tile_resolve_reference(*prepared), 5, 1))
    return line


def compare(got, want, tag: str) -> float:
    """Raises unless ``got`` and ``want`` (``(payload, depth_win, covered)``)
    agree: coverage and depth on every pixel, payload within ``PAY_TOL``.
    Returns the payload's largest error."""
    cov_bad = int((got[2] != want[2]).sum())
    depth_bad = int((got[1] != want[1]).sum())
    err = (got[0] - want[0]).abs().max().item()
    if cov_bad or depth_bad or not err <= PAY_TOL:
        raise RuntimeError(f"{tag} disagrees with the plain resolve: coverage {cov_bad} and "
                           f"depth {depth_bad} pixels differ, max|payload err| {err:.3e}")
    return err


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--n", type=int, default=N, help="fragments")
    ap.add_argument("--r", type=int, default=R, help="framebuffer side")
    ap.add_argument("--buffers", type=int, default=1, help="stacked framebuffers")
    which = ap.add_mutually_exclusive_group()
    which.add_argument("--stack", action="store_true",
                       help=f"add {STACK_PER_PIXEL} fragments on each of {STACK_PIXELS} pixels")
    which.add_argument("--warp", action="store_true",
                       help="the first render of a training step's warp instead")
    ap.add_argument("--other", default=None, help="root of another checkout whose K6 to time")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_resolve: no CUDA device")
    other = None
    if args.other:
        from ivid_tpu_torch.bench_raster import Other

        other = Other(args.other)
    if dev.type == "cuda":
        from ivid_tpu_torch import cuda_build

        cuda_build.build(["tile_resolve"])
        notes = {"this": ptxas_notes(cuda_build)}
        if other is not None:
            ocb = other.module("cuda_build")
            ocb.build(["tile_resolve"])
            notes["other"] = ptxas_notes(ocb)
        print(json.dumps({"bench": "resolve", "ptxas": notes}), flush=True)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n, r, nb = args.n, args.r, args.buffers
    if args.warp:
        from ivid_tpu_torch.bench_raster import warp_render_inputs

        f, r = warp_render_inputs(dev)
        pix, d, valid, pay = raster._concat([f["fragments"]], [f["payload"][..., :3]])
        fb = raster.FragmentBatch(pixel=pix, depth=d, attrs=pay, front=valid, valid=valid)
        pay, nb, name = pay.contiguous(), f["win"].shape[0], "warp render"
    elif args.stack:
        fb, pay = make_stacked(gen, n, r, nb)
        stacked = min(STACK_PIXELS, nb * r * r // resolve_variants.TILE)
        name = f"stacked: {stacked} x {STACK_PER_PIXEL} more"
    else:
        fb, pay = make_batch(gen, n, r, nb)
        name = "clustered"
    n = fb.pixel.numel()
    npix = nb * r * r
    frags, pays = [fb], [pay]
    print(f"bench_resolve: {n} fragments ({name}) over {nb} x {r}² on {dev}", flush=True)

    def proto_prep():
        return resolve_variants.prepare_tiles(fb.pixel, fb.depth, pay, fb.valid, npix)

    prepared = proto_prep()
    want = raster.resolve_zbuffer_scatter(frags, pays, r, nb)
    got = resolve_variants.tile_finish(resolve_variants.tile_resolve(*prepared), r, nb)
    errs = {"prototype": compare(got, want, "the prototype (K6)")}
    calls = {
        "resolve_zbuffer_scatter": lambda: raster.resolve_zbuffer_scatter(frags, pays, r, nb),
    }
    if not (args.warp or args.stack):
        calls = {"fragment generation": lambda: make_batch(gen, n, r, nb), **calls}
    if dev.type == "cuda":
        errs["K3"] = compare(raster_tiled.resolve_zbuffer_tiled(frags, pays, r, nb), want, "K3")
        k3_in = raster_tiled.prepare(frags, pays, r, nb)
        calls["K3 prep (sort, run search)"] = lambda: raster_tiled.prepare(frags, pays, r, nb)
        calls["K3 kernel"] = lambda: raster_tiled.launch(*k3_in, r, nb)
    key = torch.where(fb.valid, fb.pixel, torch.full_like(fb.pixel, npix))
    calls["sort alone (keys, stable)"] = lambda: torch.sort(key, stable=True)
    key_s = torch.sort(key).values
    edges = torch.arange(npix + 1, device=dev)
    calls["run search alone (npix + 1 edges)"] = lambda: torch.searchsorted(key_s, edges)
    calls["prototype prep (sort, tile search)"] = proto_prep
    calls["prototype kernel K6"] = lambda: resolve_variants.tile_resolve(*prepared)
    rows = []
    for row_name, fn in calls.items():
        rows.append({"bench": "resolve", "name": row_name, **timing.call_ms(fn, dev)})
        print(json.dumps(rows[-1]), flush=True)
    k6 = {"bench": "resolve", "input": name, **k6_line(prepared, dev, other)}
    print(json.dumps(k6), flush=True)
    print(json.dumps({"bench": "resolve", "input": name, "fragments": n, "pixels": npix,
                      "tiles": npix // resolve_variants.TILE, "max_payload_err": errs}), flush=True)
    if dev.type == "cuda":
        print(timing.card_line(), flush=True)
    return {"rows": rows, "k6": k6, "max_payload_err": errs}


if __name__ == "__main__":
    main()
