"""Time the z-buffer resolves on fragments with a rasterizer's statistics:

    python -m ivid_tpu_torch.bench_resolve [--device cuda|cpu] [--n N] [--r R] [--buffers B]

Port of the repository's ``bench_resolve.py``. ``N`` fragments (default
733,184, about one 384² aggregation slot) over ``B`` framebuffers of ``R``²
(defaults 384 and 1): a smooth curve down each buffer with 6-pixel Gaussian
jitter, so consecutive fragments land near each other, and uniform depth and
3-channel payload. The same statistics as the JAX script, not the same
numbers (``torch.Generator``, seeded).

First the sort-then-tile prototype (``prepare_tiles``, then K6 and
``tile_finish``) and, on the card, K3 are held against the plain two-scatter
resolve on these fragments: depth and coverage equal on every pixel, payload
within 1e-5 (tie sums in another order). Then one JSON line per timed call:
fragment generation, ``resolve_zbuffer_scatter``, K3's preparation (sort and
run search) and kernel, the sort alone, K3's run search alone (a search of
the sorted keys for every pixel), and the prototype's preparation (sort and
tile search) and kernel K6. On the card each line holds device
time ``ms`` and CUDA events ``host_ms`` (``ivid_tpu_torch.timing``), and the
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
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_resolve: no CUDA device")
    n, r, nb = args.n, args.r, args.buffers
    npix = nb * r * r
    gen = torch.Generator(device=dev).manual_seed(SEED)
    fb, pay = make_batch(gen, n, r, nb)
    frags, pays = [fb], [pay]
    print(f"bench_resolve: {n} fragments over {nb} x {r}² on {dev}", flush=True)

    def proto_prep():
        return resolve_variants.prepare_tiles(fb.pixel, fb.depth, pay, fb.valid, npix)

    prepared = proto_prep()
    want = raster.resolve_zbuffer_scatter(frags, pays, r, nb)
    got = resolve_variants.tile_finish(resolve_variants.tile_resolve(*prepared), r, nb)
    errs = {"prototype": compare(got, want, "the prototype (K6)")}
    calls = {
        "fragment generation": lambda: make_batch(gen, n, r, nb),
        "resolve_zbuffer_scatter": lambda: raster.resolve_zbuffer_scatter(frags, pays, r, nb),
    }
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
    for name, fn in calls.items():
        rows.append({"bench": "resolve", "name": name, **timing.call_ms(fn, dev)})
        print(json.dumps(rows[-1]), flush=True)
    print(json.dumps({"bench": "resolve", "fragments": n, "pixels": npix,
                      "tiles": npix // resolve_variants.TILE, "max_payload_err": errs}), flush=True)
    if dev.type == "cuda":
        print(timing.card_line(), flush=True)
    return {"rows": rows, "max_payload_err": errs}


if __name__ == "__main__":
    main()
