#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi), then the six
   kernels built from ``ivid_tpu_torch/csrc`` with nvcc for sm_90a, one nvcc
   per source, all at once;
2. K1 (packed attention) against its plain version at [2, 1024, 768] (the
   sampling shape) and [8, 1024, 768] (the training forward's), 4 heads, in
   bf16 and f32, with the log-sum-exp it stores for training held to its
   plain version too, timed beside the plain version and torch's
   scaled_dot_product_attention on the unpacked layout (each also by the
   profiler's fallback, calls queued behind a spin kernel, as a
   cross-check of the two device-time readings); then the same checks
   at the SR cascade's shapes [2, 4096, 768] (T=4096) and [2, 1024, 1152]
   (6 heads);
3. K2 (dense grid raster) against its plain version on live aggregation
   slots: four 128² seeded RGBD meshes rendered at r=384 from an orbit view;
4. K3 (z-buffer resolve) against its plain version on the first warp render
   of a training step: 8 SyntheticRGBDWarp 128² items at r=384;
5. K2 on indexed triangles (the same render's skirt rings) at B=8 and B=1;
   then K6 (the sort-then-tile resolve prototype) against its plain version
   at ``bench_resolve``'s shape and, with ``tile_finish``, against K3 and the
   scatter on the same render, its preparation and kernel timed beside K3's;
   K5 (the pre-binned resolve prototype) against its plain version at
   ``bench_micro``'s shape; then ``ivid_tpu_torch.bench_resolve.main`` and
   ``ivid_tpu_torch.bench_micro.main`` at their defaults;
6. K4 (packed attention backward) against autograd of the plain version
   and against its plain formula form at the training shape [8, 1024, 768],
   4 heads, and at the SR shapes, bf16 and f32;
7. the full-width single-category UNet (random seeded weights, batch 2) on
   the card with K1 in f32 against the same weights on the CPU plain path;
8. a small 3-view sampling chain (32² f32 UNets, K1 and K2 on its path) on
   the card against the same weights and noise on the CPU plain path;
9. a small training chain (32² f32 cond UNet, InpaintTrainer, batch 2, 3
   AdamW steps, K1/K4/K3/K2 on its path) on the card against the CPU plain
   path with the same weights and draws;
10. the sampling pipeline through ``ivid_tpu_torch.sample.main``: random
    viewset, batch 2, 1000-step DDPM then 50-step guided DDIM;
11. training through ``ivid_tpu_torch.train.main``: the full-width
    single-category cond model on SyntheticRGBDWarp 128², batch 8, 6 AdamW
    steps with a checkpoint at step 3 and a reload;
12. the same trainer's step (``run_step``) timed by stage with CUDA events
    over 10 more steps, then 2 steps under torch.profiler: kernels, device
    kernel time and idle share per step, and the top kernels.

Each main path (the benches of 5, and 10, 11) runs with every launch
counter set to 0 just before it and read just after. Then one JSON line
with every kernel's numbers, the nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``.
Without a CUDA device it exits non-zero and prints no result.

Times (``ivid_tpu_torch.timing``): a kernel's ``ms`` and the library call's
``library_ms`` are device time, the durations torch.profiler records for
what 20 warmed-up calls ran on the device, per call, or, when two profiler
sessions record none of it, CUDA events around 20 calls queued behind a spin
kernel (a ``[timing]`` line says so, and the count of such readings is
printed before the kernels line); ``host_ms`` is CUDA events around 20 such
calls, which measure the host's issue time whenever that is longer.
``plain_ms`` and the prep times are CUDA events.
"""

import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

UNCOND_CFG = os.path.join(ROOT, "configs", "rgbd_singlecategory_adm_128_small.json")
COND_CFG = os.path.join(ROOT, "configs", "rgbd_singlecategory_adm_128_small_cond.json")

# Tolerances (and why):
# K1 bf16 vs the plain version in f32 on the same bf16 inputs: the kernel
# computes in f32 and rounds the output to bf16 (2^-9 relative on |o| <= ~3).
K1_BF16_MAX, K1_BF16_MEAN = 2e-2, 2e-3
# K1 f32 vs plain f32 (TF32 off): only the summation order differs.
K1_F32_MAX = 1e-4
# K2 vs plain: both evaluate the planes with the same f32 roundings, so only
# measure-zero pixel-centre ties may flip (a depth differs when off by > 1e-6);
# attrs where both agree on the winning depth differ only by tie-sum order.
K2_PIXEL_FRAC, K2_ATTR_MAX = 1e-3, 1e-3
# UNet on the card (f32, TF32 off, K1) vs the CPU plain path: accumulation
# order across ~100 layers.
UNET_REL = 1e-3
# Small chain on the card vs the CPU plain path (f32, TF32 off): per-forward
# differences of ~1e-6 carried through 20 steps; a condition-mask pixel flips
# only where a pixel centre or a depth difference sits on a knife edge.
CHAIN_REL, CHAIN_MASK_FRAC = 1e-3, 1e-2
# K1's log-sum-exp vs torch.logsumexp of the f32 logits: summation order
# (f32), and bf16 inputs rounded the same on both sides (bf16 path).
K1_LSE_MAX = 1e-4
# K3 vs its plain version on the card: depth and coverage are one minimum,
# equal on every pixel; the payload is a tie average whose sum order differs
# (the scatter adds with atomics).
K3_PAY_MAX = 1e-5
# K4 vs autograd of the plain version in f32 on the same inputs: f32 sums in
# another order (f32 path); bf16 rounding of P and dS as product operands and
# of the output, ~2^-9 relative per term (bf16 path).
K4_F32_MAX, K4_BF16_REL = 1e-4, 1e-2
# K5 and K6 vs their plain versions on the card: the depth minimum and the
# winner count are one minimum and one count, equal on every pixel; the sums
# differ by f32 sum order (K5 adds with atomics, in an order that varies).
K56_SUM_MAX = 1e-5
# Training chain on the card vs the CPU plain path (f32, TF32 off, the same
# draws): the losses differ by f32 sum order and by warp-mask pixels on knife
# edges; AdamW steps of ~1e-4 per element may flip sign where a gradient is
# ~0, which moves the parameters by < 1e-5 relative L2.
TRAIN_LOSS_REL, TRAIN_PARAM_REL = 1e-3, 1e-5

# The card's published peaks (NVIDIA H100 SXM data sheet) for the bounds.
PEAK_BYTES = 3.35e12
PEAK_BF16 = 989e12
PEAK_F32 = 67e12


KERNELS = ("packed_attention", "packed_attention_bwd", "dense_raster", "zbuffer_resolve",
           "binned_resolve", "tile_resolve")


def log(msg):
    print(msg, flush=True)


def cuda_time_ms(fn, reps=20, warmup=3):
    """Milliseconds per call by CUDA events around ``reps`` calls."""
    from ivid_tpu_torch import timing

    return timing.host_ms(fn, reps, warmup)


def timed(fn, match=None):
    """(device ms, host ms) per call of ``fn``: device time from
    torch.profiler (only activities whose name holds ``match``, if given)
    and CUDA events around the calls."""
    from ivid_tpu_torch import timing

    before = timing.fallbacks
    ms = timing.device_ms(fn, match=match)
    if timing.fallbacks != before:
        log(f"[timing] torch.profiler recorded no usable session; device time {ms:.4f} ms "
            f"read by CUDA events around calls queued behind a spin kernel")
    return ms, timing.host_ms(fn)


def phase_device():
    from ivid_tpu_torch import cuda_build, timing

    pkg = os.path.dirname(cuda_build.__file__)
    if os.path.dirname(pkg) != ROOT:
        raise RuntimeError(f"ivid_tpu_torch imported from {pkg}, not from this checkout")
    import torch

    smi = timing.card_line()
    log(f"[device] {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    cuda_build.build(KERNELS)
    for name in KERNELS:
        cuda_build.load(name)
    log(f"[device] built {sorted(cuda_build.build_seconds)} with nvcc for sm_90a in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in cuda_build.build_seconds.items())})")
    for name, text in cuda_build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[device] ptxas {name}: {line.strip()}")
    return smi


def attention_bound_ms(b, t, heads, dtype, backward=False):
    """Least time for packed attention at [b, t, 3·heads·64]: the products'
    flops (forward 4·B·H·T²·D, backward 10·B·H·T²·D) at the type's peak, or
    the operand bytes (qkv, out; backward also dout, lse and dqkv) at the
    memory rate, whichever is larger."""
    import torch

    d = 64
    size = 2 if dtype == torch.bfloat16 else 4
    flops = (10 if backward else 4) * b * heads * t * t * d
    nbytes = (b * t * 3 * heads * d + b * t * heads * d) * size
    if backward:
        nbytes += (b * t * heads * d + b * t * 3 * heads * d) * size + b * heads * t * 4
    t_ops = flops / (PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
    t_bytes = nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase_attention(b, seed, training, t=1024, heads=4, time_f32=True):
    """K1 at [b, t, 3·heads·64]: b=2 at T=1024 with 4 heads is the sampling
    shape; b=8 with ``training`` the training forward's, which also writes
    the log-sum-exp, so the entry's ``ms`` is the kernel's with it; T=4096
    and 6 heads are the SR cascade's shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ivid_tpu_torch import timing
    from ivid_tpu_torch.ops import attention

    dev = torch.device("cuda")
    d = 64
    c = heads * d
    scale = float(d ** -0.25)
    qkv32 = torch.from_numpy(
        np.random.default_rng(seed).standard_normal((b, t, 3 * c)).astype(np.float32)
    ).to(dev)
    qkv16 = qkv32.to(torch.bfloat16)
    tag = f"[K1] [{b},{t},{3 * c}] {heads} heads"

    got16, lse16 = attention._launch(qkv16, heads, scale, with_lse=True)
    want16 = attention.reference_attention(qkv16.float(), heads, scale)
    err16 = (got16.float() - want16).abs()
    got32, lse32 = attention._launch(qkv32, heads, scale, with_lse=True)
    want32 = attention.reference_attention(qkv32, heads, scale)
    err32 = (got32 - want32).abs()

    lse_err = max((lse16 - attention.logsumexp_reference(qkv16, heads, scale)).abs().max().item(),
                  (lse32 - attention.logsumexp_reference(qkv32, heads, scale)).abs().max().item())
    torch.cuda.synchronize()
    max16, mean16, max32 = err16.max().item(), err16.mean().item(), err32.max().item()
    del want16, want32, err16, err32
    log(f"{tag}: bf16 max|err| {max16:.3e} (<= {K1_BF16_MAX}) mean {mean16:.3e} "
        f"(<= {K1_BF16_MEAN}); f32 max|err| {max32:.3e} (<= {K1_F32_MAX}); "
        f"log-sum-exp max|err| {lse_err:.3e} (<= {K1_LSE_MAX})")
    if not (max16 <= K1_BF16_MAX and mean16 <= K1_BF16_MEAN and max32 <= K1_F32_MAX
            and lse_err <= K1_LSE_MAX):
        raise RuntimeError("K1 disagrees with its plain version")

    q, k, v = qkv16.reshape(b, t, heads, 3 * d).split(d, dim=-1)
    q, k, v = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms, host = timed(lambda: attention.packed_attention(qkv16, heads, scale))
    lse_ms, lse_host = timed(lambda: attention._launch(qkv16, heads, scale, with_lse=True))
    plain_ms = cuda_time_ms(lambda: attention.reference_attention(qkv16, heads, scale))
    sdpa_ms, sdpa_host = timed(lambda: F.scaled_dot_product_attention(q, k, v))
    # The other device-time reading (the profiler's fallback), as a cross-check.
    queued = timing.queued_ms(lambda: attention.packed_attention(qkv16, heads, scale))
    sdpa_queued = timing.queued_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    bound, bound_by = attention_bound_ms(b, t, heads, torch.bfloat16)
    bound32, _ = attention_bound_ms(b, t, heads, torch.float32)
    entry = {
        "name": "packed_attention_train" if training else "packed_attention", "route": "cuda",
        "source": "ivid_tpu_torch/csrc/packed_attention.cu",
        "replaces": "ivid_tpu/ops/attention.py:167",
        "max_abs_err": max16, "ms": lse_ms if training else ms,
        "host_ms": lse_host if training else host, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": sdpa_ms,
        "library_host_ms": sdpa_host, "queued_ms": queued, "library_queued_ms": sdpa_queued,
        "shape": [b, t, 3 * c], "heads": heads, "no_lse_ms": ms, "lse_ms": lse_ms, "lse_max_abs_err": lse_err,
        "f32_max_abs_err": max32, "f32_bound_ms": bound32,
    }
    f32 = ""
    if time_f32:
        ms32, host32 = timed(lambda: attention.packed_attention(qkv32, heads, scale))
        plain32_ms = cuda_time_ms(lambda: attention.reference_attention(qkv32, heads, scale))
        entry.update(f32_ms=ms32, f32_host_ms=host32, f32_plain_ms=plain32_ms)
        f32 = (f"; f32: kernel {ms32:.4f} ms (host {host32:.4f}, bound {bound32:.4f} ms), "
               f"plain {plain32_ms:.4f} ms")
    log(f"{tag} bf16: kernel {ms:.4f} ms device, {host:.4f} host (with log-sum-exp "
        f"{lse_ms:.4f} / {lse_host:.4f}; bound {bound:.4f} ms by {bound_by}), plain "
        f"{plain_ms:.4f} ms, SDPA (unpacked, timing only) {sdpa_ms:.4f} device, "
        f"{sdpa_host:.4f} host; queued behind a spin: kernel {queued:.4f}, SDPA "
        f"{sdpa_queued:.4f}{f32}")
    return entry


def live_slots(dev, n=4, s=128, seed=0):
    """n seeded 128² depth maps lifted to frustum-skirt meshes from orbit
    cameras, stacked, and the render camera."""
    import numpy as np
    import torch

    from ivid_tpu_torch.inference.viewsets import _orbit
    from ivid_tpu_torch.ops import geometry as geom

    rng = np.random.default_rng(seed)
    ii = np.linspace(0, 1, s)
    yy, xx = np.meshgrid(ii, ii, indexing="ij")
    meshes = []
    for v in range(n):
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


def compare_dense(got, want, tag):
    """Pixel mismatch fractions and the attribute error where both agree on
    the depth; raises past the K2 tolerances."""
    cov_frac = (got.covered != want.covered).float().mean().item()
    front_frac = (got.front != want.front).float().mean().item()
    same_z = got.covered & want.covered & ((got.depth - want.depth).abs() <= 1e-6)
    depth_frac = 1.0 - (same_z | (~got.covered & ~want.covered)).float().mean().item()
    attr_err = (got.attrs - want.attrs).abs()[same_z].max().item() if same_z.any() else 0.0
    log(f"[{tag}] covered {want.covered.float().mean().item():.3f}; mismatched pixels: "
        f"coverage {cov_frac:.2e}, front {front_frac:.2e}, depth {depth_frac:.2e} "
        f"(each <= {K2_PIXEL_FRAC}); max|attr err| where both agree on depth {attr_err:.3e} "
        f"(<= {K2_ATTR_MAX}) over {got.covered.numel()} pixels")
    if not (cov_frac <= K2_PIXEL_FRAC and front_frac <= K2_PIXEL_FRAC
            and depth_frac <= K2_PIXEL_FRAC and attr_err <= K2_ATTR_MAX and same_z.any()):
        raise RuntimeError(f"{tag}: K2 disagrees with its plain version")
    return attr_err, max(cov_frac, front_frac, depth_frac)


def k2_bound_ms(tables, r):
    """Least time for K2 on these tables: the plane evaluations they ask for
    (every pixel of a row against the 128 triangles of each chunk the row
    visits, 6 planes x 2 multiplies + 2 adds) at the f32 peak, or the table
    and output bytes at the memory rate, whichever is larger."""
    import torch

    lohi, spans, glob, geom, pay = tables
    B, nc = spans.shape[0], spans.shape[1]
    c = torch.arange(nc, device=geom.device)[None, None, :]
    y = torch.arange(r, device=geom.device)[None, :, None]
    band = (c >= lohi[..., 0:1]) & (c < lohi[..., 1:2])
    glb = (c >= glob[:, None, 0:1]) & (c < glob[:, None, 1:2])
    in_span = (spans[:, None, :, 0] <= y) & (spans[:, None, :, 1] >= y)
    visits = ((band | glb) & in_span).sum().item()
    flops = visits * 128 * r * 6 * 4
    out_bytes = B * r * r * (1 + pay.shape[1] // nc) * 4
    nbytes = sum(x.numel() * x.element_size() for x in tables) + out_bytes
    t_ops, t_bytes = flops / PEAK_F32, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase_raster():
    import torch

    from ivid_tpu_torch.ops import camera as cam
    from ivid_tpu_torch.ops import raster, raster_dense, renderer

    dev = torch.device("cuda")
    r, n = 384, 4
    meshes, target = live_slots(dev, n)
    g = int(round(meshes.positions.shape[1] ** 0.5))
    attrs = renderer._aggregation_attrs(meshes)
    mvp = (cam.perspective(45.0, 1.0, 0.01, 200.0, device=dev) @ target).expand(n, 4, 4)
    win, w = raster.project_vertices(meshes.positions, mvp, r)
    A = attrs.shape[-1]
    cols = raster_dense.grid_cols(win, w, attrs, meshes.positions, g, 3)
    tables = raster_dense.prep_pack(*cols, r, A)
    got = raster_dense.raster_rows(tables, r, A)
    want = raster_dense.raster_rows_reference(tables, r, A)
    torch.cuda.synchronize()
    log(f"[K2] {n} slots x {r}² ({g}² grid, {cols[0][0].shape[1]} tris/slot, "
        f"{tables[3].shape[1] // 8} chunks/slot)")
    attr_err, mismatch = compare_dense(got, want, "K2")
    ms, host = timed(lambda: raster_dense._launch(tables, r, A), match="dense_raster")
    finish_ms = cuda_time_ms(lambda: raster_dense.raster_rows(tables, r, A))
    plain_ms = cuda_time_ms(lambda: raster_dense.raster_rows_reference(tables, r, A), reps=3, warmup=1)
    prep_ms = cuda_time_ms(lambda: raster_dense.prep_pack(
        *raster_dense.grid_cols(win, w, attrs, meshes.positions, g, 3), r, A))
    bound, bound_by = k2_bound_ms(tables, r)
    log(f"[K2] {n} slots: kernel {ms:.4f} ms device ({ms / n:.4f} ms/slot; host {host:.4f} ms; "
        f"bound {bound:.4f} ms by {bound_by}), kernel+finish {finish_ms:.4f} ms, plain+finish {plain_ms:.4f} ms, "
        f"table prep (torch) {prep_ms:.4f} ms")
    return {
        "name": "dense_raster", "route": "cuda",
        "source": "ivid_tpu_torch/csrc/dense_raster.cu",
        "replaces": "ivid_tpu/ops/raster_dense.py:467",
        "max_abs_err": attr_err, "ms": ms, "host_ms": host, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": bound_by, "library_ms": None, "mismatch_frac": mismatch,
        "slots": n,
        "with_finish_ms": finish_ms, "prep_ms": prep_ms,
    }


def warp_render_inputs(dev, batch=8, s=128, seed=0):
    """The first render of a training step's warp: ``batch`` SyntheticRGBDWarp
    items of the cond config at s², each lifted with an s-pixel skirt and seen
    from a drawn orbit pose, as ``renderer.simple_fragments`` gives them at
    r = 3s."""
    import torch

    from ivid_tpu_torch.config import Config
    from ivid_tpu_torch.data import SyntheticRGBDWarp
    from ivid_tpu_torch.ops import geometry as geom
    from ivid_tpu_torch.ops import renderer
    from ivid_tpu_torch.ops import warp as warp_ops
    from ivid_tpu_torch.training import warp_cond

    args = dict(Config.load(COND_CFG).dataset["args"], image_size=s)
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


def phase_resolve():
    import torch

    from ivid_tpu_torch.ops import raster, raster_tiled

    dev = torch.device("cuda")
    f, r = warp_render_inputs(dev)
    frags, pay = [f["fragments"]], [f["payload"]]
    B = f["win"].shape[0]
    got = raster_tiled.resolve_zbuffer_tiled(frags, pay, r, B)
    want = raster.resolve_zbuffer_scatter(frags, pay, r, B)
    torch.cuda.synchronize()
    n_valid = int(f["fragments"].valid.sum())
    n_frag = f["fragments"].valid.numel()
    cov_bad = (got[2] != want[2]).sum().item()
    depth_bad = (got[1] != want[1]).sum().item()
    pay_err = (got[0] - want[0]).abs().max().item()
    log(f"[K3] {B} buffers x {r}²: {n_frag} fragments ({n_valid} valid), covered "
        f"{want[2].float().mean().item():.3f}; pixels differing: coverage {cov_bad}, depth "
        f"{depth_bad} (both must be 0); max|payload err| {pay_err:.3e} (<= {K3_PAY_MAX})")
    if cov_bad or depth_bad or not pay_err <= K3_PAY_MAX:
        raise RuntimeError("K3 disagrees with its plain version")
    prepared = raster_tiled.prepare(frags, pay, r, B)
    ms, host = timed(lambda: raster_tiled.launch(*prepared, r, B), match="zbuffer_resolve")
    prep_ms = cuda_time_ms(lambda: raster_tiled.prepare(frags, pay, r, B))
    plain_ms = cuda_time_ms(lambda: raster.resolve_zbuffer_scatter(frags, pay, r, B))
    npix, k = B * r * r, pay[0].shape[-1]
    nbytes = (npix + 1) * 4 + n_valid * (4 + 16) + npix * (4 * k + 4 + 1)
    bound = nbytes / PEAK_BYTES * 1e3
    log(f"[K3] kernel {ms:.4f} ms device, {host:.4f} host (bound {bound:.4f} ms by bytes: {nbytes / 1e6:.1f} MB), "
        f"sort/search prep (torch) {prep_ms:.4f} ms, plain version (two scatters) "
        f"{plain_ms:.4f} ms")
    return {
        "name": "zbuffer_resolve", "route": "cuda",
        "source": "ivid_tpu_torch/csrc/zbuffer_resolve.cu",
        "replaces": "ivid_tpu/ops/raster_tiled.py:52",
        "max_abs_err": pay_err, "ms": ms, "host_ms": host, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": "bytes", "library_ms": None, "prep_ms": prep_ms,
        "fragments": n_frag, "valid_fragments": n_valid, "buffers": B,
    }, f, r


def phase_skirt(f, r):
    """K2 on the warp render's skirt rings (indexed triangles), B=8 and B=1."""
    from ivid_tpu_torch.ops import raster_dense

    out = []
    for tag, sl in (("K2 skirt B=8", slice(None)), ("K2 skirt B=1", slice(0, 1))):
        win, w, attrs, ring = f["win"][sl], f["w"][sl], f["attrs"][sl], f["ring"][sl]
        A = attrs.shape[-1]
        tables = raster_dense.prep_pack(*raster_dense.tri_cols(win, w, attrs, ring, None), r, A)
        got = raster_dense.raster_rows(tables, r, A)
        want = raster_dense.raster_rows_reference(tables, r, A)
        log(f"[{tag}] {win.shape[0]} rings of {ring.shape[1]} triangles at {r}²")
        attr_err, mismatch = compare_dense(got, want, tag)
        ms, host = timed(lambda: raster_dense._launch(tables, r, A), match="dense_raster")
        plain_ms = cuda_time_ms(lambda: raster_dense.raster_rows_reference(tables, r, A),
                                reps=3, warmup=1)
        prep_ms = cuda_time_ms(lambda: raster_dense.prep_pack(
            *raster_dense.tri_cols(win, w, attrs, ring, None), r, A))
        bound, bound_by = k2_bound_ms(tables, r)
        log(f"[{tag}] kernel {ms:.4f} ms device, {host:.4f} host (bound {bound:.4f} ms by {bound_by}), plain+finish "
            f"{plain_ms:.4f} ms, table prep (torch) {prep_ms:.4f} ms")
        b1 = win.shape[0] == 1
        out.append({
            "name": "dense_raster_b1" if b1 else "dense_raster_skirt", "route": "cuda",
            "source": "ivid_tpu_torch/csrc/dense_raster.cu",
            "replaces": "ivid_tpu/ops/raster_dense.py:458" if b1
            else "ivid_tpu/ops/raster_dense.py:467",
            "max_abs_err": attr_err, "ms": ms, "host_ms": host, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
            "mismatch_frac": mismatch, "prep_ms": prep_ms, "buffers": win.shape[0],
        })
    return out


def compare_tiles(got, want, tag):
    """K5/K6 output [T, 5, 1024] against its plain version: the depth (row 0)
    and, for K6, the count (row 4) on every pixel; the sums within
    K56_SUM_MAX. Returns (pixels differing, largest sum error)."""
    exact = [0] if tag == "K5" else [0, 4]
    sums = [1, 2, 3, 4] if tag == "K5" else [1, 2, 3]
    bad = int((got[:, exact] != want[:, exact]).sum())
    err = (got[:, sums] - want[:, sums]).abs().max().item()
    return bad, err


def tile_bytes(bounds, lp):
    """The bytes K6 must move on these inputs: the bounds, lp, z and payload
    (20 bytes) of each fragment in the tiles' ranges that falls on a pixel
    (the others sort last in their tile and are cut off by a search), and
    the [T, 5, 1024] f32 output."""
    from ivid_tpu_torch.ops import resolve_variants as rv

    seg = lp[int(bounds[0]):int(bounds[-1])]
    falls = int(((seg >= 0) & (seg < rv.TILE)).sum())
    tiles = bounds.numel() - 1
    return bounds.numel() * 4 + falls * 20 + tiles * 5 * rv.TILE * 4


def phase_binned():
    """K5 against its plain version at ``bench_micro``'s shape (144 tiles of
    4,608 pre-binned fragments), then on inputs with local pixels outside
    the tile and negative depths."""
    import torch

    from ivid_tpu_torch import bench_micro
    from ivid_tpu_torch.ops import resolve_variants as rv

    gen = torch.Generator(device="cuda").manual_seed(11)
    tiles = bench_micro.R * bench_micro.R // rv.TILE
    f = bench_micro.N // tiles // 512 * 512
    lp, z, pay = bench_micro.binned_tiles(gen, tiles, f)
    bad, err = compare_tiles(rv.binned_resolve(lp, z, pay), rv.binned_resolve_reference(lp, z, pay),
                             "K5")
    lp2 = lp - 8 + (lp % 7 == 0).int() * 16  # some below 0 and some past 1023
    z2 = z - 0.5
    bad2, err2 = compare_tiles(rv.binned_resolve(lp2, z2, pay),
                               rv.binned_resolve_reference(lp2, z2, pay), "K5")
    torch.cuda.synchronize()
    log(f"[K5] {tiles} tiles x {f} pre-binned fragments: pixels whose depth differs {bad}, "
        f"max|sum err| {err:.3e}; with local pixels outside the tile and negative depths: "
        f"{bad2}, {err2:.3e} (0 and <= {K56_SUM_MAX})")
    if bad or bad2 or not max(err, err2) <= K56_SUM_MAX:
        raise RuntimeError("K5 disagrees with its plain version")
    ms, host = timed(lambda: rv.binned_resolve(lp, z, pay), match="binned_resolve")
    plain_ms = cuda_time_ms(lambda: rv.binned_resolve_reference(lp, z, pay))
    nbytes = lp.numel() * 4 + int(((lp >= 0) & (lp < rv.TILE)).sum()) * 20 + tiles * 5 * rv.TILE * 4
    bound = nbytes / PEAK_BYTES * 1e3
    log(f"[K5] kernel {ms:.4f} ms device, {host:.4f} host (bound {bound:.4f} ms by bytes: "
        f"{nbytes / 1e6:.1f} MB), plain version (scatters) {plain_ms:.4f} ms")
    return {
        "name": "binned_resolve", "route": "cuda",
        "source": "ivid_tpu_torch/csrc/binned_resolve.cu", "replaces": "bench_micro.py:131",
        "max_abs_err": max(err, err2), "ms": ms, "host_ms": host, "plain_ms": plain_ms,
        "bound_ms": bound, "bound_by": "bytes", "library_ms": None, "shape": [tiles, f],
    }


def phase_tile(f, r):
    """K6 against its plain version at ``bench_resolve``'s shape (733,184
    clustered fragments at 384²), then on the warp render's fragments
    (``warp_render_inputs``, first 3 payload channels): K6 + ``tile_finish``
    against K3 and the scatter, and the preparation and kernel of K6 and of
    K3 timed side by side, all in device ms."""
    import torch

    from ivid_tpu_torch import bench_resolve
    from ivid_tpu_torch.ops import raster, raster_tiled
    from ivid_tpu_torch.ops import resolve_variants as rv

    gen = torch.Generator(device="cuda").manual_seed(5)
    fb, pay = bench_resolve.make_batch(gen, bench_resolve.N, bench_resolve.R)
    npix = bench_resolve.R ** 2
    prepared = rv.prepare_tiles(fb.pixel, fb.depth, pay, fb.valid, npix)
    bad, err = compare_tiles(rv.tile_resolve(*prepared), rv.tile_resolve_reference(*prepared), "K6")
    torch.cuda.synchronize()
    log(f"[K6] {bench_resolve.N} clustered fragments at {bench_resolve.R}², "
        f"{npix // rv.TILE} tiles: values differing in depth or count {bad} (0), max|sum err| "
        f"{err:.3e} (<= {K56_SUM_MAX})")
    if bad or not err <= K56_SUM_MAX:
        raise RuntimeError("K6 disagrees with its plain version")
    ms, host = timed(lambda: rv.tile_resolve(*prepared), match="tile_resolve")
    plain_ms = cuda_time_ms(lambda: rv.tile_resolve_reference(*prepared))
    prep_ms, _ = timed(lambda: rv.prepare_tiles(fb.pixel, fb.depth, pay, fb.valid, npix))
    nbytes = tile_bytes(*prepared[:2])
    bound = nbytes / PEAK_BYTES * 1e3
    log(f"[K6] kernel {ms:.4f} ms device, {host:.4f} host (bound {bound:.4f} ms by bytes: "
        f"{nbytes / 1e6:.1f} MB), prep (sort, tile search) {prep_ms:.4f} ms device, plain "
        f"version (scatters) {plain_ms:.4f} ms")

    frags, pays = [f["fragments"]], [f["payload"]]
    pay3 = [f["payload"][..., :3]]
    B = f["win"].shape[0]
    wnpix = B * r * r

    def k6_prep():
        pix, d, valid, p = raster._concat(frags, pay3)
        return rv.prepare_tiles(pix, d, p, valid, wnpix)

    w_in = k6_prep()
    w_out = rv.tile_resolve(*w_in)
    w_bad, w_err = compare_tiles(w_out, rv.tile_resolve_reference(*w_in), "K6")
    if w_bad or not w_err <= K56_SUM_MAX:
        raise RuntimeError(f"K6 disagrees with its plain version on the warp render: {w_bad} "
                           f"depth/count values differ, max|sum err| {w_err:.3e}")
    # K6 + tile_finish against K3 and the scatter (raises past bench_resolve.PAY_TOL).
    got = rv.tile_finish(w_out, r, B)
    errs = {}
    for tag, want in (("K3", raster_tiled.resolve_zbuffer_tiled(frags, pays, r, B)),
                      ("scatter", raster.resolve_zbuffer_scatter(frags, pays, r, B))):
        errs[tag] = bench_resolve.compare(got, (want[0][..., :3], want[1], want[2]), f"K6 vs {tag}")
    log(f"[K6] warp render {B} x {r}², {wnpix // rv.TILE} tiles: against its plain version "
        f"depth and count equal, max|sum err| {w_err:.3e}; K6 + tile_finish against K3 and the "
        f"scatter: coverage and depth equal on every pixel, max|payload err| {errs['K3']:.3e} "
        f"and {errs['scatter']:.3e} (<= {bench_resolve.PAY_TOL})")
    k3_in = raster_tiled.prepare(frags, pays, r, B)
    pix, _, valid, pay4 = raster._concat(frags, pays)
    keys = torch.where(valid, pix, torch.full_like(pix, wnpix))
    keys_s, order = torch.sort(keys, stable=True)
    edges = torch.arange(wnpix + 1, device=keys.device)
    w = {
        "K6 prep": timed(k6_prep)[0],
        "K6 kernel": timed(lambda: rv.tile_resolve(*w_in), match="tile_resolve")[0],
        "K3 prep": timed(lambda: raster_tiled.prepare(frags, pays, r, B))[0],
        "K3 kernel": timed(lambda: raster_tiled.launch(*k3_in, r, B), match="zbuffer_resolve")[0],
        "K3 run search": timed(lambda: torch.searchsorted(keys_s, edges))[0],
        "sort": timed(lambda: torch.sort(keys, stable=True))[0],
        "K3 payload gather": timed(lambda: pay4[order])[0],
    }
    w_bytes = tile_bytes(*w_in[:2])
    log(f"[K6] warp render, device ms: K6 prep (sort, tile search) {w['K6 prep']:.4f}, K6 kernel "
        f"{w['K6 kernel']:.4f} (bound {w_bytes / PEAK_BYTES * 1e3:.4f} ms by bytes: "
        f"{w_bytes / 1e6:.1f} MB); K3 prep (sort, run search) {w['K3 prep']:.4f}, K3 kernel "
        f"{w['K3 kernel']:.4f}; of the preps, the stable sort of the keys alone "
        f"{w['sort']:.4f}, K3's run search alone ({wnpix + 1} edges) {w['K3 run search']:.4f}, "
        f"K3's gather of the [N, 4] payload rows alone {w['K3 payload gather']:.4f}")
    return {
        "name": "tile_resolve", "route": "cuda", "source": "ivid_tpu_torch/csrc/tile_resolve.cu",
        "replaces": "bench_resolve.py:136", "max_abs_err": max(err, w_err), "ms": ms,
        "host_ms": host, "plain_ms": plain_ms, "bound_ms": bound, "bound_by": "bytes",
        "library_ms": None, "prep_ms": prep_ms, "fragments": bench_resolve.N,
        "warp": {"buffers": B, "fragments": int(w_in[1].numel()),
                 "valid_fragments": int(f["fragments"].valid.sum()),
                 "bound_ms": w_bytes / PEAK_BYTES * 1e3,
                 "max_payload_err_vs_k3": errs["K3"], **{k.replace(" ", "_") + "_ms": v
                                                            for k, v in w.items()}},
    }


def phase_benches():
    """``bench_resolve.main`` and ``bench_micro.main`` at their defaults, with
    the launch counters read around them."""
    from ivid_tpu_torch import bench_micro, bench_resolve

    reset_counts()
    t0 = time.perf_counter()
    bench_resolve.main([])
    bench_micro.main([])
    counts = read_counts()
    log(f"[benches] bench_resolve.main and bench_micro.main in {time.perf_counter() - t0:.2f} s: "
        f"launches {counts} (K5 >= 1, K6 >= 1)")
    if not (counts["K5"] >= 1 and counts["K6"] >= 1):
        raise RuntimeError("the benches did not launch K5 and K6")
    return counts


def phase_attention_backward(b=8, t=1024, heads=4, seed=3, time_f32=True):
    """K4 at [b, t, 3·heads·64] against autograd of the plain version and
    against the plain formula form (``attention_backward_reference``) on the
    forward's own outputs, bf16 and f32; timed beside the plain backward and
    SDPA's backward."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ivid_tpu_torch.ops import attention

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    d = 64
    c = heads * d
    scale = float(d ** -0.25)
    rng = np.random.default_rng(seed)
    qkv32 = torch.from_numpy(rng.standard_normal((b, t, 3 * c)).astype(np.float32)).to(dev)
    dout32 = torch.from_numpy(rng.standard_normal((b, t, c)).astype(np.float32)).to(dev)
    tag = f"[K4] [{b},{t},{3 * c}] {heads} heads"
    res = {}
    for dtype in (torch.bfloat16, torch.float32):
        qkv = qkv32.to(dtype).requires_grad_()
        dout = dout32.to(dtype)
        out = attention.packed_attention(qkv, heads, scale)
        (got,) = torch.autograd.grad(out, qkv, dout)
        ref_in = qkv.detach().float().requires_grad_()
        ref_out = attention.reference_attention(ref_in, heads, scale)
        (want,) = torch.autograd.grad(ref_out, ref_in, dout.float())
        err = (got.float() - want).abs()
        r = {"max": err.max().item(), "rel": ((got.float() - want).norm() / want.norm()).item()}
        del ref_in, ref_out, want, err
        # The formula form on the same forward outputs the kernel read.
        o, lse = attention._launch(qkv.detach(), heads, scale, with_lse=True)
        k4 = attention._launch_bwd(qkv.detach(), o, dout, lse, heads, scale)
        form = attention.attention_backward_reference(qkv.detach().float(), o.float(),
                                                      dout.float(), lse, heads, scale)
        ferr = (k4.float() - form).abs()
        r.update(form_max=ferr.max().item(),
                 form_rel=((k4.float() - form).norm() / form.norm()).item())
        del form, ferr, k4
        if dtype == torch.bfloat16 or time_f32:
            # Timing: K4 alone on the forward's saved outputs; the plain
            # version's and SDPA's backward alone, each on a graph built once.
            r["ms"], r["host"] = timed(
                lambda: attention._launch_bwd(qkv.detach(), o, dout, lse, heads, scale))
            plain_in = qkv.detach().requires_grad_()
            plain_out = attention.reference_attention(plain_in, heads, scale)
            r["plain"] = cuda_time_ms(lambda: torch.autograd.grad(plain_out, plain_in, dout,
                                                                  retain_graph=True))
            del plain_out
            q, k, v = qkv.detach().reshape(b, t, heads, 3 * d).split(d, dim=-1)
            q, k, v = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
            sdpa_out = F.scaled_dot_product_attention(q, k, v)
            g4 = dout.reshape(b, t, heads, d).transpose(1, 2).contiguous()
            r["sdpa"], r["sdpa_host"] = timed(
                lambda: torch.autograd.grad(sdpa_out, (q, k, v), g4, retain_graph=True))
            del sdpa_out
        r["bound"], r["bound_by"] = attention_bound_ms(b, t, heads, dtype, backward=True)
        res[dtype] = r
    r16, r32 = res[torch.bfloat16], res[torch.float32]
    log(f"{tag}: bf16 rel L2 {r16['rel']:.3e} (<= {K4_BF16_REL}), max|err| {r16['max']:.3e}; "
        f"f32 max|err| {r32['max']:.3e} (<= {K4_F32_MAX}), rel L2 {r32['rel']:.3e}; against "
        f"the formula form: bf16 rel L2 {r16['form_rel']:.3e} (<= {K4_BF16_REL}), f32 "
        f"max|err| {r32['form_max']:.3e} (<= {K4_F32_MAX})")
    f32 = ""
    if time_f32:
        f32 = (f"; f32: kernel {r32['ms']:.4f} ms device, {r32['host']:.4f} host (bound "
               f"{r32['bound']:.4f} ms), plain backward {r32['plain']:.4f} ms, SDPA backward "
               f"{r32['sdpa']:.4f} device")
    log(f"{tag} bf16: kernel {r16['ms']:.4f} ms device, {r16['host']:.4f} host (bound "
        f"{r16['bound']:.4f} ms by {r16['bound_by']}), plain backward {r16['plain']:.4f} ms, "
        f"SDPA backward (unpacked, timing only) {r16['sdpa']:.4f} device, "
        f"{r16['sdpa_host']:.4f} host{f32}")
    if not (r16["rel"] <= K4_BF16_REL and r32["max"] <= K4_F32_MAX
            and r16["form_rel"] <= K4_BF16_REL and r32["form_max"] <= K4_F32_MAX):
        raise RuntimeError("K4 disagrees with its plain version")
    entry = {
        "name": "packed_attention_bwd", "route": "cuda",
        "source": "ivid_tpu_torch/csrc/packed_attention_bwd.cu",
        "replaces": "ivid_tpu/ops/attention.py:312",
        "max_abs_err": r16["max"], "ms": r16["ms"], "host_ms": r16["host"],
        "plain_ms": r16["plain"], "bound_ms": r16["bound"], "bound_by": r16["bound_by"],
        "library_ms": r16["sdpa"], "library_host_ms": r16["sdpa_host"], "shape": [b, t, 3 * c],
        "heads": heads, "rel_l2": r16["rel"], "formula_rel_l2": r16["form_rel"],
        "f32_max_abs_err": r32["max"], "f32_formula_max_abs_err": r32["form_max"],
        "f32_bound_ms": r32["bound"],
    }
    if time_f32:
        entry.update(f32_ms=r32["ms"], f32_host_ms=r32["host"], f32_plain_ms=r32["plain"],
                     f32_library_ms=r32["sdpa"])
    return entry


def phase_unet():
    import numpy as np
    import torch

    from ivid_tpu_torch.config import Config, build_backbone
    from ivid_tpu_torch.models.adm import randomize_parameters
    from ivid_tpu_torch.ops import attention

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.load(UNCOND_CFG)
    cpu_model = build_backbone(cfg, dtype=torch.float32)
    randomize_parameters(cpu_model, seed=0)
    gpu_model = build_backbone(cfg, dtype=torch.float32)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.to("cuda")
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 128, 128, 4)).astype(np.float32))
    t = torch.tensor([999, 10])
    before = attention.launches
    with torch.no_grad():
        want = cpu_model(x, t)
        got = gpu_model(x.cuda(), t.cuda()).cpu()
    sites = attention.launches - before
    rel = ((got - want).norm() / want.norm()).item()
    log(f"[unet] full-width single-category model, batch 2, f32: card (K1 at {sites} "
        f"attention sites) vs CPU plain path: rel L2 {rel:.3e} (<= {UNET_REL}), "
        f"output std {want.std().item():.3f}, finite {bool(torch.isfinite(got).all())}")
    if not (rel <= UNET_REL and torch.isfinite(got).all() and sites == 5):
        raise RuntimeError("UNet on the card disagrees with the CPU plain path")
    torch.backends.cudnn.allow_tf32 = True


class HostNoise:
    """Noise source drawing on the CPU from one seeded generator and moving
    the draws to ``device``, so a chain on the card and one on the CPU see
    the same noise."""

    def __init__(self, seed, device):
        import torch

        self.gen = torch.Generator().manual_seed(seed)
        self.device = device

    def split(self, num=2):
        return (self,) * num

    def fold_in(self, i):
        return self

    def normal(self, shape):
        import torch

        return torch.randn(tuple(shape), generator=self.gen).to(self.device)

    def uniform(self, shape):
        import torch

        return torch.rand(tuple(shape), generator=self.gen).to(self.device)

    def randint(self, shape, low, high):
        import torch

        return torch.randint(low, high, tuple(shape), generator=self.gen).to(self.device)


def reset_counts():
    from ivid_tpu_torch.ops import attention, raster_dense, raster_tiled, resolve_variants

    attention.launches = attention.bwd_launches = 0
    raster_dense.launches = raster_tiled.launches = 0
    resolve_variants.binned_launches = resolve_variants.tile_launches = 0


def read_counts():
    from ivid_tpu_torch.ops import attention, raster_dense, raster_tiled, resolve_variants

    return {"K1": attention.launches, "K2": raster_dense.launches,
            "K3": raster_tiled.launches, "K4": attention.bwd_launches,
            "K5": resolve_variants.binned_launches, "K6": resolve_variants.tile_launches}


def phase_chain(device="cuda"):
    """A small 3-view chain (32² f32 UNets, attention at T=1024 so K1 runs,
    r=96 aggregation through K2) on ``device`` against the same weights and
    noise on the CPU plain path."""
    import numpy as np
    import torch

    from ivid_tpu_torch.diffusion.frameworks import build_framework
    from ivid_tpu_torch.inference.pipeline import ScenePipeline
    from ivid_tpu_torch.inference.viewsets import build_viewset, canonical_view
    from ivid_tpu_torch.models import adm
    from ivid_tpu_torch.ops import attention, raster_dense

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    s = 32
    backbone = dict(
        image_size=s, in_channels=4, out_channels=4, model_channels=64, num_res_blocks=1,
        channel_mult=[1, 2], attention_resolutions=[32, 16], num_groups=32, num_heads=None,
        num_head_channels=64, num_classes=None, has_null_class=False, dropout=0.0,
        use_fp16=False,
    )
    fw_u = {"timesteps": 100, "beta_schedule": "linear"}
    fw_c = {**fw_u, "p_uncond": 0.1, "p_uncond_img": 0}
    uncond = adm.randomize_parameters(adm.build_adm_unet(backbone), seed=0)
    cond = adm.randomize_parameters(adm.build_adm_unet(dict(backbone, in_channels=10)), seed=1)
    with torch.no_grad():
        # A small eps keeps the first view a smooth surface (eps is amplified
        # ~150x on its way to x_0), so its mesh conditions the next views.
        uncond.out[2].weight.mul_(1e-5)
        uncond.out[2].bias.mul_(1e-5)
    grid = build_viewset("3x9", 1)
    views = np.stack([canonical_view(), grid[3], grid[6]])
    ii = np.linspace(0, 1, s)
    yy, xx = np.meshgrid(ii, ii, indexing="ij")
    rgb = np.stack([0.5 * np.sin(3 * xx + c) * np.cos(2 * yy) for c in range(3)], -1)
    depth = (0.45 + 0.05 * yy + 0.01 * np.sin(4 * xx))[..., None] * 2 - 1
    x0 = np.concatenate([rgb, depth], -1)[None].repeat(2, axis=0).astype(np.float32)

    def run(device):
        mu = adm.build_adm_unet(backbone)
        mu.load_state_dict(uncond.state_dict())
        mc = adm.build_adm_unet(dict(backbone, in_channels=10))
        mc.load_state_dict(cond.state_dict())
        fu = build_framework("GaussianDiffusion", mu.to(device).eval(), fw_u, device=device)
        fc = build_framework("InpaintCFG", mc.to(device).eval(), fw_c, device=device)
        pipe = ScenePipeline(fu, fc, image_size=s, steps_uncond=10, steps_cond=5,
                             device=device)
        noise = torch.from_numpy(x0) * fu.schedule.alphas_cumprod[-1].sqrt().cpu()
        _, samples, conds = pipe.sample_batch(HostNoise(5, device), views, batch=2,
                                              noise=noise)
        return samples.cpu().numpy(), (conds["depth"] > -1).cpu().numpy()

    before = attention.launches, raster_dense.launches
    got, got_mask = run(torch.device(device))
    k1, k2 = attention.launches - before[0], raster_dense.launches - before[1]
    want, want_mask = run(torch.device("cpu"))
    rel = max(float(np.linalg.norm(got[:, v] - want[:, v]) / np.linalg.norm(want[:, v]))
              for v in range(want.shape[1]))
    mask_frac = float((got_mask != want_mask).mean())
    log(f"[chain] 3 views, batch 2, 32² f32, r=96: card (K1 {k1}, K2 {k2} launches) vs CPU "
        f"plain path: worst view rel L2 {rel:.3e} (<= {CHAIN_REL}); condition mask "
        f"mismatch {mask_frac:.2e} (<= {CHAIN_MASK_FRAC}) of {want_mask.size} pixels "
        f"(covered {want_mask.mean():.3f}); finite {bool(np.isfinite(got).all())}")
    if not (rel <= CHAIN_REL and mask_frac <= CHAIN_MASK_FRAC and np.isfinite(got).all()
            and want_mask.mean() > 0.2 and k1 == 3 * (10 + 2 * 5) and k2 == 2):
        raise RuntimeError("the chain on the card disagrees with the CPU plain path")
    torch.backends.cudnn.allow_tf32 = True


def phase_pipeline():
    import numpy as np

    from ivid_tpu_torch import sample
    from ivid_tpu_torch.ops import attention, raster_dense

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_")
    argv = [
        "--config_uncond", UNCOND_CFG, "--config_cond", COND_CFG,
        "--ckpt_uncond", "random", "--ckpt_cond", "random",
        "--output_dir", out_dir, "--seeds", "0-1", "--viewset", "random",
        "--batchsize", "2", "--steps_uncond", "1000", "--steps_cond", "50",
        "--device", "cuda",
    ]
    reset_counts()
    t0 = time.perf_counter()
    result = sample.main(argv)
    wall = time.perf_counter() - t0
    counts = read_counts()
    k1, k2 = counts["K1"], counts["K2"]
    samples = np.concatenate(result["samples"], axis=0)
    scenes = sorted(os.listdir(os.path.join(result["output_dir"], "scenes")))
    images = sorted(os.listdir(os.path.join(result["output_dir"], "results")))
    st = result["stage_ms"]
    log(f"[pipeline] sample.main random viewset, batch 2, DDPM 1000 + DDIM 50: wall "
        f"{wall:.2f} s; stages (CUDA events) uncond {st['uncond']:.1f} ms, "
        f"aggregation {st['aggregation']:.1f} ms, cond {st['cond']:.1f} ms, "
        f"mesh {st['mesh']:.1f} ms")
    log(f"[pipeline] samples {samples.shape} finite {bool(np.isfinite(samples).all())} "
        f"std {samples.std():.3f}; files: {len(scenes)} scene npz, {len(images)} result png; "
        f"launches: K1 {k1} (>= {5 * 1050}), K2 {k2} (>= 1)")
    if not (np.isfinite(samples).all() and samples.shape == (2, 2, 128, 128, 4)
            and len(scenes) == 2 and len(images) == 2 and k1 >= 5 * 1050 and k2 >= 1
            and counts["K3"] == counts["K4"] == counts["K5"] == counts["K6"] == 0):
        raise RuntimeError("pipeline run failed its checks")
    return counts


def train_chain_run(device):
    """A few InpaintTrainer steps of a small f32 cond model (32², attention
    at T=1024 so K1 and K4 run, the warp at r=96 through K3 and K2) with
    seeded weights and host-drawn noise. Returns the losses and parameters."""
    import torch

    from ivid_tpu_torch.config import Config
    from ivid_tpu_torch.data import SyntheticRGBDWarp
    from ivid_tpu_torch.diffusion.frameworks import build_framework
    from ivid_tpu_torch.models import adm
    from ivid_tpu_torch.training.trainer import InpaintTrainer, StepRecord

    backbone = dict(
        image_size=32, in_channels=10, out_channels=4, model_channels=64, num_res_blocks=1,
        channel_mult=[1, 2], attention_resolutions=[32, 16], num_groups=32, num_heads=None,
        num_head_channels=64, num_classes=None, has_null_class=False, dropout=0.0,
        use_fp16=False,
    )
    fw = {"timesteps": 1000, "beta_schedule": "linear", "p_uncond": 0.1, "p_uncond_img": 0}
    data = dict(Config.load(COND_CFG).dataset["args"], image_size=32, length=16)
    model = adm.randomize_parameters(adm.build_adm_unet(backbone), seed=2)
    framework = build_framework("InpaintCFG", model, fw, device=device)
    tr = InpaintTrainer(
        framework, SyntheticRGBDWarp(**data), tempfile.mkdtemp(prefix="chip_smoke_chain_"),
        max_steps=3, batch_size=2, learning_rate=1e-4, weight_decay=0.0,
        ema_rate=[0.9999], i_log=3, i_sample=10 ** 9, i_save=10 ** 9,
        sample_at_init=False, device=device, noise=HostNoise(7, device),
    )
    tr.record = StepRecord()
    tr.run()
    losses = [float(x) for x in tr.record.losses]
    return losses, torch.cat([p.detach().cpu().reshape(-1) for p in tr.model.parameters()])


def phase_train_chain():
    import numpy as np
    import torch

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    before = read_counts()
    got_loss, got = train_chain_run(torch.device("cuda"))
    counts = {k: v - before[k] for k, v in read_counts().items()}
    want_loss, want = train_chain_run(torch.device("cpu"))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got_loss, want_loss))
    param_rel = ((got - want).norm() / want.norm()).item()
    log(f"[train-chain] InpaintTrainer, 32² f32, batch 2, 3 AdamW steps: card launches {counts}; "
        f"losses card {np.round(got_loss, 6).tolist()} vs CPU {np.round(want_loss, 6).tolist()}: "
        f"max rel {loss_rel:.3e} (<= {TRAIN_LOSS_REL}); final parameters rel L2 "
        f"{param_rel:.3e} (<= {TRAIN_PARAM_REL})")
    if not (loss_rel <= TRAIN_LOSS_REL and param_rel <= TRAIN_PARAM_REL
            and np.isfinite(got_loss).all()
            and counts == {"K1": 9, "K2": 3, "K3": 6, "K4": 9, "K5": 0, "K6": 0}):
        raise RuntimeError("the training chain on the card disagrees with the CPU plain path")
    torch.backends.cudnn.allow_tf32 = True


def phase_train():
    """Full-width cond-model training through the CLI's ``main``; returns
    its launch counts and the trainer."""
    import numpy as np
    import torch

    from ivid_tpu_torch import train
    from ivid_tpu_torch.training import checkpoint as ckpt_io
    from ivid_tpu_torch.training.trainer import StepRecord

    steps = 6
    with open(COND_CFG) as f:
        cfg = json.load(f)
    cfg["dataset"] = {"name": "SyntheticRGBDWarp",
                      "args": dict(cfg["dataset"]["args"], length=64)}
    cfg["trainer"]["args"].update(max_steps=steps, i_save=3, i_log=3, i_sample=10 ** 9,
                                  sample_at_init=False)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    path = os.path.join(tmp, os.path.basename(COND_CFG))
    with open(path, "w") as f:
        json.dump(cfg, f)
    argv = ["--config", path, "--output_dir", os.path.join(tmp, "out"), "--device", "cuda"]
    rec = StepRecord(timing=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    tr = train.main(argv, record=rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in rec.losses]
    times = rec.stage_ms()
    step_ms = [round(m["step"], 3) for m in times]
    warp_ms = [round(m["data_and_warp"], 3) for m in times]
    run_dir = os.path.join(tmp, "out", os.path.splitext(os.path.basename(COND_CFG))[0])
    step3 = ckpt_io.load(ckpt_io.model_path(run_dir, 3))
    now = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
    unchanged = [k for k, v in now.items() if torch.equal(step3[k], v)]
    changed = len(now) - len(unchanged)
    finite = all(torch.isfinite(v).all() for v in now.values())
    n_params = sum(p.numel() for p in tr.model.parameters())
    again = train.main(argv + ["--ckpt", "latest"])
    again_step = again.step
    reloaded = again_step == steps and all(
        torch.equal(v.cpu(), now[k]) for k, v in again.model.state_dict().items())
    del again
    per_step = {k: v / steps for k, v in counts.items()}
    log(f"[train] train.main, full-width cond model ({n_params} parameters), "
        f"SyntheticRGBDWarp 128², batch 8, {steps} AdamW steps: wall {wall:.2f} s; losses "
        f"{np.round(losses, 5).tolist()}; ms per step (CUDA events) {step_ms}, of which data "
        f"and warp conditioning {warp_ms}; peak memory {peak:.2f} GiB")
    log(f"[train] launches {counts}, per step {per_step} (K1 5, K4 5, K3 2, K2 >= 1); "
        f"{changed} of {len(now)} tensors changed since step 3 (not: {unchanged}); finite {finite}; "
        f"reloaded step {again_step} equal {reloaded}")
    if not (np.isfinite(losses).all() and len(losses) == steps and finite and changed > 0
            and reloaded and counts["K1"] == 5 * steps and counts["K4"] == 5 * steps
            and counts["K3"] == 2 * steps and counts["K2"] >= steps
            and counts["K5"] == counts["K6"] == 0):
        raise RuntimeError("training run failed its checks")
    return counts, tr


def phase_train_profile(tr, timed=10, profiled=2):
    """Where the trainer's own step (``run_step``, as ``run`` takes it) spends
    its time: ``timed`` steps by CUDA events per stage, then ``profiled``
    steps under torch.profiler for the device's kernel time, its idle share
    and the top kernels."""
    import torch

    from ivid_tpu_torch import timing
    from ivid_tpu_torch.training.trainer import StepRecord

    tr.record = StepRecord(timing=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(timed):
        tr.run_step()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / timed
    stages = tr.record.stage_ms()
    mean = {k: sum(m[k] for m in stages) / timed for k in stages[0]}
    tr.record = None
    log(f"[train-profile] trainer step, batch 8, mean of {timed} steps (CUDA events, ms): "
        + ", ".join(f"{k} {v:.2f}" for k, v in mean.items()) + f"; host wall {wall_ms:.2f}")
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    # torch.profiler has come back without any device activity on the H100
    # machine; the steps are profiled once more before the breakdown is
    # given up (the launch counts are checked either way).
    for _ in range(2):
        before = read_counts()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(profiled):
                tr.run_step()
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3 / profiled
        launches = {k: v - before[k] for k, v in read_counts().items()}
        if not (launches["K1"] == 5 * profiled and launches["K4"] == 5 * profiled):
            raise RuntimeError(f"the profiled training steps miss a kernel: {launches}")
        rows = timing.device_rows(prof, profiled)
        if rows:
            break
        log("[train-profile] torch.profiler recorded no device activity")
    else:
        log("[train-profile] device kernel time, idle share and top kernels: not measured")
        return
    kernel_ms = sum(r[0] for r in rows)
    n_kernels = sum(r[1] for r in rows)
    # Idle share against the profiled wall (the profiler slows the host) and
    # against the unprofiled step by CUDA events.
    log(f"[train-profile] {profiled} profiled steps: {n_kernels} kernels and {kernel_ms:.2f} ms "
        f"of device kernel time per step; idle share {1 - kernel_ms / prof_wall:.3f} of the "
        f"profiled wall ({prof_wall:.2f} ms), {1 - kernel_ms / mean['step']:.3f} of the "
        f"unprofiled step; port kernel launches {launches}")
    for ms, n, name in rows[:12]:
        log(f"[train-profile]   {ms:9.3f} ms  x{n:<5d} {name[:110]}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = phase_device()
    k1 = phase_attention(2, 0, training=False)
    k1_train = phase_attention(8, 3, training=True)
    # The SR cascade's shapes (T=4096; 6 heads), checked and timed in bf16.
    k1["other_shapes"] = [phase_attention(2, 5, False, t=4096, time_f32=False),
                          phase_attention(2, 6, False, heads=6, time_f32=False)]
    k2 = phase_raster()
    k3, warp_inputs, r = phase_resolve()
    skirt8, skirt1 = phase_skirt(warp_inputs, r)
    k6 = phase_tile(warp_inputs, r)
    del warp_inputs
    k5 = phase_binned()
    benches = phase_benches()
    k4 = phase_attention_backward()
    k4["other_shapes"] = [phase_attention_backward(2, 4096, 4, seed=7, time_f32=False),
                          phase_attention_backward(2, 1024, 6, seed=8, time_f32=False)]
    phase_unet()
    phase_chain()
    phase_train_chain()
    sampling = phase_pipeline()
    training, trainer = phase_train()
    phase_train_profile(trainer)
    del trainer
    # ``launches``: the count of the path each kernel entry's shape stands
    # for (K1 at batch 2 and K2 on grids: sampling; the other entries:
    # training; K2 at B=1 is on neither path: the trainer warps the whole
    # batch at once).
    for entry, key, path in ((k1, "K1", sampling), (k1_train, "K1", training),
                             (k2, "K2", sampling), (k3, "K3", training),
                             (skirt8, "K2", training), (k4, "K4", training)):
        entry["launches"] = path[key]
        entry["launches_by_path"] = {"sampling": sampling[key], "training": training[key]}
    skirt1["launches"] = 0
    # K5 and K6: the count of the bench runs, their only path.
    for entry, key in ((k5, "K5"), (k6, "K6")):
        entry["launches"] = benches[key]
        entry["launches_by_path"] = {"sampling": sampling[key], "training": training[key],
                                     "benches": benches[key]}
    from ivid_tpu_torch import timing

    log(f"[timing] device-time readings taken by queued CUDA events instead of "
        f"torch.profiler: {timing.fallbacks}")
    log(json.dumps({"kernels": [k1, k1_train, k2, skirt8, skirt1, k3, k4, k5, k6]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
