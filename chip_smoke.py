#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi), then both kernels
   built from ``ivid_tpu_torch/csrc`` with nvcc for sm_90a;
2. K1 (packed attention) against its plain version at the slice's shape
   [2, 1024, 768], 4 heads, in bf16 and f32, timed beside the plain version
   and torch's scaled_dot_product_attention on the unpacked layout;
3. K2 (dense grid raster) against its plain version on live aggregation
   slots: four 128² seeded RGBD meshes rendered at r=384 from an orbit view;
4. the full-width single-category UNet (random seeded weights, batch 2) on
   the card with K1 in f32 against the same weights on the CPU plain path;
5. a small 3-view chain (32² f32 UNets, both kernels on its path) on the card
   against the same weights and noise on the CPU plain path;
6. the sampling pipeline through its command-line entry point
   (``ivid_tpu_torch.sample.main``): random viewset, batch 2, 1000-step DDPM
   then 50-step guided DDIM, with both kernels' launch counters read around it.

Then one JSON line with every kernel's numbers, the nvidia-smi line, and the
last line ``{"ok": true, "device": {...}}``. Without a CUDA device it exits
non-zero and prints no result.
"""

import json
import os
import subprocess
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


def log(msg):
    print(msg, flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    from ivid_tpu_torch import cuda_build

    pkg = os.path.dirname(cuda_build.__file__)
    if os.path.dirname(pkg) != ROOT:
        raise RuntimeError(f"ivid_tpu_torch imported from {pkg}, not from this checkout")
    smi = nvidia_smi_line()
    log(f"[device] {smi}")
    t0 = time.perf_counter()
    for name in ("packed_attention", "dense_raster"):
        cuda_build.load(name)
    log(f"[device] built {sorted(cuda_build.build_seconds)} with nvcc for sm_90a in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in cuda_build.build_seconds.items())})")
    for name, text in cuda_build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[device] ptxas {name}: {line.strip()}")
    return smi


def phase_attention():
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ivid_tpu_torch.ops import attention

    dev = torch.device("cuda")
    b, t, heads, d = 2, 1024, 4, 64
    c = heads * d
    scale = float(d ** -0.25)
    qkv32 = torch.from_numpy(
        np.random.default_rng(0).standard_normal((b, t, 3 * c)).astype(np.float32)
    ).to(dev)
    qkv16 = qkv32.to(torch.bfloat16)

    got16 = attention.packed_attention(qkv16, heads, scale).float()
    want16 = attention.reference_attention(qkv16.float(), heads, scale)
    err16 = (got16 - want16).abs()
    got32 = attention.packed_attention(qkv32, heads, scale)
    want32 = attention.reference_attention(qkv32, heads, scale)
    err32 = (got32 - want32).abs()
    torch.cuda.synchronize()
    max16, mean16, max32 = err16.max().item(), err16.mean().item(), err32.max().item()
    log(f"[K1] bf16 max|err| {max16:.3e} (<= {K1_BF16_MAX}) mean {mean16:.3e} "
        f"(<= {K1_BF16_MEAN}); f32 max|err| {max32:.3e} (<= {K1_F32_MAX})")
    if not (max16 <= K1_BF16_MAX and mean16 <= K1_BF16_MEAN and max32 <= K1_F32_MAX):
        raise RuntimeError("K1 disagrees with its plain version")

    q, k, v = qkv16.reshape(b, t, heads, 3 * d).split(d, dim=-1)
    q, k, v = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    ms = cuda_time_ms(lambda: attention.packed_attention(qkv16, heads, scale))
    plain_ms = cuda_time_ms(lambda: attention.reference_attention(qkv16, heads, scale))
    sdpa_ms = cuda_time_ms(lambda: F.scaled_dot_product_attention(q, k, v))
    ms32 = cuda_time_ms(lambda: attention.packed_attention(qkv32, heads, scale))
    plain32_ms = cuda_time_ms(lambda: attention.reference_attention(qkv32, heads, scale))
    log(f"[K1] [2,1024,768] 4 heads bf16: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"SDPA (unpacked, timing only) {sdpa_ms:.4f} ms; f32: kernel {ms32:.4f} ms, "
        f"plain {plain32_ms:.4f} ms")
    return {
        "name": "packed_attention", "route": "cuda",
        "source": "ivid_tpu_torch/csrc/packed_attention.cu",
        "replaces": "ivid_tpu/ops/attention.py:167",
        "max_abs_err": max16, "ms": ms, "plain_ms": plain_ms,
        "f32_max_abs_err": max32, "f32_ms": ms32, "f32_plain_ms": plain32_ms,
        "sdpa_ms": sdpa_ms,
    }


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
    npix = got.covered.numel()
    cov_frac = (got.covered != want.covered).float().mean().item()
    front_frac = (got.front != want.front).float().mean().item()
    same_z = got.covered & want.covered & ((got.depth - want.depth).abs() <= 1e-6)
    depth_frac = 1.0 - (same_z | (~got.covered & ~want.covered)).float().mean().item()
    attr_err = (got.attrs - want.attrs).abs()[same_z].max().item()
    log(f"[K2] {n} slots x {r}² ({g}² grid, {cols[0][0].shape[1]} tris/slot, "
        f"{tables[3].shape[1] // 8} chunks/slot): covered {want.covered.float().mean().item():.3f}; "
        f"mismatched pixels: coverage {cov_frac:.2e}, front {front_frac:.2e}, depth {depth_frac:.2e} "
        f"(each <= {K2_PIXEL_FRAC}); max|attr err| where both agree on depth {attr_err:.3e} "
        f"(<= {K2_ATTR_MAX}) over {npix} pixels")
    if not (cov_frac <= K2_PIXEL_FRAC and front_frac <= K2_PIXEL_FRAC
            and depth_frac <= K2_PIXEL_FRAC and attr_err <= K2_ATTR_MAX):
        raise RuntimeError("K2 disagrees with its plain version")
    ms = cuda_time_ms(lambda: raster_dense.raster_rows(tables, r, A))
    plain_ms = cuda_time_ms(lambda: raster_dense.raster_rows_reference(tables, r, A), reps=3, warmup=1)
    prep_ms = cuda_time_ms(lambda: raster_dense.prep_pack(
        *raster_dense.grid_cols(win, w, attrs, meshes.positions, g, 3), r, A))
    log(f"[K2] {n} slots: kernel+finish {ms:.4f} ms ({ms / n:.4f} ms/slot), plain+finish "
        f"{plain_ms:.4f} ms, table prep (torch) {prep_ms:.4f} ms")
    return {
        "name": "dense_raster", "route": "cuda",
        "source": "ivid_tpu_torch/csrc/dense_raster.cu",
        "replaces": "ivid_tpu/ops/raster_dense.py:467",
        "max_abs_err": attr_err, "ms": ms, "plain_ms": plain_ms,
        "mismatch_frac": max(cov_frac, front_frac, depth_frac), "slots": n,
        "prep_ms": prep_ms,
    }


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

    def split(self):
        return self, self

    def fold_in(self, i):
        return self

    def normal(self, shape):
        import torch

        return torch.randn(tuple(shape), generator=self.gen).to(self.device)


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
    attention.launches = 0
    raster_dense.launches = 0
    t0 = time.perf_counter()
    result = sample.main(argv)
    wall = time.perf_counter() - t0
    k1, k2 = attention.launches, raster_dense.launches
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
            and len(scenes) == 2 and len(images) == 2 and k1 >= 5 * 1050 and k2 >= 1):
        raise RuntimeError("pipeline run failed its checks")
    return k1, k2


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    smi = phase_device()
    k1 = phase_attention()
    k2 = phase_raster()
    phase_unet()
    phase_chain()
    k1["launches"], k2["launches"] = phase_pipeline()
    log(json.dumps({"kernels": [k1, k2]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
