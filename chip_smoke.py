#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Phases, each printing its own lines; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi), then every
   source of ``ivid_tpu_torch/csrc`` (``cuda_build.SOURCES``) built with
   nvcc for sm_90a, one nvcc per source, all at once;
2. K1 (packed attention) against its plain version at [2, 1024, 768] (the
   sampling shape) and [8, 1024, 768] (the training forward's), 4 heads, in
   bf16 and f32, with the log-sum-exp it stores for training held to its
   plain version too, timed beside the plain version and torch's
   scaled_dot_product_attention on the unpacked layout (each also by the
   profiler's fallback, calls queued behind a spin kernel, as a
   cross-check of the two device-time readings); then the same checks
   at the SR cascade's sampling shapes [4, 4096, 768] (T=4096) and
   [4, 1024, 1152] (6 heads);
3. K2 (the binned dense raster: bins, then one block per 16x16 tile)
   against its plain version on live aggregation slots, 128² seeded RGBD
   meshes rendered at r=384 from an orbit view, at 4 slots and at 26 (the
   last view of a ``3x9`` scene): depth, coverage and front equal on every
   pixel, two launches bit-equal; timed with the glue between its kernels
   and the columns, the public call on the host, and bounded by the bytes
   it must move or the plane evaluations at the pixels each triangle
   covers;
4. K3 (z-buffer resolve) against its plain version on the first warp render
   of a training step: 8 SyntheticRGBDWarp 128² items at r=384;
5. K2 on indexed triangles (the same render's skirt rings) at B=8 and B=1,
   checked and timed as in 3;
   then K6 (the sort-then-tile resolve prototype) against its plain version
   at ``bench_resolve``'s shape, on the same render and on the bench shape
   with 64 stacked pixels (two launches bit-equal on each), timed warm and
   with the L2 cache cleared; with ``tile_finish`` against K3 and the
   scatter on the render, its preparation and kernel timed beside K3's;
   K5 (the pre-binned resolve prototype) against its plain version at
   ``bench_micro``'s shape; then ``ivid_tpu_torch.bench_resolve.main`` and
   ``ivid_tpu_torch.bench_micro.main`` at their defaults;
6. K4 (packed attention backward) against autograd of the plain version
   and against its plain formula form at the training shape [8, 1024, 768],
   4 heads, and at the SR trainer's shapes [2, 4096, 768] and
   [2, 1024, 1152], bf16 and f32;
6b. K1 f32 and K4 f32 (split-TF32 tensor-core products) at every shape the
   paths give them: the sampling, training and SR shapes, the flagship
   1000-class model's [20, 1024, 1536] and [16, 1024, 1536] (8 heads), a
   ragged T=1000 and inputs scaled x8 (against the plain version in f64);
   two launches bit-equal; timed at the flagship shapes beside the plain
   version and SDPA in f32 (with SDPA's own error);
6c. ``[group norm]``: the fused GroupNorm + scale-shift + SiLU kernel against
   the same function in f32 at the SR concatenation [54, 256, 256, 256] bf16,
   an SR output norm [54, 128, 256, 256] bf16 with its input bias, the
   flagship's [16, 256, 128, 128] f32 and ``b1``'s [1, 512, 8, 8] bf16,
   each also offset by 1e3; timed beside its bytes bound, the composition and
   ``F.group_norm`` + SiLU; then the SR UNet's graphed forward (87 launches,
   35 with an input bias, and 35 residual launches, eager and replayed)
   against the eager composition and the f32 forward;
6d. ``[residual]``: the residual sum with the convolutions' biases against
   its plain version, bit for bit, at the benchmarked models' residual
   shapes with an identity and a 1x1 skip; timed at the SR, flagship and
   ``b1`` shapes beside its bytes bound and the parent's composition;
7. the full-width single-category UNet (random seeded weights, batch 2) on
   the card with K1 in f32 against the same weights on the CPU plain path;
   then the flagship 1000-class f32 UNet the same way (batch 2 with
   classes, K1 f32 at its five sites); then the full-width SR UNet
   (``rgbd_imagenet_adm_256_128_small_sr.json``, 256², batch 1 with a
   class) in f32 and with its bf16 torso, its K1 sites counted from the
   model; then ``[unet graph]``: the inference forward replayed as a CUDA
   graph against the eager forward on the four benchmark models (the
   single-category pair at batch 1, the flagship pair 16 wide), bit for
   bit with the same K1 launches, host ms per forward each way, a 3-step
   DDIM chain each way, reloads and the calls that stay eager; then ``[SR
   27]``: K1 bf16 at the SR chunk's guided shape [54, 4096, 768] against its
   plain version, and one 27-view chunk of ``sr.main`` (a forward of 54 at
   256²) replayed as a CUDA graph against the eager forward;
8. a small 3-view sampling chain (32² f32 UNets, K1 and K2 on its path) on
   the card against the same weights and noise on the CPU plain path; and a
   small SR chain (16² -> 32² SuperResCFG, 5 guided DDIM steps) the same
   way;
9. a small training chain (32² f32 cond UNet, InpaintTrainer, batch 2, 3
   AdamW steps, K1/K4/K3/K2 on its path) on the card against the CPU plain
   path with the same weights and draws;
10. the sampling pipeline through ``ivid_tpu_torch.sample.main``: random
    viewset, batch 2, 1000-step DDPM then 50-step guided DDIM, with the
    host's wait for K2's bins (one per raster call);
10b. ``[ckpt migrate]``: the full-width single-category pair (seeded
    weights) written as the JAX package's flax msgpack files and read back
    bit for bit (write and read MB/s); ``sample.main`` on them (random
    viewset, batch 2, DDIM 50 + guided DDIM 10), its first UNet forward held
    to the same forward on a ``.pt`` file of the same weights; then a
    JAX-layout run directory of the cond model at step 3 (model, EMA, misc
    with optax's AdamW moments) resumed by ``train.main --ckpt latest``
    (state bit-equal to the files), and 3 steps of it under
    ``--profile_dir`` (the trace parsed, ``model_summary.txt``'s total
    checked);
11. training through ``ivid_tpu_torch.train.main``: the full-width
    single-category cond model on SyntheticRGBDWarp 128², batch 8, 6 AdamW
    steps with a checkpoint at step 3 and a reload;
12. the same trainer's step (``run_step``) timed by stage with CUDA events
    over 10 more steps, then 2 steps under torch.profiler: kernels, device
    kernel time and idle share per step, and the top kernels;
12b. ``[data files]``: a seeded folder of 64 RGB PNGs of 375x500 with npz
    disparities read by ``SingleCategoryWarp`` at 128² and
    ``SingleCategorySR`` 256/128 (the native resampler built with g++):
    items/s in the main process and with 4 thread and 4 process workers,
    each loader's batch 0 held to the items loaded one by one;
12c. ``[train files]``: ``train.main --distributed`` at world size 1
    (NCCL; the torchrun variables set here) on the full-width cond config
    over that folder, batch 8, 4 process workers: 4 steps with a save at
    the last, a resume for 2 more (the loader's cursor restored), then 2
    steps with ``warp_host`` (the warp in the workers, on the CPU); step ms,
    the loader's wait per step and K1, K4, K2 and K3 launches per step;
13. the flagship pair through ``sample.main`` (random viewset, batch 2, the
    uncond sampler cut to 50 strided DDIM steps, cond DDIM 50), with the
    launch counts and the stage ms; then the SR cascade over its two scenes
    through ``ivid_tpu_torch.sr.main`` (the full-width SR model, 50 guided
    DDIM steps, ``--save_scenes``; the scenes it writes reloaded);
14. the flagship uncond config through ``train.main`` (BasicTrainer, CFG,
    f32, batch 16, SyntheticRGBD with 1000 classes, 3 AdamW steps), with
    the peak memory; then the SR config the same way (SuperResTrainer,
    batch 4 in 2 micro-batches, SyntheticRGBDSR 256/128, finetuned from a
    4-input checkpoint written by the phase);
15. the model-level A/B (``ivid_tpu_torch.bench_unet``): the flagship
    uncond step at batch 10 and its training step at 16, with the attention
    sites on K1/K4 f32, the plain version and SDPA, in turns;
16. ``[tp train]``: ``train.main`` on two ranks of ``torch.distributed.run``
    sharing the card over gloo (``--device cuda:0 --distributed
    --model_parallel 2``) with the flagship cond config (InpaintTrainer,
    bf16 torso, SyntheticRGBDWarp 128² with 1000 classes), global batch 8,
    3 AdamW steps, the replication check after every step; then the same
    run at world size 1 on the card. The losses and the step-3 parameters
    and EMA are held to each other, the ranks' shards must differ; per rank
    the K1/K4 launches, the qkv widths K1 read (768 on a TP rank, 1536 at
    world size 1), step ms and peak memory;
17. ``[dp sample]``: ``sample.main --data_parallel`` on two such ranks, the
    flagship pair (seeded weights), random viewset (seeded orbit), seeds
    0-3 at batch 4, DDIM 50 + guided DDIM 10; then world size 1. Each
    scene's views and condition masks are held to each other; per rank the
    K1/K2 launches and the wall time;
18. ``[graft]``: ``graft_entry.entry()``'s flagship forward once on the
    card, then ``graft_entry.dryrun_multichip(2, "cuda:0")`` (one training
    step of a small UNet on a data 1 x model 2 mesh of two gloo ranks).

The ranks of 16 and 17 run this script as ``chip_smoke.py --rank-worker
KIND OUT -- ARGV``: ``train.main`` or ``sample.main`` with the launch
counter read around it, each rank's counts and times written to
``OUT/rank{R}.json``. Two ranks on one card over gloo carry every
activation reduction through the host: their times say that the paths run,
not how they scale.

After 3, K2 at the free-view render's shapes (``[K2 640]``: 27 slots of
128² views at 640², a ``3x9`` scene at SSAA 5; ``[K2 1280]``: 2 slots of
256² views at 1280², an SR scene), checked and timed as in 3. After the SR
run of 13, ``[render]``: ``ivid_tpu_torch.render.main`` at SSAA 5 over a
seeded 27-view 128² scene (a 60-frame swing and one random pose), the
flagship pipeline's scenes (8 frames) and the SR run's 256² scenes (4
frames), with ms per frame by stage, frames/s and one K2 launch (with its
bins) per frame; one frame of a 27-view 32² scene held to the CPU's.
Then ``[eval]``: ``ivid_tpu_torch.eval.main`` on 64 fake (rendered frames
and seeded images) and 64 real seeded 128² PNGs with ``randconv`` and with
``inception:`` a seeded state dict, on the card and on the CPU (the metrics
must agree), and each extractor's images/s on the card.

Each main path (the benches of 5, and 10, 10b, 11, 12c, 13, 14, 15, 16, 17, 18,
the SR runs of 13 and 14, the render runs) runs with every launch
counter set to 0 just before it and read just after. Then one JSON line
with every kernel's numbers, the nvidia-smi line, and the last line
``{"ok": true, "device": {...}}``.
Without a CUDA device it exits non-zero and prints no result. Every phase
logs its wall seconds and the script's running total (``[time]`` lines).

Times (``ivid_tpu_torch.timing``): a kernel's ``ms`` and the library call's
``library_ms`` are device time, the durations torch.profiler records for
what 20 warmed-up calls ran on the device, per call, or, when two profiler
sessions record none of it, CUDA events around 20 calls queued behind a spin
kernel (a ``[timing]`` line says so, and the count of such readings is
printed before the kernels line); ``host_ms`` is CUDA events around 20 such
calls, which measure the host's issue time whenever that is longer.
``plain_ms`` and the prep times are CUDA events.
"""

import contextlib
import json
import math
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()

UNCOND_CFG = os.path.join(ROOT, "configs", "rgbd_singlecategory_adm_128_small.json")
COND_CFG = os.path.join(ROOT, "configs", "rgbd_singlecategory_adm_128_small_cond.json")
FLAGSHIP_UNCOND = os.path.join(ROOT, "configs", "rgbd_imagenet_adm_128_large_cfg.json")
FLAGSHIP_COND = os.path.join(ROOT, "configs", "rgbd_imagenet_adm_128_large_cond.json")
SR_CFG = os.path.join(ROOT, "configs", "rgbd_imagenet_adm_256_128_small_sr.json")
SC_SR_CFG = os.path.join(ROOT, "configs", "rgbd_singlecategory_adm_256_128_small_sr.json")

# Tolerances (and why):
# K1 bf16 vs the plain version in f32 on the same bf16 inputs: the kernel
# computes in f32 and rounds the output to bf16 (2^-9 relative on |o| <= ~3).
K1_BF16_MAX, K1_BF16_MEAN = 2e-2, 2e-3
# K1 f32 vs plain f32 (TF32 off): only the summation order differs.
K1_F32_MAX = 1e-4
# K2 vs plain: both evaluate the planes with the same f32 roundings, so depth,
# coverage and front are equal on every pixel; the attrs differ only by the
# tie sums' order (ivid_tpu_torch.bench_raster.ATTR_MAX, 1e-3).
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
# K1 f32 / K4 f32 on inputs scaled x8 (logits up to ~200): the plain version
# in f32 is itself ~1e-3 from exact on outputs up to ~40, so the kernels are
# held to the plain version in f64, within this share of the largest output.
F32_X8_REL = 1e-4
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
# differ by f32 sum order (K5 and the plain versions add with atomics, in an
# order that varies). K6's stacked input sums ~500 ties to ~256 on a pixel,
# where f32 steps by 3.05e-5: there the bound is this share of the sum.
K56_SUM_MAX = 1e-5
# Training chain on the card vs the CPU plain path (f32, TF32 off, the same
# draws): the losses differ by f32 sum order and by warp-mask pixels on knife
# edges; AdamW steps of ~1e-4 per element may flip sign where a gradient is
# ~0, which moves the parameters by < 1e-5 relative L2.
TRAIN_LOSS_REL, TRAIN_PARAM_REL = 1e-3, 1e-5
# The SR UNet with its bf16 torso on the card vs the f32 CPU plain path: the
# torso's bf16 rounding (``[SR unet]`` prints the same gap on the CPU, bf16
# torso against f32: 1.3e-2 relative L2 at full width), with room for
# cuDNN's other sum order.
SR_BF16_REL = 5e-2

# The GroupNorm kernel against GroupNorm, scale-shift and SiLU computed in f32
# from the same input (torch's f32 statistics): the output's one rounding
# (2^-8 relative to bf16, f32's own to f32), with room for the two ways of
# summing the statistics; an input offset by 1e3 (std 1) loses up to ~1e-4 of
# its mean in either sum (f32's ulp at 1e3 is 6e-5), and f32's
# E[x²] - E[x]² would be off by ~6e-2 there.
GN_REL = {"bfloat16": 2.0 ** -8, "float32": 1e-5}
GN_ABS = {0.0: 1e-5, 1e3: 2e-3}
# The graphed SR forward (the kernel at its 87 sites) against the eager
# composition at batch 2 in the bf16 torso: both round the torso to bf16, so
# their gap is SR_BF16_REL's; and the kernel, rounding once a site, lies no
# further from the f32 forward than the composition does (with room for the
# convolutions' own bf16 noise, which both share).
GN_SR_GAP_RATIO = 1.25
# The UNet's GroupNorm sites a forward, in every configuration here: the kernel
# launches this many times a forward on each sampling path, and never in
# training (autograd records there).
GN_SITES = 87
# The UNet's residual blocks a forward, in every configuration here: in
# inference on the card each leaves its convolutions' biases to the kernels,
# so each sampling forward makes this many residual launches (``RES``) and
# this many of its GroupNorm launches carry an input bias (``GN bias``); none
# in training.
RES_SITES = 35

# The first UNet forward of a sampling run on weights read from a .msgpack file
# vs the same forward on the .pt file of the same weights: the same bits in,
# the same kernels; room for cuDNN picking another algorithm between calls.
CKPT_FORWARD_REL = 1e-6

# A rendered frame on the card vs the CPU (the same scene, K2 vs its plain
# version, f32 renders, 8-bit Lanczos resize): pixels whose color or depth
# image differs by more than one 8-bit level, at most this share (a pixel
# centre on a view's triangle edge may fall to the other side).
RENDER_LEVELS, RENDER_OFF_SHARE = 1, 0.01
# Eval metrics on the card vs the CPU (f32 features, TF32 off; cuDNN's and
# the CPU's convolutions sum in other orders): FID and KID relative (KID to
# its mean: its spread over subsets that are the whole set is ~0); IS is
# computed from f32 logits in f32, absolutely.
EVAL_REL, EVAL_IS_ABS = 1e-3, 1e-4

# [tp train]: two TP ranks vs world size 1, bf16 torso, both from the same
# seeded random weights (adm.randomize_parameters through the trainer's
# finetune_ckpt: every layer reaches the output, so the losses and every
# layer's gradient see a layout fault from the first step). The runs differ
# only where a row-parallel layer's two bf16 partial sums are rounded and
# then summed (one rounding at world size 1), and where cuDNN picks other
# algorithms for the halved channel counts: ~2^-8 relative on those
# activations, compounded over the torso's ~60 layers forward and back.
# The loss, a mean over 8·128²·4 squared errors, moves by far less
# (TP_LOSS_REL; measured on the H100: 6.1e-5 at most). AdamW's first step
# is lr·sign(g), its next ones depend on the ratios of the steps'
# gradients, so the update carries the gradients' relative rounding
# (measured: 2.9e-2 of the 3 steps' update in L2, 1.3e-3 of the elements
# apart by more than lr/2, the worst tensor of >= TP_TENSOR_MIN elements
# 5.1e-2, the replicated class embedding, whose update is 8 rows). The
# bounds sit 3-4x above those readings; a layout fault gives a wrong
# gradient to the tensors it touches and moves each of them by O(1) of its
# update (TP_TENSOR_REL), and a fault that moves the output by a few
# percent moves the loss past TP_LOSS_REL. The EMA (rate r = 0.9999, from
# the same start) takes (1 - r) of each step's parameters, which differ by
# at most the final |Δp| plus the later steps' differences (a bias-corrected
# AdamW step of steps 1-3 is within 1.004·lr, so two runs' steps differ by
# at most ~2·lr): per element (1 - r)·(3·|Δp| + 7·lr), plus its own f32
# rounding, two roundings a step, each at most one ulp apart between the
# runs (TP_EMA_ULPS = 6 over 3 steps).
TP_LOSS_REL, TP_UPDATE_REL, TP_TENSOR_REL, TP_TENSOR_MIN = 1e-3, 1e-1, 2e-1, 4096
TP_FLIP_SHARE, TP_EMA_ULPS = 5e-3, 6
# [dp sample]: two ranks of batch 2 vs one of batch 4 on the card, both with
# PyTorch's default precision flags (cuDNN convolutions in TF32, matmuls in
# f32). Every row is computed alone, but cuDNN may pick other algorithms at
# the other batch, so the roundings differ: TF32's 2^-11 (1/8 of bf16's) in
# the f32 first view, carried through 50 DDIM steps of a random-weight
# model, DP_F32_REL of its norm; the bf16-torso cond view within SR_BF16_REL;
# a condition-mask pixel flips only on a knife edge (CHAIN_MASK_FRAC).
DP_F32_REL = 5e-3

# The card's memory rate (NVIDIA H100 SXM data sheet) for the bytes bounds;
# the attention bounds take their peaks from ivid_tpu_torch.bench_attention.
PEAK_BYTES = 3.35e12


# The launch counts the phases print and check (``cuda_build.launches``
# keys; K1's launches by qkv width are read by ``k1_widths``).
COUNTED = ("K1", "K1 f32", "K2", "K2 bins", "K3", "K4", "K4 f32", "K5", "K6", "GN", "GN bias",
           "RES")


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
    cuda_build.build(cuda_build.SOURCES)
    for name in cuda_build.SOURCES:
        cuda_build.load(name)
    log(f"[device] built {sorted(cuda_build.build_seconds)} with nvcc for sm_90a in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v:.2f} s' for k, v in cuda_build.build_seconds.items())})")
    for name, text in cuda_build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[device] ptxas {name}: {line.strip()}")
    return smi


def phase_attention(b, seed, training, t=1024, heads=4, time_f32=True):
    """K1 at [b, t, 3·heads·64]: b=2 at T=1024 with 4 heads is the sampling
    shape; b=8 with ``training`` the training forward's, which also writes
    the log-sum-exp, so the entry's ``ms`` is the kernel's with it; T=4096
    and 6 heads are the SR cascade's shapes."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from ivid_tpu_torch import timing
    from ivid_tpu_torch.bench_attention import bound_ms
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
    bound, bound_by = bound_ms(b, t, heads, torch.bfloat16)
    bound32, _ = bound_ms(b, t, heads, torch.float32)
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
        from ivid_tpu_torch.bench_attention import sdpa_forward

        ms32, host32 = timed(lambda: attention.packed_attention(qkv32, heads, scale))
        plain32_ms = cuda_time_ms(lambda: attention.reference_attention(qkv32, heads, scale))
        q32, k32, v32 = (x.transpose(1, 2).contiguous()
                         for x in qkv32.reshape(b, t, heads, 3 * d).split(d, dim=-1))
        sdpa32_ms, _ = timed(lambda: F.scaled_dot_product_attention(q32, k32, v32))
        sdpa32_err = (sdpa_forward(qkv32, heads, scale)
                      - attention.reference_attention(qkv32, heads, scale)).abs().max().item()
        entry.update(f32_ms=ms32, f32_host_ms=host32, f32_plain_ms=plain32_ms,
                     f32_library_ms=sdpa32_ms, f32_library_max_abs_err=sdpa32_err)
        f32 = (f"; f32: kernel {ms32:.4f} ms (host {host32:.4f}, bound {bound32:.4f} ms), "
               f"plain {plain32_ms:.4f} ms, SDPA f32 {sdpa32_ms:.4f} ms device (max|err| against "
               f"the plain version {sdpa32_err:.3e})")
    log(f"{tag} bf16: kernel {ms:.4f} ms device, {host:.4f} host (with log-sum-exp "
        f"{lse_ms:.4f} / {lse_host:.4f}; bound {bound:.4f} ms by {bound_by}), plain "
        f"{plain_ms:.4f} ms, SDPA (unpacked, timing only) {sdpa_ms:.4f} device, "
        f"{sdpa_host:.4f} host; queued behind a spin: kernel {queued:.4f}, SDPA "
        f"{sdpa_queued:.4f}{f32}")
    return entry


def k2_phase(tag, name, replaces, inp, plain_reps=3):
    """K2 on one input (``ivid_tpu_torch.bench_raster``): checked against its
    plain version, timed (the plain version over ``plain_reps`` calls), and
    bounded. Returns its kernels-line entry."""
    from ivid_tpu_torch import bench_raster as br

    r, A = inp.r, inp.A
    cols = inp.cols()
    B = cols.valid.shape[0]
    st = br.check(cols, r, A)
    bound, bound_by, work = br.bound_ms(cols, r, A)
    del cols
    t = br.measure(inp, st["listed"], plain_reps=plain_reps)
    th = t["this"]
    log(f"[{tag}] {B} buffers x {r}², {work['valid_triangles']} valid triangles, covered "
        f"{st['covered']:.3f}: pixels differing from "
        f"the plain version {st['pixels_differing']} (all 0), max|attr err| "
        f"{st['max_abs_err']:.3e} (<= {br.ATTR_MAX}), two launches bit-equal "
        f"{st['bit_equal_relaunch']}; bins per 16x16 tile mean {st['bins_per_tile_mean']:.1f}, "
        f"max {st['bins_per_tile_max']}; pixels with tied winners {st['tied_pixels']} (most "
        f"winners {st['most_winners']}) in {st['tiles_with_a_tie']} tiles")
    log(f"[{tag}] device ms: bins {th['bins']:.4f} + raster {th['raster']:.4f} = kernels "
        f"{th['kernels']:.4f} (bound {bound:.4f} ms by {bound_by}: {work['bytes'] / 1e6:.1f} MB; "
        f"{work['covered_pairs']} covered (pixel, triangle) pairs, "
        f"{work['operations'] / 1e6:.1f} M unfused f32 operations); with the glue between them "
        f"{th['all']:.4f}; host ms "
        f"(events): the public call {th['call_host_ms']:.4f}, of which waiting for the bins' "
        f"length {th['sync_host_ms']:.4f}, the columns {th['columns_host_ms']:.4f}, the plain "
        f"version {t['plain_ms']:.4f}")
    return {
        "name": name, "route": "cuda", "source": "ivid_tpu_torch/csrc/dense_raster.cu",
        "replaces": replaces, "max_abs_err": st["max_abs_err"], "ms": th["kernels"],
        "plain_ms": t["plain_ms"], "bound_ms": bound, "bound_by": bound_by, "library_ms": None,
        "buffers": B, "bins_ms": th["bins"], "raster_ms": th["raster"], "with_glue_ms": th["all"],
        "call_host_ms": th["call_host_ms"],
        "sync_host_ms": th["sync_host_ms"], "columns_host_ms": th["columns_host_ms"],
        **{k: st[k] for k in ("bins_per_tile_mean", "bins_per_tile_max", "tied_pixels",
                              "most_winners", "tiles_with_a_tie")}, **work,
    }


def k2_capacity_check(inp):
    """K2's bins given one id less room than they need: the caller's check
    of the returned offsets (``raster_dense.check_capacity``) must raise."""
    from ivid_tpu_torch.ops import raster_dense as rd

    cols = inp.cols()
    listed = rd.bin_tiles(cols, inp.r)[3].numel()
    offsets = rd.bin_tiles(cols, inp.r, listed - 1)[2]
    try:
        rd.check_capacity(offsets, listed - 1)
    except RuntimeError as e:
        log(f"[K2 capacity] bins of {listed} ids given room for {listed - 1}: the check raised "
            f"({e})")
        return
    raise RuntimeError("K2's bins lost an id and the capacity check did not raise")


def phase_raster():
    """K2 on the aggregation's live slots, 4 and 26 at r=384."""
    import torch

    from ivid_tpu_torch import bench_raster as br

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's tie sums
    log(f"[K2] ptxas [registers, spilled bytes] {br.k2_registers()}")
    dev = torch.device("cuda")
    for name, st in br.hazard_checks(dev).items():
        log(f"[K2 {name}] {st['pixels']} pixels, covered {st['covered']:.3f}: pixels differing "
            f"from the plain version {st['pixels_differing']} (all 0), max|attr err| "
            f"{st['max_abs_err']:.3e}, two launches bit-equal {st['bit_equal_relaunch']}; tied "
            f"pixels {st['tied_pixels']}, most winners {st['most_winners']}")
    entries = [k2_phase(f"K2 {n} slots", "dense_raster", "ivid_tpu/ops/raster_dense.py:467",
                        br.slot_input(dev, n)) for n in (4, 26)]
    k2_capacity_check(br.slot_input(dev, 4))
    entries[0]["slots"], entries[1]["slots"] = 4, 26
    entries[0]["other_shapes"] = entries[1:]
    return entries[0]


def phase_raster_render():
    """K2 at the free-view render's shapes (``render.main`` rasters every
    view slot at ``s * ssaa``, SSAA 5): 27 slots of 128² views at 640² (a
    ``3x9`` scene) and 2 slots of 256² views at 1280² (an SR scene)."""
    import torch

    from ivid_tpu_torch import bench_raster as br

    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version's tie sums
    dev = torch.device("cuda")
    out = []
    for n, r, s in ((27, 640, 128), (2, 1280, 256)):
        e = k2_phase(f"K2 {r}", "dense_raster", "ivid_tpu/ops/raster_dense.py:467",
                     br.slot_input(dev, n, r=r, s=s), plain_reps=1)
        e.update(slots=n, view_size=s, r=r)
        out.append(e)
        torch.cuda.empty_cache()
    return out


def phase_resolve():
    import torch

    from ivid_tpu_torch.bench_raster import warp_render_inputs
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
    from ivid_tpu_torch import bench_raster as br

    return [k2_phase(f"K2 skirt B={B}", name, replaces, br.ring_input(f, r, slice(0, B)))
            for B, name, replaces in ((8, "dense_raster_skirt", "ivid_tpu/ops/raster_dense.py:467"),
                                      (1, "dense_raster_b1", "ivid_tpu/ops/raster_dense.py:458"))]


def compare_binned(got, want):
    """K5's output [T, 5, 1024] against its plain version: the depth (row 0)
    on every pixel, the four sums within K56_SUM_MAX. Returns (pixels
    differing, largest sum error). (K6's check: ``bench_resolve.k6_line``.)"""
    bad = int((got[:, 0] != want[:, 0]).sum())
    return bad, (got[:, 1:] - want[:, 1:]).abs().max().item()


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
    bad, err = compare_binned(rv.binned_resolve(lp, z, pay),
                              rv.binned_resolve_reference(lp, z, pay))
    lp2 = lp - 8 + (lp % 7 == 0).int() * 16  # some below 0 and some past 1023
    z2 = z - 0.5
    bad2, err2 = compare_binned(rv.binned_resolve(lp2, z2, pay),
                                rv.binned_resolve_reference(lp2, z2, pay))
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
    """K6 against its plain version (depth and count on every pixel, sums
    within K56_SUM_MAX, two launches bit-equal; ``bench_resolve.k6_line``)
    and timed warm and with the L2 cache cleared before each call, beside
    its bytes bound, on three inputs: (a) ``bench_resolve``'s shape (733,184
    clustered fragments at 384²), (b) the warp render's fragments
    (``warp_render_inputs``, first 3 payload channels), (c) (a) with 4,096
    fragments stacked on each of 64 pixels (``bench_resolve.make_stacked``),
    whose longest tile must exceed K6's staging ring. On (b) also K6 +
    ``tile_finish`` against K3 and the scatter, and the preparation and
    kernel of K6 and of K3 timed side by side, all in device ms."""
    import torch

    from ivid_tpu_torch import bench_resolve
    from ivid_tpu_torch.ops import raster, raster_tiled
    from ivid_tpu_torch.ops import resolve_variants as rv

    dev = torch.device("cuda")
    npix = bench_resolve.R ** 2
    gen = torch.Generator(device="cuda").manual_seed(5)
    fb, pay = bench_resolve.make_batch(gen, bench_resolve.N, bench_resolve.R)
    prepared = rv.prepare_tiles(fb.pixel, fb.depth, pay, fb.valid, npix)
    prep_ms, _ = timed(lambda: rv.prepare_tiles(fb.pixel, fb.depth, pay, fb.valid, npix))

    frags, pays = [f["fragments"]], [f["payload"]]
    pay3 = [f["payload"][..., :3]]
    B = f["win"].shape[0]
    wnpix = B * r * r

    def k6_prep():
        pix, d, valid, p = raster._concat(frags, pay3)
        return rv.prepare_tiles(pix, d, p, valid, wnpix)

    w_in = k6_prep()
    sfb, spay = bench_resolve.make_stacked(torch.Generator(device="cuda").manual_seed(6),
                                           bench_resolve.N, bench_resolve.R)
    s_in = rv.prepare_tiles(sfb.pixel, sfb.depth, spay, sfb.valid, npix)
    lines = {}
    for key, tag, inp in (("a", "bench shape", prepared), ("b", "warp render", w_in),
                          ("c", "stacked", s_in)):
        line = lines[key] = bench_resolve.k6_line(inp, dev)  # raises on any disagreement
        log(f"[K6] ({key}) {tag}: {line['fragments']} fragments, {line['tiles']} tiles, longest "
            f"{line['longest_tile']} (staged chunks {line['staging']}): against its plain version "
            f"depth and count equal, max|sum err| {line['max_sum_err']:.3e}, "
            f"{line['max_sum_rel']:.3e} of the sum or 1 (<= {K56_SUM_MAX}; the plain version "
            f"against itself {line['plain_self_diff']:.3e}), two launches bit-equal; kernel "
            f"{fmt_ms(line['ms']['this'])} ms warm, {fmt_ms(line['cold_ms']['this'])} with L2 "
            f"cleared, bound {line['bound_ms']:.4f} ms by bytes ({line['bytes'] / 1e6:.1f} MB), "
            f"plain version {line['plain_ms']:.4f} ms")
    # Sums of order 1 on (a) and (b): held to K56_SUM_MAX absolutely too.
    if not max(lines["a"]["max_sum_err"], lines["b"]["max_sum_err"]) <= K56_SUM_MAX:
        raise RuntimeError("K6's sums differ from its plain version's by more than "
                           f"{K56_SUM_MAX} on the bench shape or the warp render")
    if not lines["c"]["longest_tile"] > rv.TILE_STAGING:
        raise RuntimeError("the stacked input's longest tile fits K6's staging ring")
    log(f"[K6] prep (sort, tile search) at the bench shape {prep_ms:.4f} ms device")

    # K6 + tile_finish against K3 and the scatter (raises past bench_resolve.PAY_TOL).
    got = rv.tile_finish(rv.tile_resolve(*w_in), r, B)
    errs = {}
    for tag, want in (("K3", raster_tiled.resolve_zbuffer_tiled(frags, pays, r, B)),
                      ("scatter", raster.resolve_zbuffer_scatter(frags, pays, r, B))):
        errs[tag] = bench_resolve.compare(got, (want[0][..., :3], want[1], want[2]), f"K6 vs {tag}")
    log(f"[K6] warp render {B} x {r}², {wnpix // rv.TILE} tiles: K6 + tile_finish against K3 "
        f"and the scatter: coverage and depth equal on every pixel, max|payload err| "
        f"{errs['K3']:.3e} and {errs['scatter']:.3e} (<= {bench_resolve.PAY_TOL})")
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
    log(f"[K6] warp render, device ms: K6 prep (sort, tile search) {w['K6 prep']:.4f}, K6 kernel "
        f"{w['K6 kernel']:.4f}; K3 prep (sort, run search) {w['K3 prep']:.4f}, K3 kernel "
        f"{w['K3 kernel']:.4f}; of the preps, the stable sort of the keys alone "
        f"{w['sort']:.4f}, K3's run search alone ({wnpix + 1} edges) {w['K3 run search']:.4f}, "
        f"K3's gather of the [N, 4] payload rows alone {w['K3 payload gather']:.4f}")
    a = lines["a"]
    return {
        "name": "tile_resolve", "route": "cuda", "source": "ivid_tpu_torch/csrc/tile_resolve.cu",
        "replaces": "bench_resolve.py:136",
        "max_abs_err": max(x["max_sum_err"] for x in lines.values()),
        "ms": a["ms"]["this"][0], "cold_ms": a["cold_ms"]["this"][0], "plain_ms": a["plain_ms"],
        "bound_ms": a["bound_ms"], "bound_by": "bytes", "library_ms": None, "prep_ms": prep_ms,
        "fragments": bench_resolve.N, "staging": rv.TILE_STAGING,
        "inputs": {k: {x: v[x] for x in ("fragments", "tiles", "longest_tile", "ms", "cold_ms",
                                         "bound_ms", "plain_ms", "max_sum_err", "max_sum_rel",
                                         "plain_self_diff", "bit_equal")}
                   for k, v in lines.items()},
        "warp": {"buffers": B, "valid_fragments": int(f["fragments"].valid.sum()),
                 "max_payload_err_vs_k3": errs["K3"],
                 **{k.replace(" ", "_") + "_ms": v for k, v in w.items()}},
    }


def fmt_ms(ms_list):
    """The turns' device ms of one version, "not measured" where a reading
    fell back to queued events."""
    return "/".join("not measured" if x is None else f"{x:.4f}" for x in ms_list)


def phase_benches():
    """``bench_resolve.main`` and ``bench_micro.main`` at their defaults, with
    the launch counter read around them."""
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

    from ivid_tpu_torch.bench_attention import bound_ms
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
        r["bound"], r["bound_by"] = bound_ms(b, t, heads, dtype, backward=True)
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


# The cases K1 f32 and K4 f32 are checked at beyond bench_attention.SHAPES
# (the sampling, training and flagship shapes): the SR shapes, a ragged T
# and inputs scaled x8. (tag, batch, T, heads, input scale).
F32_EXTRA_CASES = (
    ("SR T=4096", 2, 4096, 4, 1.0), ("SR 6 heads", 2, 1024, 6, 1.0),
    ("ragged T=1000", 2, 1000, 4, 1.0), ("inputs x8", 2, 1024, 4, 8.0),
)


def f32_cases():
    """K1 f32 and K4 f32 (split-TF32 products) on every shape the paths give
    them, at unit inputs, then F32_EXTRA_CASES."""
    from ivid_tpu_torch.bench_attention import SHAPES

    return tuple((tag, b, t, h, 1.0) for tag, (b, t, h) in SHAPES.items()) + F32_EXTRA_CASES


def f32_case(tag, b, t, heads, mult, seed):
    """K1 f32 (with the log-sum-exp) and K4 f32 at one case against their
    plain versions, and each launched twice for bit-equality. Unit inputs:
    max|err| against the plain version in f32 (TF32 off) within K1_F32_MAX,
    K1_LSE_MAX and K4_F32_MAX (K4 also against its formula form). Inputs x8:
    the logits reach ~200 and the plain version in f32 is itself ~1e-3 from
    exact, so the kernels are held to the plain version in f64 within
    F32_X8_REL of the largest output. Returns the numbers."""
    import numpy as np
    import torch

    from ivid_tpu_torch.ops import attention

    dev = torch.device("cuda")
    c = heads * 64
    scale = 64 ** -0.25
    rng = np.random.default_rng(seed)
    qkv = torch.from_numpy((rng.standard_normal((b, t, 3 * c)) * mult).astype(np.float32)).to(dev)
    dout = torch.from_numpy(rng.standard_normal((b, t, c)).astype(np.float32)).to(dev)
    out, lse = attention._launch(qkv, heads, scale, with_lse=True)
    out2, lse2 = attention._launch(qkv, heads, scale, with_lse=True)
    dqkv = attention._launch_bwd(qkv, out, dout, lse, heads, scale)
    dqkv2 = attention._launch_bwd(qkv, out, dout, lse, heads, scale)
    bit_equal = bool(torch.equal(out, out2) and torch.equal(lse, lse2) and torch.equal(dqkv, dqkv2))
    ref_dtype = torch.float64 if mult != 1.0 else torch.float32
    x = qkv.to(ref_dtype).requires_grad_()
    want = attention.reference_attention(x, heads, scale)
    (dwant,) = torch.autograd.grad(want, x, dout.to(ref_dtype))
    want_lse = attention.logsumexp_reference(qkv.to(ref_dtype), heads, scale)
    r = {"out": (out.to(ref_dtype) - want).abs().max().item(),
         "lse": (lse.to(ref_dtype) - want_lse).abs().max().item(),
         "dqkv": (dqkv.to(ref_dtype) - dwant).abs().max().item(), "bit_equal": bit_equal}
    if mult == 1.0:
        form = attention.attention_backward_reference(qkv, out, dout, lse, heads, scale)
        r["dqkv_formula"] = (dqkv - form).abs().max().item()
        ok = (r["out"] <= K1_F32_MAX and r["lse"] <= K1_LSE_MAX and r["dqkv"] <= K4_F32_MAX
              and r["dqkv_formula"] <= K4_F32_MAX)
        limits = f"<= {K1_F32_MAX}, {K1_LSE_MAX}, {K4_F32_MAX}"
    else:
        tops = {"out": want.abs().max().item(), "lse": want_lse.abs().max().item(),
                "dqkv": dwant.abs().max().item()}
        r.update({f"{k}_max_abs": v for k, v in tops.items()})
        ok = all(r[k] <= F32_X8_REL * tops[k] for k in tops)
        limits = (f"<= {F32_X8_REL} of the largest: {F32_X8_REL * tops['out']:.3e}, "
                  f"{F32_X8_REL * tops['lse']:.3e}, {F32_X8_REL * tops['dqkv']:.3e}; against f64")
    torch.cuda.synchronize()
    extra = f", K4 against its formula form {r['dqkv_formula']:.3e}" if "dqkv_formula" in r else ""
    log(f"[K1/K4 f32] {tag} [{b},{t},{3 * c}] {heads} heads: max|err| out {r['out']:.3e}, "
        f"log-sum-exp {r['lse']:.3e}, dqkv {r['dqkv']:.3e} ({limits}){extra}; two launches "
        f"bit-equal {bit_equal}")
    if not (ok and bit_equal):
        raise RuntimeError(f"K1/K4 f32 disagree with their plain versions at {tag}")
    return r


def phase_f32_attention():
    """K1 f32 and K4 f32 on :func:`f32_cases`, then timed at the flagship's shapes
    beside the plain version and SDPA in f32 (TF32 off; SDPA's own max|err|
    against the plain version printed beside its time). Returns the two
    kernels-line entries: K1 f32 at the flagship sampling shape (with the
    training shape's times under ``training``) and K4 f32 at the flagship
    training shape."""
    import torch

    from ivid_tpu_torch import bench_attention as ba

    torch.backends.cuda.matmul.allow_tf32 = False
    checks = {tag: f32_case(tag, b, t, h, mult, seed)
              for seed, (tag, b, t, h, mult) in enumerate(f32_cases())}
    gen = torch.Generator(device="cuda").manual_seed(21)
    src = {"this": ba.cuda_build.CSRC}
    rows = {}
    for kernel, shape in (("K1", "flagship sampling"), ("K1", "flagship training"),
                          ("K4", "flagship training")):
        r = ba.bench_one(kernel, torch.float32, shape, src, ["this"], gen)
        rows[(kernel, shape)] = r
        log(f"[K1/K4 f32] {kernel} {shape} {r['shape']} {r['heads']} heads"
            f"{' with log-sum-exp' if r['with_lse'] else ''}: kernel {r['ms']['this'][0]:.4f} ms "
            f"device, {r['host_ms']['this'][0]:.4f} host (bound {r['bound_ms']:.4f} ms by "
            f"{r['bound_by']}), plain {r['plain_ms']:.4f} ms, SDPA f32 {r['library_ms']:.4f} ms "
            f"device (max|err| against the plain version {r['library_max_abs_err']:.3e}; kernel's "
            f"{r['max_abs_err']:.3e}; SDPA ran {r['library_kernels'][:2]})")
        torch.cuda.empty_cache()

    def entry(r, name, source, replaces):
        return {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "max_abs_err": r["max_abs_err"], "ms": r["ms"]["this"][0],
            "host_ms": r["host_ms"]["this"][0], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_max_abs_err": r["library_max_abs_err"],
            "library_kernels": r["library_kernels"], "shape": r["shape"], "heads": r["heads"],
        }

    k1 = entry(rows[("K1", "flagship sampling")], "packed_attention_f32",
               "ivid_tpu_torch/csrc/packed_attention.cu", "ivid_tpu/ops/attention.py:167")
    k1["training"] = entry(rows[("K1", "flagship training")], "packed_attention_f32",
                           "ivid_tpu_torch/csrc/packed_attention.cu",
                           "ivid_tpu/ops/attention.py:167")
    k4 = entry(rows[("K4", "flagship training")], "packed_attention_bwd_f32",
               "ivid_tpu_torch/csrc/packed_attention_bwd.cu", "ivid_tpu/ops/attention.py:312")
    k1["checks"] = k4["checks"] = checks
    return k1, k4


def phase_flagship_unet():
    """The flagship 1000-class f32 UNet at full width (seeded random
    weights), batch 2 with classes, on the card (K1 f32 at its five T=1024
    sites) against the same weights on the CPU plain path, TF32 off."""
    import numpy as np
    import torch

    from ivid_tpu_torch.config import Config, build_backbone
    from ivid_tpu_torch.models.adm import randomize_parameters

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.load(FLAGSHIP_UNCOND)
    cpu_model = randomize_parameters(build_backbone(cfg), seed=0).eval()
    gpu_model = build_backbone(cfg)
    gpu_model.load_state_dict(cpu_model.state_dict())
    gpu_model.to("cuda").eval()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 128, 128, 4)).astype(np.float32))
    t = torch.tensor([999, 10])
    classes = torch.tensor([7, 999])
    t0 = time.perf_counter()
    with torch.no_grad():
        want = cpu_model(x, t, classes)
        cpu_s = time.perf_counter() - t0
        before = read_counts()
        got = gpu_model(x.cuda(), t.cuda(), classes.cuda()).cpu()
    counts = counts_since(before)
    sites, sites32 = counts["K1"], counts["K1 f32"]
    rel = ((got - want).norm() / want.norm()).item()
    n_params = sum(p.numel() for p in cpu_model.parameters())
    log(f"[flagship unet] {os.path.basename(FLAGSHIP_UNCOND)} ({n_params} parameters), f32, "
        f"batch 2, classes {classes.tolist()}: card (K1 f32 at {sites32} of {sites} attention "
        f"launches) vs CPU plain path ({cpu_s:.1f} s): rel L2 {rel:.3e} (<= {UNET_REL}), output "
        f"std {want.std().item():.3f}, finite {bool(torch.isfinite(got).all())}")
    if not (rel <= UNET_REL and torch.isfinite(got).all() and sites == sites32 == 5):
        raise RuntimeError("the flagship UNet on the card disagrees with the CPU plain path")
    torch.backends.cudnn.allow_tf32 = True


def phase_flagship_pipeline(steps_uncond=50):
    """``sample.main`` with the flagship pair (uncond f32, cond bf16 torso),
    random viewset, batch 2; the uncond sampler cut from 1000 DDPM steps to
    ``steps_uncond`` strided DDIM steps to fit the time limit."""
    import numpy as np

    from ivid_tpu_torch import sample

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_flagship_")
    argv = [
        "--config_uncond", FLAGSHIP_UNCOND, "--config_cond", FLAGSHIP_COND,
        "--ckpt_uncond", "random", "--ckpt_cond", "random",
        "--output_dir", out_dir, "--seeds", "0-1", "--viewset", "random",
        "--batchsize", "2", "--steps_uncond", str(steps_uncond), "--steps_cond", "50",
        "--device", "cuda",
    ]
    reset_counts()
    t0 = time.perf_counter()
    result = sample.main(argv)
    wall = time.perf_counter() - t0
    counts = read_counts()
    samples = np.concatenate(result["samples"], axis=0)
    images = sorted(os.listdir(os.path.join(result["output_dir"], "results")))
    st = result["stage_ms"]
    log(f"[flagship pipeline] sample.main, flagship pair, random viewset, batch 2, uncond DDIM "
        f"{steps_uncond} strided steps (cut from DDPM 1000) + cond DDIM 50: wall {wall:.2f} s; "
        f"stages (CUDA events) " + ", ".join(f"{k} {v:.1f} ms" for k, v in st.items()))
    log(f"[flagship pipeline] samples {samples.shape} finite {bool(np.isfinite(samples).all())}; "
        f"{len(images)} result png; launches {counts} (K1 f32 {5 * steps_uncond}: five sites "
        f"per uncond step; GN {GN_SITES} and RES {RES_SITES} a forward of 5 K1 sites: "
        f"{GN_SITES * counts['K1'] // 5}, {RES_SITES * counts['K1'] // 5})")
    if not (np.isfinite(samples).all() and samples.shape == (2, 2, 128, 128, 4)
            and len(images) == 2 and counts["K1 f32"] == 5 * steps_uncond
            and counts["K1"] > counts["K1 f32"] and counts["K2"] >= 1
            and counts["K1"] % 5 == 0 and folded(counts, counts["K1"] // 5)
            and counts["K4"] == counts["K3"] == counts["K5"] == counts["K6"] == 0):
        raise RuntimeError("the flagship pipeline run failed its checks")
    return counts, result["output_dir"]


def phase_flagship_train(steps=3):
    """``train.main`` with the flagship uncond config (BasicTrainer, CFG, f32,
    batch 16 as the config says), its dataset section swapped to
    SyntheticRGBD with 1000 classes (the ImageNet files are not in the
    repository), ``steps`` AdamW steps; K1 f32 with the log-sum-exp and K4
    f32 on the path, peak memory printed."""
    import numpy as np
    import torch

    from ivid_tpu_torch import train
    from ivid_tpu_torch.training.trainer import StepRecord

    with open(FLAGSHIP_UNCOND) as f:
        cfg = json.load(f)
    args = cfg["dataset"]["args"]
    cfg["dataset"] = {"name": "SyntheticRGBD", "args": {
        "image_size": args["image_size"], "normalize": args["normalize"],
        "normalize_depth": args["normalize_depth"], "prepocess_depth": args["prepocess_depth"],
        "num_classes": 1000, "length": 256}}
    cfg["trainer"]["args"].update(max_steps=steps, i_log=steps, i_save=10 ** 9,
                                  i_sample=10 ** 9, sample_at_init=False)
    batch, split = cfg["trainer"]["args"]["batch_size_per_gpu"], cfg["trainer"]["args"]["batch_split"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_flagship_train_")
    path = os.path.join(tmp, os.path.basename(FLAGSHIP_UNCOND))
    with open(path, "w") as f:
        json.dump(cfg, f)
    rec = StepRecord(timing=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    tr = train.main(["--config", path, "--output_dir", os.path.join(tmp, "out"),
                     "--device", "cuda"], record=rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    losses = [float(x) for x in rec.losses]
    step_ms = [round(m["step"], 3) for m in rec.stage_ms()]
    finite = all(torch.isfinite(p).all() for p in tr.model.parameters())
    log(f"[flagship train] train.main, {os.path.basename(FLAGSHIP_UNCOND)} (BasicTrainer, CFG, "
        f"f32), SyntheticRGBD 128² with 1000 classes, batch {batch} (batch_split {split}), "
        f"{steps} AdamW steps: wall {wall:.2f} s; losses {np.round(losses, 5).tolist()}; ms per "
        f"step (CUDA events) {step_ms}; peak memory {peak:.2f} GiB; launches {counts} (K1 f32 and "
        f"K4 f32 5 per step, GN and RES 0)")
    if not (np.isfinite(losses).all() and len(losses) == steps and finite
            and counts["K1 f32"] == counts["K1"] == 5 * steps
            and counts["K4 f32"] == counts["K4"] == 5 * steps
            and counts["GN"] == counts["RES"] == 0):
        raise RuntimeError("the flagship training run failed its checks")
    del tr
    return counts, peak


def phase_flagship_ab(reps=2):
    """The model-level A/B: ``bench_unet.main`` (the flagship uncond step at
    batch 10 and the BasicTrainer step at 16, each with the attention sites
    on K1/K4 f32, the plain version and SDPA, in turns)."""
    from ivid_tpu_torch import bench_unet

    reset_counts()
    lines = bench_unet.main(["--reps", str(reps)])
    counts = read_counts()
    for line in lines:
        ms = {k: [round(x, 2) for x in v] for k, v in line["ms"].items()}
        dev_ms = {k: round(v["device_ms"], 2) for k, v in line["profile"].items()}
        log(f"[flagship A/B] {line['cell']} at batch {line['batch']}: ms per step (CUDA events) "
            f"{ms}; device ms of one more step (torch.profiler) {dev_ms}; K1/K4 launches by "
            f"version {line['launches']}")
        for name, prof in line["profile"].items():
            log(f"[flagship A/B]   {name}: {prof['kernels']} kernels; largest {prof['top'][:3]}")
    uncond, train = lines
    if not (uncond["launches"]["kernel"] == [5 * (reps + 1), 0]
            and train["launches"]["kernel"] == [5 * (reps + 1)] * 2
            and all(uncond["launches"][v] == train["launches"][v] == [0, 0]
                    for v in ("plain", "sdpa"))
            and counts["K1 f32"] == counts["K1"] and counts["K4 f32"] == counts["K4"]):
        raise RuntimeError(f"the A/B's kernel turns missed a kernel: {counts}")
    return lines


def kernel_sites(model, run):
    """The attention sites of ``model`` that went through K1 while ``run()``
    ran, counted from the model's own blocks (``AttentionBlock.uses_kernel``
    of each block's input)."""
    from ivid_tpu_torch.models.adm import AttentionBlock

    sites = []
    hooks = [m.register_forward_pre_hook(
        lambda mod, args: sites.append(mod.uses_kernel(args[0].shape[2] * args[0].shape[3])))
        for m in model.modules() if isinstance(m, AttentionBlock)]
    try:
        out = run()
    finally:
        for h in hooks:
            h.remove()
    return out, sum(sites), len(sites)


def phase_sr_unet():
    """The full-width SR UNet (``rgbd_imagenet_adm_256_128_small_sr.json``,
    256², 8 inputs, 1000 classes; seeded weights), batch 1 with a class, on
    the card against the same weights on the CPU plain path: in f32 (TF32
    off) to ``UNET_REL``, and with its bf16 torso to ``SR_BF16_REL``. Returns
    the number of K1 sites per forward, counted from the model."""
    import numpy as np
    import torch

    from ivid_tpu_torch.config import Config, build_backbone
    from ivid_tpu_torch.models.adm import randomize_parameters

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.load(SR_CFG)
    cpu_model = randomize_parameters(build_backbone(cfg, dtype=torch.float32), seed=0).eval()
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((1, 256, 256, 8)).astype(np.float32))
    t, classes = torch.tensor([500]), torch.tensor([7])
    t0 = time.perf_counter()
    with torch.no_grad():
        want = cpu_model(x, t, classes)
        cpu_s = time.perf_counter() - t0
        # The bf16 torso's own gap on the CPU, the scale of SR_BF16_REL.
        cpu16 = build_backbone(cfg)
        cpu16.load_state_dict(cpu_model.state_dict())
        cpu_rel16 = ((cpu16.eval()(x, t, classes) - want).norm() / want.norm()).item()
        del cpu16
    res = {}
    for name, dtype in (("f32", torch.float32), ("bf16 torso", None)):
        gpu_model = build_backbone(cfg, dtype=dtype)
        gpu_model.load_state_dict(cpu_model.state_dict())
        gpu_model.to("cuda").eval()
        before = read_counts()
        with torch.no_grad():
            got, sites, blocks = kernel_sites(
                gpu_model, lambda: gpu_model(x.cuda(), t.cuda(), classes.cuda()).cpu())
        counts = counts_since(before)
        res[name] = (((got - want).norm() / want.norm()).item(), bool(torch.isfinite(got).all()),
                     counts["K1"], counts["K1 f32"])
        del gpu_model
    n_params = sum(p.numel() for p in cpu_model.parameters())
    (rel32, fin32, k1_32, f32_32), (rel16, fin16, k1_16, f32_16) = res["f32"], res["bf16 torso"]
    log(f"[SR unet] {os.path.basename(SR_CFG)} ({n_params} parameters), 256², batch 1, class 7, "
        f"vs the CPU plain path in f32 ({cpu_s:.1f} s): f32 on the card rel L2 {rel32:.3e} (<= "
        f"{UNET_REL}), bf16 torso rel L2 {rel16:.3e} (<= {SR_BF16_REL}; the bf16 torso on the "
        f"CPU: {cpu_rel16:.3e}); output std "
        f"{want.std().item():.3f}; finite {fin32 and fin16}; {blocks} attention blocks, {sites} "
        f"through K1 (T >= 512): K1 launches f32 {k1_32} (K1 f32 {f32_32}), bf16 {k1_16} "
        f"(K1 f32 {f32_16})")
    if not (rel32 <= UNET_REL and rel16 <= SR_BF16_REL and fin32 and fin16 and sites > 0
            and k1_32 == f32_32 == sites and k1_16 == sites and f32_16 == 0):
        raise RuntimeError("the SR UNet on the card disagrees with the CPU plain path")
    torch.backends.cudnn.allow_tf32 = True
    return sites


def phase_sr_chain(device="cuda"):
    """A small SR chain (32² f32 SuperResCFG UNet with 10 classes, K1 at its
    32² sites; conditions 16² SyntheticRGBDSR items; 5 guided DDIM steps) on
    ``device`` against the same weights and noise on the CPU plain path."""
    import numpy as np
    import torch

    from ivid_tpu_torch.data import SyntheticRGBDSR
    from ivid_tpu_torch.diffusion import samplers
    from ivid_tpu_torch.diffusion.frameworks import build_framework
    from ivid_tpu_torch.host_noise import HostNoise
    from ivid_tpu_torch.models import adm

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    backbone = dict(
        image_size=32, in_channels=8, out_channels=4, model_channels=64, num_res_blocks=1,
        channel_mult=[1, 2], attention_resolutions=[32, 16], num_groups=32, num_heads=None,
        num_head_channels=64, num_classes=10, has_null_class=True, dropout=0.0, use_fp16=False,
    )
    weights = adm.randomize_parameters(adm.build_adm_unet(backbone), seed=4).state_dict()
    data = SyntheticRGBDSR(image_size=32, image_size_lr=16, length=4, normalize=True,
                           normalize_depth=True, prepocess_depth="z_buffer")
    y = torch.from_numpy(np.stack([data[i]["y"] for i in range(2)]))
    classes = torch.tensor([1, 4])

    def run(device):
        model = adm.build_adm_unet(backbone)
        model.load_state_dict(weights)
        fw = build_framework("SuperResCFG", model.to(device).eval(),
                             {"timesteps": 100, "beta_schedule": "linear", "p_uncond": 0.1},
                             device=device)
        out, sites, _ = kernel_sites(model, lambda: samplers.ddim_sample(
            fw, HostNoise(5, device), num=2, image_size=32,
            cond={"y": y.to(device), "classes": classes.to(device)}, guidance=3.0,
            steps=5)["samples"].cpu().numpy())
        return out, sites

    before = read_counts()
    got, sites = run(torch.device(device))
    k1 = counts_since(before)["K1"]
    want, _ = run(torch.device("cpu"))
    rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    log(f"[SR chain] SuperResCFG 16² -> 32², f32, batch 2, classes {classes.tolist()}, 5 guided "
        f"DDIM steps: card (K1 {k1} launches, {sites} sites counted from the model) vs CPU plain "
        f"path: rel L2 {rel:.3e} (<= {CHAIN_REL}); finite {bool(np.isfinite(got).all())}")
    if not (rel <= CHAIN_REL and np.isfinite(got).all() and k1 == sites > 0):
        raise RuntimeError("the SR chain on the card disagrees with the CPU plain path")
    torch.backends.cudnn.allow_tf32 = True


def phase_sr(scene_dir, sites, steps=50):
    """``ivid_tpu_torch.sr.main`` over the scenes ``scene_dir`` holds (the
    flagship pipeline's: 2 scenes of 2 views): the full-width SR model with
    seeded weights, ``steps`` guided DDIM steps, guidance 3, classes from the
    file names, ``--save_scenes``. ``sites`` is the model's K1 sites per
    forward (``phase_sr_unet``)."""
    import numpy as np

    from ivid_tpu_torch import sr
    from ivid_tpu_torch.inference.scene_io import load_scene

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_sr_")
    argv = ["--config_sr", SR_CFG, "--ckpt_sr", "random", "--scene_dir", scene_dir,
            "--output_dir", out_dir, "--steps", str(steps), "--guidance", "3",
            "--classes", "mod", "--save_scenes", "--device", "cuda"]
    reset_counts()
    t0 = time.perf_counter()
    result = sr.main(argv)
    wall = time.perf_counter() - t0
    counts = read_counts()
    samples = result["samples"]
    n_views = sum(len(s) for s in samples)
    chunks = len(samples)  # every scene's views fit one --batchsize chunk
    pngs = sorted(os.listdir(os.path.join(out_dir, "results_sr")))
    reloaded = []
    for name in sorted(os.listdir(os.path.join(out_dir, "scenes_sr"))):
        meshes, colors = load_scene(os.path.join(out_dir, "scenes_sr", name), device="cuda")
        reloaded.append([(tuple(c.shape), tuple(m.depth.shape)) for m, c in zip(meshes, colors)])
    st = result["stage_ms"]
    log(f"[SR] sr.main, {os.path.basename(SR_CFG)}, seeded weights, {len(samples)} scenes of "
        f"the flagship pipeline, {n_views} views, DDIM {steps} guided steps (guidance 3, CFG "
        f"batch 2 x views): wall {wall:.2f} s, {n_views / wall:.3f} SR views/s; stages (CUDA "
        f"events) " + ", ".join(f"{k} {v:.1f} ms" for k, v in st.items()))
    log(f"[SR] samples {[s.shape for s in samples]} finite "
        f"{all(np.isfinite(s).all() for s in samples)}; results_sr {pngs}; scenes_sr reloaded "
        f"(color, depth shapes) {reloaded}; launches {counts} (K1 {sites} sites x {steps} steps "
        f"x {chunks} chunks = {sites * steps * chunks}; GN {GN_SITES} and RES {RES_SITES} a "
        f"forward = {GN_SITES * steps * chunks}, {RES_SITES * steps * chunks})")
    if not (len(samples) == 2 and all(s.shape == (2, 256, 256, 4) and np.isfinite(s).all()
                                      for s in samples)
            and len(pngs) == 2
            and reloaded == [[((256, 256, 3), (256, 256, 1))] * 2] * 2
            and counts["K1"] == sites * steps * chunks and counts["K1 f32"] == 0
            and folded(counts, steps * chunks)
            and all(counts[k] == 0 for k in ("K2", "K2 bins", "K3", "K4", "K5", "K6"))):
        raise RuntimeError("the SR run failed its checks")
    profile_sr_step()
    return counts, out_dir


def write_scene(root, views, s, seed=0):
    """A seeded scene of ``views`` s² views from the ``3x9`` viewset's cameras,
    saved with the port's ``save_scene`` as ``{root}/scenes/scene_seed00000.npz``."""
    import numpy as np
    import torch

    from ivid_tpu_torch.inference.scene_io import save_scene
    from ivid_tpu_torch.inference.viewsets import build_viewset
    from ivid_tpu_torch.ops import geometry as geom

    rng = np.random.default_rng(seed)
    ii = np.linspace(0, 1, s)
    yy, xx = np.meshgrid(ii, ii, indexing="ij")
    meshes, colors = [], []
    for mv in build_viewset("3x9", 1)[:views]:
        d01 = np.clip(0.35 + 0.3 * yy + 0.04 * np.sin(xx * 9 + rng.uniform(0, 6.28))
                      + 0.05 * np.sin(xx * 21) * np.sin(yy * 17), 0.05, 0.95)
        depth = geom.linearize_depth(torch.from_numpy(d01.astype(np.float32)[..., None]), 0.6, 5.0)
        meshes.append(geom.depth_to_mesh(depth, padding="frustum", modelview=torch.from_numpy(mv))
                      .map(lambda x: x.numpy()))
        colors.append(np.clip(0.5 + 0.4 * np.sin(xx[..., None] * rng.uniform(2, 9, 3)
                                                  + yy[..., None] * rng.uniform(2, 9, 3)), 0, 1))
    os.makedirs(os.path.join(root, "scenes"), exist_ok=True)
    save_scene(os.path.join(root, "scenes", "scene_seed00000.npz"), meshes, colors)
    return root


def render_run(tag, scene_dir, frames, traj="swing", ssaa=5, device="cuda"):
    """``render.main`` over ``scene_dir`` with the launch counter read
    around it; checks the frames and the files and that K2 ran once (with
    its bins) per frame on the card. Returns the result and the counts."""
    import numpy as np

    from ivid_tpu_torch import render
    from ivid_tpu_torch.ops import raster_dense

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_render_")
    argv = ["--scene_dir", scene_dir, "--output_dir", out_dir, "--frames", str(frames),
            "--traj", traj, "--ssaa", str(ssaa), "--save_frames", "--device", device]
    reset_counts()
    t0 = time.perf_counter()
    res = render.main(argv)
    wall = time.perf_counter() - t0
    counts = read_counts()
    n = res["n_frames"]
    shapes = {k: (c.shape, d.shape) for k, (c, d) in res["frames"].items()}
    written = sorted(os.listdir(os.path.join(out_dir, "videos" if traj == "swing" else "results")))
    spread = {k: c.std() for k, (c, _) in res["frames"].items()}
    per_frame = {k: v / n for k, v in res["stage_ms"].items()}
    log(f"[render] {tag}: {n} frames at SSAA {ssaa} on {device}: wall {wall:.3f} s, "
        f"{n / wall:.3f} frames/s; per frame (CUDA events) "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in per_frame.items())
        + f"; frames {shapes}; written {written}; K2 {counts['K2']}, bins {counts['K2 bins']}; "
        f"host ms waiting for the bins' length {raster_dense.sync_s * 1e3:.3f}")
    stems = [f"{k}.png" for k in shapes] if traj == "random" else [
        f for k in shapes for f in (k, f"{k}_depth")]
    # A video file, or with no video library a directory of PNG frames.
    found = all(any(stem + ext in written for ext in ("", ".mp4", ".gif")) for stem in stems)
    if not (n > 0 and all(c == d for c, d in shapes.values())
            and sum(c[0] for c, _ in shapes.values()) == n
            and found and all(v > 0 for v in spread.values())
            and (device == "cpu" or counts["K2"] == counts["K2 bins"] == n)
            and all(counts[k] == 0 for k in ("K1", "K3", "K4", "K5", "K6"))):
        raise RuntimeError(f"the render run {tag} failed its checks")
    return res, counts


def phase_render(flagship_scenes, sr_dir):
    """``ivid_tpu_torch.render.main`` on the card at SSAA 5: a seeded 27-view
    128² scene (27 slots at 640²) as the CLI's default 60-frame swing and
    one random pose; the flagship pipeline's 2-view scenes, 8 frames; the
    SR run's 256² scenes (1280²), 4 frames. Then one frame of a 27-view 32²
    scene at SSAA 5 on the card against the CPU (the size that the CPU
    renders in ~10 s). Returns the K2 counts of the 640² and the 1280²
    runs, and the 128² color frames."""
    import numpy as np

    root = tempfile.mkdtemp(prefix="chip_smoke_scene27_")
    write_scene(root, 27, 128)
    swing, counts = render_run("27 views of 128² (r 640), swing", root, 60)
    render_run("27 views of 128² (r 640), random pose", root, 1, traj="random")
    flagship = render_run("flagship pipeline's 2 scenes of 2 views (r 640), swing",
                          flagship_scenes, 8)[0]
    sr_scenes = tempfile.mkdtemp(prefix="chip_smoke_sr_scenes_")
    os.symlink(os.path.join(sr_dir, "scenes_sr"), os.path.join(sr_scenes, "scenes"))
    sr_counts = render_run("SR run's 2 scenes of 2 views of 256² (r 1280), swing", sr_scenes, 4)[1]

    small = tempfile.mkdtemp(prefix="chip_smoke_scene27s_")
    write_scene(small, 27, 32, seed=1)
    got = render_run("27 views of 32² (r 160), card", small, 1)[0]["frames"]["scene_seed00000"]
    t0 = time.perf_counter()
    want = render_run("27 views of 32² (r 160), CPU", small, 1, device="cpu")[0]
    want = want["frames"]["scene_seed00000"]
    diff = [np.abs(g.astype(int) - w.astype(int)) for g, w in zip(got, want)]
    share = [float((d.max(-1) > RENDER_LEVELS).mean()) for d in diff]
    log(f"[render] one frame of 27 views of 32² at SSAA 5 (r 160), card vs CPU ({time.perf_counter() - t0:.1f} s "
        f"on the CPU): color 8-bit levels max {int(diff[0].max())}, pixels off by more than "
        f"{RENDER_LEVELS} level {share[0]:.4f}; depth image max {int(diff[1].max())}, pixels "
        f"off {share[1]:.4f} (<= {RENDER_OFF_SHARE})")
    if not max(share) <= RENDER_OFF_SHARE:
        raise RuntimeError("the render on the card disagrees with the CPU")
    frames = [f for res in (swing, flagship) for c, _ in res["frames"].values() for f in c]
    return {"640": counts, "1280": sr_counts}, frames


def eval_images(frames, n=64, s=128, seed=0):
    """``n`` fake and ``n`` real s² uint8 images: the fakes the rendered
    s² frames topped up with seeded smooth images, the reals seeded smooth
    images of another seed."""
    import numpy as np

    def smooth(rng, k):
        ii = np.linspace(0, 1, s)
        yy, xx = np.meshgrid(ii, ii, indexing="ij")
        f = rng.uniform(1, 12, (k, 1, 1, 3))
        ph = rng.uniform(0, 6.28, (k, 1, 1, 3))
        img = 0.5 + 0.35 * np.sin(xx[None, ..., None] * f + ph) * np.cos(yy[None, ..., None] * f)
        return (np.clip(img + rng.normal(0, 0.05, img.shape), 0, 1) * 255).astype(np.uint8)

    fake = [f for f in frames if f.shape == (s, s, 3)][:n]
    fake = np.concatenate([np.stack(fake), smooth(np.random.default_rng(seed), n - len(fake))])
    return fake, smooth(np.random.default_rng(seed + 1), n)


def phase_eval(frames):
    """``ivid_tpu_torch.eval.main`` on 64 fake and 64 real 128² PNGs with
    ``randconv`` and with ``inception:`` a seeded state dict (numpy seed 0,
    saved by ``torch.save``), on the card and on the CPU; the metrics must
    agree. Then each extractor's images/s on the card."""
    import numpy as np
    import torch

    from ivid_tpu_torch import eval as teval
    from ivid_tpu_torch.evals import inception, metrics
    from ivid_tpu_torch.utils.images import png_encode

    root = tempfile.mkdtemp(prefix="chip_smoke_eval_")
    fake, real = eval_images(frames)
    for name, imgs in (("fake", fake), ("real", real)):
        os.makedirs(os.path.join(root, name))
        for i, img in enumerate(imgs):
            with open(os.path.join(root, name, f"{i:03d}.png"), "wb") as f:
                f.write(png_encode(img))
    weights = os.path.join(root, "inception_seeded.pt")
    torch.save(inception.seeded_state_dict(0), weights)
    for ext in ("randconv", f"inception:{weights}"):
        tag = ext.split(":")[0]
        got = {}
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            got[device] = teval.main([
                "--real_images_dir", os.path.join(root, "real"),
                "--fake_images_dir", os.path.join(root, "fake"),
                "--tmp_dir", os.path.join(root, f"{tag}-{device}", "cache"), "--yes",
                "--image_size", "128", "--extractor", ext, "--device", device])
            log(f"[eval] {tag} on {device}: eval.main {time.perf_counter() - t0:.2f} s, {got[device]}")
        worst = {}  # IS: absolute; FID and KID: relative (KID to its mean)
        for k, want in got["cpu"].items():
            if k == "feature_extractor":
                continue
            d = abs(got["cuda"][k] - want)
            if not k.startswith("inception_score"):
                d /= abs(got["cpu"]["kernel_inception_distance_mean" if "kernel" in k else k])
            worst[k] = d
        ok = all(np.isfinite(got["cuda"][k]) and v <= (
            EVAL_IS_ABS if k.startswith("inception_score") else EVAL_REL) for k, v in worst.items())
        extractor = metrics.get_extractor(ext, device="cuda")
        images = np.concatenate([fake, real]).astype(np.float32) / 255.0
        extractor(images[:64])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        extractor(images)
        torch.cuda.synchronize()
        rate = len(images) / (time.perf_counter() - t0)
        log(f"[eval] {tag}: card vs CPU, FID and KID relative (KID to its mean), IS absolute: "
            + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
            + f" (<= {EVAL_REL}; IS <= {EVAL_IS_ABS}); extractor on the card "
            f"{rate:.1f} images/s at 128² (batch 64, {len(images)} images)")
        if not ok:
            raise RuntimeError(f"eval with {tag} on the card disagrees with the CPU")


def profile_sr_step(views=2, calls=2):
    """Where one guided SR sampling step goes (``model_inference`` with CFG
    over ``views`` views: a forward at batch ``2 * views``, as ``[SR]`` runs
    it): CUDA events over 5 steps, then ``calls`` steps under torch.profiler
    for the device's kernel time, its idle share and the top kernels."""
    import torch

    from ivid_tpu_torch import timing
    from ivid_tpu_torch.config import Config
    from ivid_tpu_torch.sample import build_model

    dev = torch.device("cuda")
    fw = build_model(Config.load(SR_CFG), "random", 0, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((views, 256, 256, 4), generator=gen, device=dev)
    cond = {"y": torch.randn((views, 128, 128, 4), generator=gen, device=dev),
            "classes": torch.arange(views, device=dev)}
    t = torch.full((views,), 500, device=dev)

    @torch.no_grad()
    def step():
        return fw.model_inference(None, x, t, cond, 3.0)

    ms = timing.host_ms(step, reps=5, warmup=2)
    # The step's operations: what torch.utils.flop_counter counts (the
    # convolutions and matmuls), plus K1's 4·B·H·T²·64 at each site it runs.
    from torch.utils.flop_counter import FlopCounterMode

    from ivid_tpu_torch.models.adm import AttentionBlock

    k1_flops = []

    def count_k1(mod, args):
        b, _, h, w = args[0].shape
        if mod.uses_kernel(h * w):
            k1_flops.append(4 * b * mod.heads * (h * w) ** 2 * 64)

    hooks = [m.register_forward_pre_hook(count_k1) for m in fw.model.modules()
             if isinstance(m, AttentionBlock)]
    counter = FlopCounterMode(display=False)
    try:
        with counter:
            step()
    finally:
        for h in hooks:
            h.remove()
    tflop = (counter.get_total_flops() + sum(k1_flops)) / 1e12
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    rows = []
    for _ in range(2):  # a session may record no device activity (timing.py)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                step()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / calls
        rows = timing.device_rows(prof, calls)
        if rows:
            break
    if not rows:
        log(f"[SR profile] guided step at {views} views: {tflop:.3f} TFLOP, {ms:.2f} ms (CUDA "
            f"events); device kernel time and top kernels: not measured (no device activity "
            f"recorded)")
        return
    kernel_ms = sum(r[0] for r in rows)
    log(f"[SR profile] guided step at {views} views (forward at batch {2 * views}): {tflop:.3f} "
        f"TFLOP ({len(k1_flops)} K1 sites), {ms:.2f} ms (CUDA events, 5 steps), "
        f"{tflop * 1e3 / ms:.1f} TFLOP/s; profiled: {sum(r[1] for r in rows)} kernels, {kernel_ms:.2f} "
        f"ms of device kernel time per step ({tflop * 1e3 / kernel_ms:.1f} TFLOP/s), idle share "
        f"{1 - kernel_ms / wall:.3f} of the profiled wall ({wall:.2f} ms), "
        f"{1 - kernel_ms / ms:.3f} of the unprofiled step")
    for k_ms, n, name in rows[:10]:
        log(f"[SR profile]   {k_ms:9.3f} ms  x{n:<5d} {name[:110]}")


def phase_sr_train(sites, steps=3):
    """``train.main`` with the SR config (SuperResTrainer, bf16 torso, batch
    4 with ``batch_split`` 2 as the config says), its dataset section swapped
    to SyntheticRGBDSR 256/128 with 1000 classes, finetuned from a 4-input
    checkpoint of the same widths written here; ``steps`` AdamW steps. K1
    (with the log-sum-exp) and K4 at ``sites`` per micro-batch."""
    import numpy as np
    import torch

    from ivid_tpu_torch import train
    from ivid_tpu_torch.config import Config, build_backbone
    from ivid_tpu_torch.models.adm import randomize_parameters
    from ivid_tpu_torch.training import checkpoint as ckpt_io
    from ivid_tpu_torch.training.trainer import StepRecord

    with open(SR_CFG) as f:
        cfg = json.load(f)
    args = cfg["dataset"]["args"]
    cfg["dataset"] = {"name": "SyntheticRGBDSR", "args": {
        "image_size": args["image_size"], "image_size_lr": args["image_size_lr"],
        "normalize": args["normalize"], "normalize_depth": args["normalize_depth"],
        "prepocess_depth": args["prepocess_depth"], "near": args["near"], "far": args["far"],
        "num_classes": 1000, "length": 64}}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_sr_train_")
    src_cfg = Config.load(SR_CFG)
    src_cfg.backbone["args"]["in_channels"] = 4
    src = randomize_parameters(build_backbone(src_cfg), seed=3).state_dict()
    ckpt = os.path.join(tmp, "uncond_4ch.pt")
    torch.save(src, ckpt)
    cfg["trainer"]["args"].update(max_steps=steps, i_log=steps, i_save=10 ** 9,
                                  i_sample=10 ** 9, sample_at_init=False, finetune_ckpt=ckpt)
    batch, split = cfg["trainer"]["args"]["batch_size_per_gpu"], cfg["trainer"]["args"]["batch_split"]
    path = os.path.join(tmp, os.path.basename(SR_CFG))
    with open(path, "w") as f:
        json.dump(cfg, f)
    argv = ["--config", path, "--output_dir", os.path.join(tmp, "out"), "--device", "cuda"]
    # The finetuned start, before any step: the checkpoint's weights, the
    # padded input channels zero.
    start = train.main(argv + ["--max_steps", "0"])
    w = start.model.state_dict()[ckpt_io.IN_CONV].cpu()
    padded = (w.shape[1] == 8 and torch.equal(w[:, :4], src[ckpt_io.IN_CONV])
              and not w[:, 4:].any()
              and all(torch.equal(v.cpu(), src[k]) for k, v in start.model.state_dict().items()
                      if k != ckpt_io.IN_CONV))
    del start
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
    step_ms = [round(m["step"], 3) for m in rec.stage_ms()]
    finite = all(torch.isfinite(p).all() for p in tr.model.parameters())
    moved = not tr.model.state_dict()[ckpt_io.IN_CONV][:, 4:].eq(0).all().item()
    per_step = sites * split
    log(f"[SR train] train.main, {os.path.basename(SR_CFG)} (SuperResTrainer, bf16 torso), "
        f"SyntheticRGBDSR 256/128 with 1000 classes, batch {batch} (batch_split {split}), "
        f"finetuned from a 4-input checkpoint (start: padded inputs zero, the rest the "
        f"checkpoint's: {padded}), {steps} AdamW steps: wall {wall:.2f} s; losses "
        f"{np.round(losses, 5).tolist()}; ms per step (CUDA events) {step_ms}; peak memory "
        f"{peak:.2f} GiB; padded inputs trained {moved}; launches {counts} (K1 and K4 "
        f"{per_step} per step: {sites} sites x {split} micro-batches; GN and RES 0)")
    if not (padded and moved and np.isfinite(losses).all() and len(losses) == steps and finite
            and counts["K1"] == counts["K4"] == per_step * steps
            and counts["K1 f32"] == counts["K4 f32"] == counts["GN"] == counts["RES"] == 0
            and all(counts[k] == 0 for k in ("K2", "K3", "K5", "K6"))):
        raise RuntimeError("the SR training run failed its checks")
    del tr
    return counts, peak


def phase_group_norm():
    """``[group norm]``: the GroupNorm kernel (``ops/group_norm.py``,
    ``csrc/group_norm.cu``) against GroupNorm, scale-shift and SiLU computed
    in f32 on the same input (``GN_REL``, ``GN_ABS``), at the SR chunk's
    concatenated input [54, 256, 256, 256] bf16 with the scale-shift, its
    residual blocks' output norm [54, 128, 256, 256] bf16 with the
    scale-shift and the input bias (the first convolution's, added in f32;
    timed beside the same launch without it), the f32 flagship's [16, 256,
    128, 128] and ``b1``'s [1, 512, 8, 8] bf16, each also with its input
    offset by 1e3 (std 1); the composition's own distance
    (``ops.group_norm.plain``, which rounds to bf16 between its steps) beside
    it; device ms of the kernel, its bytes bound (input read once, output
    written once), the composition and ``F.group_norm`` + SiLU on the input
    as it is (``library_ms``). Then the full-width SR UNet at batch 2 (a
    class and the null class): the graphed forward and the eager one with
    the kernel (87 launches a forward each, eager and replayed, 35 of them
    with an input bias beside 35 residual launches) against the eager
    composition (a grad-enabled call, which launches none), and each against
    the f32 forward (TF32 off; the composition too)."""
    import torch
    import torch.nn.functional as F

    from ivid_tpu_torch.config import Config, build_backbone
    from ivid_tpu_torch.models.adm import randomize_parameters
    from ivid_tpu_torch.ops import group_norm as gn

    bf16, f32 = torch.bfloat16, torch.float32
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows, failures = [], []
    for tag, shape, dtype, scale_shift, biased in (
            ("SR concat", (54, 256, 256, 256), bf16, True, False),
            ("SR output norm", (54, 128, 256, 256), bf16, True, True),
            ("in128 uncond", (16, 256, 128, 128), f32, False, False),
            ("b1 8x8", (1, 512, 8, 8), bf16, False, False)):
        n, c = shape[:2]
        w = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
        b = 0.1 * torch.randn(c, generator=gen, device="cuda")
        emb = 0.3 * torch.randn((n, 2 * c), generator=gen, device="cuda") if scale_shift else None
        in_bias = 0.5 * torch.randn(c, generator=gen, device="cuda") if biased else None
        for offset in (0.0, 1e3):
            x = (torch.randn(shape, generator=gen, device="cuda") + offset).to(dtype)
            with torch.no_grad():
                got = gn.group_norm_act(x, w, b, 32, 1e-5, act=True, emb=emb, in_bias=in_bias)
                x32 = x.float() if in_bias is None else x.float() + in_bias[:, None, None]
                want = F.group_norm(x32, 32, w, b, 1e-5)
                del x32
                if emb is not None:
                    want = want * (1 + emb[:, :c, None, None]) + emb[:, c:, None, None]
                want = F.silu(want)
                err = ((got.float() - want).abs() - GN_REL[str(dtype)[6:]] * want.abs()).max()
                plain = gn.plain(x, w, b, 32, 1e-5, act=True, emb=emb, in_bias=in_bias)
                plain_err = (plain.float() - want).abs().max().item()
                kernel_err = (got.float() - want).abs().max().item()
                ok = err.item() <= GN_ABS[offset] and bool(torch.isfinite(got).all())
                del got, want, plain
            row = {"shape": list(shape), "dtype": str(dtype)[6:], "scale_shift": scale_shift,
                   "input_bias": biased, "offset": offset, "max_err": kernel_err,
                   "plain_max_err": plain_err, "ok": ok}
            if offset == 0.0:
                def kernel(in_bias=in_bias):
                    return gn.group_norm_act(x, w, b, 32, 1e-5, act=True, emb=emb,
                                             in_bias=in_bias)

                def library():
                    y = F.group_norm(x, 32, w.to(dtype), b.to(dtype), 1e-5)
                    if emb is not None:
                        y = y * (1 + emb[:, :c, None, None].to(dtype)) + emb[:, c:, None, None].to(dtype)
                    return F.silu(y)

                with torch.no_grad():
                    row["ms"], row["host_ms"] = timed(kernel, match="gn_act_")
                    if biased:
                        row["no_bias_ms"] = timed(lambda: kernel(None), match="gn_act_")[0]
                    row["plain_ms"] = timed(lambda: gn.plain(x, w, b, 32, 1e-5, act=True,
                                                             emb=emb, in_bias=in_bias))[0]
                    row["library_ms"] = timed(library)[0]
                row["bound_ms"] = 1e3 * x.numel() * 2 * x.element_size() / PEAK_BYTES
            del x
            torch.cuda.empty_cache()
            log(f"[group norm] {tag} {list(shape)} {row['dtype']}"
                f"{' scale-shift' if scale_shift else ''}{' input bias' if biased else ''}, "
                f"input offset {offset:g}: max|err| "
                f"{row['max_err']:.3e} against f32 (<= {GN_REL[row['dtype']]:.3g}|y| + "
                f"{GN_ABS[offset]:g}; the composition {row['plain_max_err']:.3e}) ok {ok}"
                + (f"; kernel {row['ms']:.4f} ms device ({row['host_ms']:.4f} host), bound "
                   f"{row['bound_ms']:.4f} ms ({100 * row['bound_ms'] / row['ms']:.1f}%), "
                   f"composition {row['plain_ms']:.4f}, library {row['library_ms']:.4f}"
                   + (f", without the input bias {row['no_bias_ms']:.4f}"
                      if "no_bias_ms" in row else "")
                   if "ms" in row else ""))
            rows.append(row)
            if not ok:
                failures.append(f"{tag} offset {offset:g}")

    # The whole SR forward: graphed and eager with the kernel, the eager
    # composition, and the f32 forward.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = Config.load(SR_CFG)
    model = randomize_parameters(build_backbone(cfg), seed=0).to("cuda").eval()
    x = torch.randn((2, 256, 256, 8), generator=gen, device="cuda")
    t, classes = torch.tensor([500, 500], device="cuda"), torch.tensor([7, -1], device="cuda")
    launches = {}
    outs = {}
    for mode in ("graphed", "replayed", "eager", "composition"):
        before = read_counts()
        model.train(mode == "eager")
        with torch.set_grad_enabled(mode == "composition"):
            outs[mode] = model(x, t, classes).detach()
        since = counts_since(before)
        launches[mode] = [since[k] for k in ("GN", "GN bias", "RES")]
    f32_model = build_backbone(cfg, dtype=f32)
    f32_model.load_state_dict(model.state_dict())
    ref = f32_model.to("cuda")(x, t, classes).detach()  # the composition, in f32
    del f32_model, model

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    gap = {k: rel(v, ref) for k, v in outs.items()}
    diff = rel(outs["replayed"], outs["composition"])
    same = torch.equal(outs["replayed"], outs["eager"]) and torch.equal(outs["graphed"],
                                                                       outs["eager"])
    ok = (diff <= SR_BF16_REL and same and gap["replayed"] <= GN_SR_GAP_RATIO * gap["composition"]
          and launches == {"graphed": [87, 35, 35], "replayed": [87, 35, 35],
                           "eager": [87, 35, 35], "composition": [0, 0, 0]})
    log(f"[group norm] SR UNet 256², batch 2: GN, GN bias and RES launches a forward {launches} "
        f"([87, 35, 35] graphed, replayed and eager; none in the composition); replayed vs "
        f"eager (the kernel) bit-equal {same}; replayed vs the eager composition rel L2 "
        f"{diff:.3e} (<= {SR_BF16_REL}); rel L2 to the f32 forward: kernel "
        f"{gap['replayed']:.3e}, composition {gap['composition']:.3e} (kernel <= "
        f"{GN_SR_GAP_RATIO} x composition)")
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    del outs, ref
    torch.cuda.empty_cache()
    if not ok:
        failures.append("SR forward")
    if failures:
        raise RuntimeError(f"[group norm] failed its checks: {failures}")
    return {"name": "gn_act", "replaces": "none (XLA's GroupNorm in the JAX package)",
            "shapes": rows, "launches_per_forward": launches}


# The residual sums of the benchmarked models (shape, type): the SR model at
# the 27-view chunk (a forward of 54) at each level, the flagship uncond model
# in f32 and its cond model in bf16 at batch 16, the single-category models at
# batch 1; the first, the f32 one and the last are timed.
RES_SHAPES = (
    ((54, 128, 256, 256), "bf16"), ((54, 128, 128, 128), "bf16"), ((54, 256, 64, 64), "bf16"),
    ((54, 384, 32, 32), "bf16"), ((54, 512, 16, 16), "bf16"), ((16, 256, 128, 128), "f32"),
    ((16, 512, 32, 32), "f32"), ((16, 1024, 8, 8), "f32"), ((16, 256, 128, 128), "bf16"),
    ((1, 128, 128, 128), "bf16"), ((1, 512, 8, 8), "bf16"))
RES_TIMED = ((54, 128, 256, 256), (16, 256, 128, 128), (1, 512, 8, 8))


def phase_residual():
    """``[residual]``: the residual sum with the convolutions' biases
    (``ops/bias_residual.py``, ``csrc/bias_residual.cu``) against its plain
    version, bit for bit, at every shape of RES_SHAPES with an identity skip
    (one bias) and a 1x1 skip (two); a channels-last input raises. At the
    timed shapes: device ms of the kernel (1x1 skip), its bytes bound (two
    reads and a write), and the parent's composition (each convolution's
    bias in a broadcast pass, then the sum)."""
    import torch

    from ivid_tpu_torch.ops import bias_residual as res

    gen = torch.Generator(device="cuda").manual_seed(13)
    rows, failures = [], []
    for shape, name in RES_SHAPES:
        dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[name]
        skip = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        conv = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        b = 0.5 * torch.randn(shape[1], generator=gen, device="cuda")
        b2 = 0.5 * torch.randn(shape[1], generator=gen, device="cuda")
        row = {"shape": list(shape), "dtype": name}
        with torch.no_grad():
            for tag, second in (("identity", None), ("1x1", b2)):
                got = res.bias_residual(skip, conv, b, second)
                want = res.plain(skip, conv, b, second)
                row[f"equal_{tag}"] = bool(torch.equal(got, want))
                row[f"max_diff_{tag}"] = (got.float() - want.float()).abs().max().item()
                del got, want
            if shape in RES_TIMED:
                def composition():
                    b_skip, b_conv = b2.to(dtype)[:, None, None], b.to(dtype)[:, None, None]
                    return (skip + b_skip) + (conv + b_conv)

                row["ms"], row["host_ms"] = timed(lambda: res.bias_residual(skip, conv, b, b2),
                                                  match="bias_residual_")
                row["composition_ms"] = timed(composition)[0]
                row["bound_ms"] = 1e3 * 3 * skip.numel() * skip.element_size() / PEAK_BYTES
        ok = row["equal_identity"] and row["equal_1x1"]
        log(f"[residual] {shape} {name}: bit-equal to the plain version, identity skip "
            f"{row['equal_identity']} (max |diff| {row['max_diff_identity']:.3e}), 1x1 skip "
            f"{row['equal_1x1']} ({row['max_diff_1x1']:.3e})"
            + (f"; kernel {row['ms']:.4f} ms device ({row['host_ms']:.4f} host), bound "
               f"{row['bound_ms']:.4f} ms ({100 * row['bound_ms'] / row['ms']:.1f}%), the "
               f"composition {row['composition_ms']:.4f}" if "ms" in row else ""))
        rows.append(row)
        if not ok:
            failures.append(f"{shape} {name}")
        del skip, conv
        torch.cuda.empty_cache()
    x = torch.zeros((2, 16, 8, 8), dtype=torch.bfloat16, device="cuda")
    try:
        with torch.no_grad():
            res.bias_residual(x.to(memory_format=torch.channels_last), x,
                              torch.zeros(16, device="cuda"))
        failures.append("a channels-last input did not raise")
    except ValueError:
        pass
    if failures:
        raise RuntimeError(f"[residual] failed its checks: {failures}")
    return {"name": "bias_residual", "replaces": "none (XLA fuses the convolutions' biases)",
            "shapes": rows}


def phase_unet():
    import numpy as np
    import torch

    from ivid_tpu_torch.config import Config, build_backbone
    from ivid_tpu_torch.models.adm import randomize_parameters

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
    before = read_counts()
    with torch.no_grad():
        want = cpu_model(x, t)
        got = gpu_model(x.cuda(), t.cuda()).cpu()
    sites = counts_since(before)["K1"]
    rel = ((got - want).norm() / want.norm()).item()
    log(f"[unet] full-width single-category model, batch 2, f32: card (K1 at {sites} "
        f"attention sites) vs CPU plain path: rel L2 {rel:.3e} (<= {UNET_REL}), "
        f"output std {want.std().item():.3f}, finite {bool(torch.isfinite(got).all())}")
    if not (rel <= UNET_REL and torch.isfinite(got).all() and sites == 5):
        raise RuntimeError("UNet on the card disagrees with the CPU plain path")
    torch.backends.cudnn.allow_tf32 = True


def phase_unet_graph():
    """``[unet graph]``: the UNet's inference forward replayed as a CUDA
    graph (``models/adm.py``, ``InferenceGraphs``) against the eager
    forward of the same call, on the two single-category models at batch 1
    and the two flagship models 16 wide with classes (8 labels and 8 null),
    PyTorch's default precision settings, seeded weights: three calls each,
    the first of them a warm-up and capture, bit-equal to eager with the
    same K1 launches; the memory the graph reserves, the first call's ms,
    and host ms per forward, eager and replayed. Then a
    3-step ``ddim_sample`` graphed against eager (the single-category uncond
    model at batch 1, the flagship CFG model at batch 8), an assigned reload
    (drops the graphs), an in-place reload (keeps them and replays the new
    weights), and calls that stay eager: grad-enabled, and a UNet holding a
    layer of ``parallel/tensor.py`` (whose block adds its own biases, so it
    is held bit-equal to the plain layers' forward with that one block kept
    from folding). The eager side runs the same models in train mode (the
    forward is the same; train mode is not graphed)."""
    import torch

    from ivid_tpu_torch.config import Config, build_backbone, build_framework_from_config
    from ivid_tpu_torch.diffusion import samplers
    from ivid_tpu_torch.diffusion.noise import KeyedNoise
    from ivid_tpu_torch.models.adm import randomize_parameters
    from ivid_tpu_torch.parallel import tensor as tp

    def call(model, args, graphed):
        """The output and the kernel launches of one no-grad call."""
        model.train(not graphed)
        before = read_counts()
        with torch.no_grad():
            out = model(*args)
        return out, counts_since(before)

    def compare(got, want):
        return torch.equal(got, want), (got - want).abs().max().item()

    failures = []
    models = {}
    for tag, path, batch in (("sc128 uncond", UNCOND_CFG, 1), ("sc128 cond", COND_CFG, 1),
                             ("in128 uncond", FLAGSHIP_UNCOND, 16),
                             ("in128 cond", FLAGSHIP_COND, 16)):
        cfg = Config.load(path)
        model = randomize_parameters(build_backbone(cfg), seed=0).to("cuda")
        gen = torch.Generator(device="cuda").manual_seed(1)
        s = model.image_size

        def inputs():
            x = torch.randn((batch, s, s, model.in_channels), generator=gen, device="cuda")
            t = torch.randint(0, 1000, (batch,), generator=gen, device="cuda")
            if not model.num_classes:
                return x, t, None
            c = torch.randint(0, model.num_classes, (batch // 2,), generator=gen, device="cuda")
            return x, t, torch.cat([c, -torch.ones_like(c)])

        calls = [inputs() for _ in range(3)]
        eager = [call(model, a, False) for a in calls]
        torch.cuda.empty_cache()
        mem0 = torch.cuda.memory_reserved()
        t0 = time.perf_counter()
        graphed = [call(model, calls[0], True)]
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        graphed += [call(model, a, True) for a in calls[1:]]
        torch.cuda.empty_cache()
        pool_gib = (torch.cuda.memory_reserved() - mem0) / 2 ** 30
        same = [compare(g[0], e[0]) for g, e in zip(graphed, eager)]
        counts_equal = all(g[1] == e[1] for g, e in zip(graphed, eager))
        with torch.no_grad():
            model.eval()
            graph_ms = cuda_time_ms(lambda: model(*calls[0]), reps=10)
            model.train()
            eager_ms = cuda_time_ms(lambda: model(*calls[0]), reps=10)
        model.eval()
        # A grad-enabled call stays eager (and adds no graph).
        grad_out = model(*calls[1])
        grad_eager = len(model.graphs.entries) == 1 and grad_out.requires_grad
        log(f"[unet graph] {tag}: {tuple(calls[0][0].shape)}, classes "
            f"{calls[0][2] is not None}: replayed vs eager bit-equal {[e for e, _ in same]} "
            f"(largest |diff| {max(d for _, d in same):.3e}); K1 launches per call eager "
            f"{[e[1]['K1'] for e in eager]}, graphed {[g[1]['K1'] for g in graphed]} (every "
            f"kernel's count equal {counts_equal}); graphs {len(model.graphs.entries)}, memory reserved for them "
            f"{pool_gib:.3f} GiB; the first call (warm-up and capture) {first_ms:.1f} ms; host "
            f"ms per forward eager {eager_ms:.2f}, replayed {graph_ms:.2f}; grad-enabled call "
            f"eager {grad_eager}")
        if not (all(e for e, _ in same) and counts_equal and grad_eager):
            failures.append(tag)
        del grad_out
        models[tag] = (cfg, model, calls)

    # A 3-step DDIM chain, graphed against eager.
    for tag, batch, cond_fn in (("sc128 uncond", 1, None),
                                ("in128 uncond", 8, lambda: {"classes": torch.arange(
                                    8, device="cuda") * 101 % 1000})):
        cfg, model, _ = models[tag]
        fw = build_framework_from_config(cfg, model, device=torch.device("cuda"))
        outs, counts = [], []
        for graphed in (False, True):
            model.train(not graphed)
            before = read_counts()
            outs.append(samplers.ddim_sample(
                fw, KeyedNoise.seeded(3, "cuda"), num=batch, image_size=128,
                cond=cond_fn() if cond_fn else None, guidance=3.0 if cond_fn else 0.0,
                steps=3)["samples"])
            counts.append(counts_since(before))
        equal, diff = compare(outs[1], outs[0])
        log(f"[unet graph] {tag} ddim_sample 3 steps, batch {batch}: graphed vs eager "
            f"bit-equal {equal} (largest |diff| {diff:.3e}); launches eager {counts[0]}, "
            f"graphed {counts[1]}")
        if not (equal and counts[0] == counts[1]):
            failures.append(f"{tag} ddim")
    for tag in ("in128 uncond", "in128 cond", "sc128 cond"):
        del models[tag]

    # Reloads and a tensor-parallel layer, on the sc128 uncond model.
    cfg, model, calls = models.pop("sc128 uncond")
    model.eval()
    with torch.no_grad():
        model.load_state_dict({k: v.clone() for k, v in model.state_dict().items()},
                              assign=True)
        dropped = not model.graphs.entries
        call(model, calls[0], True)  # the capture
        again = compare(call(model, calls[0], True)[0], call(model, calls[0], False)[0])[0]
        model.load_state_dict(randomize_parameters(build_backbone(cfg), seed=5).state_dict())
        kept = len(model.graphs.entries) == 1
        new_eager = call(model, calls[0], False)[0]
        new_graph = call(model, calls[0], True)[0]
        in_place = kept and len(model.graphs.entries) == 1 and torch.equal(new_graph, new_eager)
        # The block with the tensor-parallel layer adds its convolutions'
        # biases itself, where a plain block leaves them to the kernels: the
        # reference is the plain model with that one block kept from folding.
        block = model.input_blocks[1][0]
        block.folds_biases = lambda *a: False
        tp_ref = call(model, calls[0], False)[0]
        del block.folds_biases
        conv = block.in_layers[2]
        col = tp.ColumnConv2d(conv.in_channels, conv.out_channels, 3, padding=1).to("cuda")
        col.load_state_dict(conv.state_dict())
        block.in_layers[2] = col
        model.graphs.clear()
        tp_out = call(model, calls[0], True)[0]
        tp_eager = not model.graphs.entries and torch.equal(tp_out, tp_ref)
    log(f"[unet graph] sc128 uncond: assigned reload drops the graphs {dropped}, the next "
        f"replay bit-equal {again}; in-place reload keeps them and replays the new weights "
        f"bit-equal {in_place}; with a tensor-parallel layer eager and bit-equal to the plain "
        f"layers' forward with its block unfolded {tp_eager}")
    if not (dropped and again and in_place and tp_eager):
        failures.append("reloads / tensor parallelism")
    del model, models
    torch.cuda.empty_cache()
    if failures:
        raise RuntimeError(f"[unet graph] failed its checks: {failures}")


def reset_counts():
    from ivid_tpu_torch import cuda_build
    from ivid_tpu_torch.ops import raster_dense

    cuda_build.launches.clear()
    raster_dense.sync_s = 0.0


def read_counts():
    """The kernel launches counted so far, by key of COUNTED (0 for a kernel
    that has not launched)."""
    from ivid_tpu_torch import cuda_build

    return {k: cuda_build.launches[k] for k in COUNTED}


def folded(counts, forwards):
    """Whether ``counts`` hold ``forwards`` inference forwards' norm and
    residual launches: GN_SITES GroupNorm launches a forward, RES_SITES of
    them with an input bias, and RES_SITES residual launches."""
    return (counts["GN"] == GN_SITES * forwards
            and counts["GN bias"] == counts["RES"] == RES_SITES * forwards)


def counts_since(before):
    """The launches since ``before`` (a :func:`read_counts`), by key."""
    return {k: v - before[k] for k, v in read_counts().items()}


def k1_widths():
    """K1's launches counted so far by the width 3C of the qkv it read."""
    from ivid_tpu_torch import cuda_build

    return {key[1]: n for key, n in cuda_build.launches.items()
            if isinstance(key, tuple) and key[0] == "K1"}


def phase_chain(device="cuda"):
    """A small 3-view chain (32² f32 UNets, attention at T=1024 so K1 runs,
    r=96 aggregation through K2) on ``device`` against the same weights and
    noise on the CPU plain path."""
    import numpy as np
    import torch

    from ivid_tpu_torch.host_noise import HostNoise
    from ivid_tpu_torch.diffusion.frameworks import build_framework
    from ivid_tpu_torch.inference.pipeline import ScenePipeline
    from ivid_tpu_torch.inference.viewsets import build_viewset, canonical_view
    from ivid_tpu_torch.models import adm

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

    before = read_counts()
    got, got_mask = run(torch.device(device))
    counts = counts_since(before)
    k1, k2 = counts["K1"], counts["K2"]
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
    from ivid_tpu_torch.ops import raster_dense

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
        f"launches: K1 {k1} (>= {5 * 1050}), K2 {k2} (>= 1, each with its bins: "
        f"{counts['K2 bins']}); GN {counts['GN']}, RES {counts['RES']} ({GN_SITES}, "
        f"{RES_SITES} a forward of 5 K1 sites: {GN_SITES * k1 // 5}, {RES_SITES * k1 // 5}); "
        f"host ms waiting for the bins' length "
        f"{raster_dense.sync_s * 1e3:.4f} in all")
    if not (np.isfinite(samples).all() and samples.shape == (2, 2, 128, 128, 4)
            and len(scenes) == 2 and len(images) == 2 and k1 >= 5 * 1050 and k2 >= 1
            and k1 % 5 == 0 and folded(counts, k1 // 5)
            and counts["K2 bins"] == k2 and counts["K3"] == counts["K4"] == counts["K5"] == counts["K6"] == 0):
        raise RuntimeError("pipeline run failed its checks")
    return counts


def ckpt_sampling(tmp, paths, pt_path, device="cuda"):
    """``sample.main`` on the JAX-layout files; its first UNet forward held
    to the same forward on the ``.pt`` file of the same weights."""
    import numpy as np
    import torch

    from ivid_tpu_torch import sample
    from ivid_tpu_torch.config import Config
    from ivid_tpu_torch.models.adm import AdmUnet2d

    first = []

    def keep_first(module, args, output):
        if isinstance(module, AdmUnet2d) and not first:
            first.append((tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args),
                          output.detach().clone()))

    argv = ["--config_uncond", UNCOND_CFG, "--config_cond", COND_CFG,
            "--ckpt_uncond", paths["uncond"], "--ckpt_cond", paths["cond"],
            "--output_dir", os.path.join(tmp, "samples"), "--seeds", "0-1", "--viewset", "random",
            "--batchsize", "2", "--steps_uncond", "50", "--steps_cond", "10", "--device", device]
    handle = torch.nn.modules.module.register_module_forward_hook(keep_first)
    reset_counts()
    t0 = time.perf_counter()
    try:
        result = sample.main(argv)
    finally:
        handle.remove()
    wall = time.perf_counter() - t0
    counts = read_counts()
    samples = np.concatenate(result["samples"], axis=0)
    args, want = first[0]
    with torch.no_grad():
        got = sample.build_model(Config.load(UNCOND_CFG), pt_path, 0, torch.device(device)).model(*args)
    rel = float((got - want).norm() / want.norm())
    log(f"[ckpt migrate] sample.main on the .msgpack pair, random viewset, batch 2, DDIM 50 + "
        f"guided DDIM 10: wall {wall:.2f} s; samples {samples.shape} finite "
        f"{bool(np.isfinite(samples).all())}; launches {counts}; first UNet forward vs the .pt "
        f"weights: rel L2 {rel:.3e} (<= {CKPT_FORWARD_REL})")
    if not (np.isfinite(samples).all() and samples.shape == (2, 2, 128, 128, 4)
            and counts["K1"] >= 5 * 60 and counts["K2"] >= 1 and rel <= CKPT_FORWARD_REL
            and counts["K1"] % 5 == 0 and folded(counts, counts["K1"] // 5)):
        raise RuntimeError("[ckpt migrate] sampling from the .msgpack files failed its checks")
    return counts


def ckpt_resume(tmp, state, arch_args, device="cuda"):
    """A JAX-layout run directory of the cond model at step 3 (model, EMA,
    misc with seeded AdamW moments), resumed by ``train.main``: loaded bit
    for bit, then 3 profiled steps with ``--profile_dir``."""
    import torch

    from ivid_tpu_torch import train
    from ivid_tpu_torch.models.convert import state_dict_to_flax
    from ivid_tpu_torch.training import checkpoint as ckpt_io
    from ivid_tpu_torch.training import flax_msgpack
    from ivid_tpu_torch.training.trainer import StepRecord

    with open(COND_CFG) as f:
        cfg = json.load(f)
    cfg["dataset"] = {"name": "SyntheticRGBDWarp",
                      "args": dict(cfg["dataset"]["args"], length=64)}
    cfg["trainer"]["args"].update(i_save=10 ** 9, i_log=10 ** 9, i_sample=10 ** 9,
                                  sample_at_init=False)
    rate = cfg["trainer"]["args"]["ema_rate"][0]
    path = os.path.join(tmp, os.path.basename(COND_CFG))
    with open(path, "w") as f:
        json.dump(cfg, f)
    run = os.path.join(tmp, "jax_run")
    gen = torch.Generator().manual_seed(5)
    ema = {k: v + 1e-3 * torch.randn(v.shape, generator=gen) for k, v in state.items()}
    mu = {k: 1e-3 * torch.randn(v.shape, generator=gen) for k, v in state.items()}
    nu = {k: 1e-6 * torch.rand(v.shape, generator=gen) for k, v in state.items()}
    os.makedirs(os.path.join(run, "ckpts"))
    flax_msgpack.write(ckpt_io.ema_path(run, rate, 3, ckpt_io.MSGPACK),
                       state_dict_to_flax(ema, **arch_args))
    flax_msgpack.write(ckpt_io.misc_path(run, 3, ckpt_io.MSGPACK), ckpt_io.jax_misc(
        step=3, adam_step=3, exp_avg=mu, exp_avg_sq=nu, rng=[0, 42], loader_pos=[0, 3],
        ema_rates=[rate], arch_args=arch_args))
    flax_msgpack.write(ckpt_io.model_path(run, 3, ckpt_io.MSGPACK),
                       state_dict_to_flax(state, **arch_args))
    argv = ["--config", path, "--output_dir", os.path.join(tmp, "out"), "--ckpt", "latest",
            "--load_dir", run, "--device", device]

    loaded = train.main(argv + ["--max_steps", "3"])
    opt = [loaded.optimizer.state[p] for p in loaded.params.values()]
    names = list(loaded.params)
    same = (loaded.step == 3 and loaded._loader_obj.position == (0, 3)
            and all(float(o["step"]) == 3 for o in opt)
            and all(torch.equal(o["exp_avg"].cpu(), mu[k]) and torch.equal(o["exp_avg_sq"].cpu(), nu[k])
                    for k, o in zip(names, opt))
            and all(torch.equal(v.cpu(), ema[k]) for k, v in loaded.ema_params[0].items())
            and all(torch.equal(v.cpu(), state[k]) for k, v in loaded.model.state_dict().items()))
    n_params = sum(p.numel() for p in loaded.params.values())
    del loaded, opt
    log(f"[ckpt migrate] train.main --ckpt latest on the JAX-layout run: step 3, model, EMA "
        f"{rate}, exp_avg, exp_avg_sq, AdamW step and loader cursor bit-equal to the written "
        f"ones: {same}")
    if not same:
        raise RuntimeError("[ckpt migrate] the resumed trainer's state differs from the files")

    prof = os.path.join(tmp, "profile")
    rec = StepRecord()
    reset_counts()
    t0 = time.perf_counter()
    tr = train.main(argv + ["--max_steps", "5", "--profile_dir", prof], record=rec)
    if device == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    losses = [float(x) for x in rec.losses]
    traces = sorted(os.listdir(prof))
    with open(os.path.join(prof, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    run_dir = os.path.join(tmp, "out", os.path.splitext(os.path.basename(COND_CFG))[0])
    with open(os.path.join(run_dir, "model_summary.txt")) as f:
        summary = f.read()
    total = next(int(line.split()[2].replace(",", "")) for line in summary.splitlines()
                 if line.startswith("Total params: "))
    flops = next(line for line in summary.splitlines() if line.startswith("Forward FLOPs"))
    log(f"[ckpt migrate] train.main --max_steps 5 --profile_dir: wall {wall:.2f} s; resumed at 3, "
        f"now at step {tr.step} after {len(losses)} profiled steps, losses "
        f"{[round(x, 5) for x in losses]}; launches {counts}; trace {traces}: {len(events)} "
        f"events, {kernels} CUDA kernel events; model_summary.txt total {total:,} "
        f"(model {n_params:,}); {flops}")
    if not (tr.step == 6 and len(losses) == 3 and all(math.isfinite(x) for x in losses)
            and len(traces) == 1 and total == n_params and counts["K1"] == 5 * 3
            and counts["K4"] == 5 * 3 and counts["K3"] == 2 * 3
            and counts["GN"] == counts["RES"] == 0):
        raise RuntimeError("[ckpt migrate] the resumed, profiled run failed its checks")
    return counts


def phase_ckpt_migrate(device="cuda"):
    """The full-width single-category pair written as the JAX package's
    ``model_step0000000.msgpack`` files (seeded weights) and read back bit
    for bit; sampling from them (:func:`ckpt_sampling`); a JAX-layout run of
    the cond model resumed (:func:`ckpt_resume`). Returns the launch counts
    of the two paths."""
    import shutil

    import torch

    from ivid_tpu_torch import timing
    from ivid_tpu_torch.config import Config, build_backbone
    from ivid_tpu_torch.models import adm
    from ivid_tpu_torch.models.convert import state_dict_to_flax
    from ivid_tpu_torch.training import checkpoint as ckpt_io
    from ivid_tpu_torch.training import flax_msgpack

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    t_phase = time.perf_counter()
    try:
        paths, states, arch = {}, {}, {}
        for tag, cfg_path, seed in (("uncond", UNCOND_CFG, 0), ("cond", COND_CFG, 1)):
            model = adm.randomize_parameters(build_backbone(Config.load(cfg_path)), seed)
            sd, arch[tag] = model.state_dict(), model.arch_args
            del model
            path = os.path.join(tmp, tag, "ckpts", "model_step0000000.msgpack")
            os.makedirs(os.path.dirname(path))
            t0 = time.perf_counter()
            flax_msgpack.write(path, state_dict_to_flax(sd, **arch[tag]))
            t1 = time.perf_counter()
            tree = flax_msgpack.read(path)
            t2 = time.perf_counter()
            back = ckpt_io.load_model_state(path, arch[tag])
            t3 = time.perf_counter()
            del tree
            mb = os.path.getsize(path) / 1e6
            equal = sorted(back) == sorted(sd) and all(torch.equal(back[k], sd[k]) for k in sd)
            log(f"[ckpt migrate] {tag}: {sum(v.numel() for v in sd.values()):,} parameters, "
                f"{mb:.1f} MB; write (convert + write) {mb / (t1 - t0):.1f} MB/s, read alone "
                f"{mb / (t2 - t1):.1f} MB/s, load_model_state (read + convert) "
                f"{mb / (t3 - t2):.1f} MB/s (the file just written: the page cache, not the "
                f"disk); read back bit-equal {equal}; {timing.card_line()}")
            if not equal:
                raise RuntimeError(f"[ckpt migrate] {tag}: the file does not read back equal")
            paths[tag], states[tag] = path, sd
        pt_path = os.path.join(tmp, "uncond.pt")
        torch.save(states["uncond"], pt_path)
        sampling = ckpt_sampling(tmp, paths, pt_path, device)
        resume = ckpt_resume(tmp, states["cond"], arch["cond"], device)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[ckpt migrate] phase wall {time.perf_counter() - t_phase:.2f} s")
    return sampling, resume


def train_chain_run(device):
    """A few InpaintTrainer steps of a small f32 cond model (32², attention
    at T=1024 so K1 and K4 run, the warp at r=96 through K3 and K2) with
    seeded weights and host-drawn noise. Returns the losses and parameters."""
    import torch

    from ivid_tpu_torch.host_noise import HostNoise
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
    counts = counts_since(before)
    want_loss, want = train_chain_run(torch.device("cpu"))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(got_loss, want_loss))
    param_rel = ((got - want).norm() / want.norm()).item()
    log(f"[train-chain] InpaintTrainer, 32² f32, batch 2, 3 AdamW steps: card launches {counts}; "
        f"losses card {np.round(got_loss, 6).tolist()} vs CPU {np.round(want_loss, 6).tolist()}: "
        f"max rel {loss_rel:.3e} (<= {TRAIN_LOSS_REL}); final parameters rel L2 "
        f"{param_rel:.3e} (<= {TRAIN_PARAM_REL})")
    if not (loss_rel <= TRAIN_LOSS_REL and param_rel <= TRAIN_PARAM_REL
            and np.isfinite(got_loss).all()
            and counts == {"K1": 9, "K1 f32": 9, "K2": 3, "K2 bins": 3, "K3": 6, "K4": 9,
                           "K4 f32": 9, "K5": 0, "K6": 0, "GN": 0, "GN bias": 0,
                           "RES": 0}):
        raise RuntimeError("the training chain on the card disagrees with the CPU plain path")
    torch.backends.cudnn.allow_tf32 = True


def phase_train():
    """Full-width cond-model training through the CLI's ``main``; returns
    its launch counts and the trainer."""
    import numpy as np
    import torch

    from ivid_tpu_torch import train
    from ivid_tpu_torch.ops import raster_dense
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
    sync_ms = raster_dense.sync_s * 1e3
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
    log(f"[train] launches {counts}, per step {per_step} (K1 5, K4 5, K3 2, K2 >= 1 and its "
        f"bins as often, GN 0); host ms per step waiting for the bins' length "
        f"{sync_ms / steps:.4f}; "
        f"{changed} of {len(now)} tensors changed since step 3 (not: {unchanged}); finite {finite}; "
        f"reloaded step {again_step} equal {reloaded}")
    if not (np.isfinite(losses).all() and len(losses) == steps and finite and changed > 0
            and reloaded and counts["K1"] == 5 * steps and counts["K4"] == 5 * steps
            and counts["K3"] == 2 * steps and counts["K2"] >= steps
            and counts["K2 bins"] == counts["K2"] and counts["K5"] == counts["K6"] == 0
            and counts["GN"] == counts["RES"] == 0):
        raise RuntimeError("training run failed its checks")
    return counts, tr


def phase_train_profile(tr, timed=10, profiled=2):
    """Where the trainer's own step (``run_step``, as ``run`` takes it) spends
    its time: ``timed`` steps by CUDA events per stage, then ``profiled``
    steps under torch.profiler for the device's kernel time, its idle share
    and the top kernels."""
    import torch

    from ivid_tpu_torch import timing
    from ivid_tpu_torch.ops import raster_dense
    from ivid_tpu_torch.training.trainer import StepRecord

    tr.record = StepRecord(timing=True)
    raster_dense.sync_s = 0.0
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
        + ", ".join(f"{k} {v:.2f}" for k, v in mean.items()) + f"; host wall {wall_ms:.2f}, "
        f"of which waiting for K2's bins' length {raster_dense.sync_s * 1e3 / timed:.4f}")
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
        launches = counts_since(before)
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


def write_rgbd_folder(root, n=64, h=375, w=500, seed=0):
    """A seeded SingleCategory folder: ``n`` RGB PNGs of ``h`` x ``w`` (smooth
    waves under noise) in ``images/`` and their disparities (float32 npz,
    up to 20000) in ``depths/``."""
    import numpy as np

    from ivid_tpu_torch.utils.images import png_encode

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "depths"))
    for i in range(n):
        f, a = rng.uniform(0.004, 0.04, (2, 3)), rng.uniform(0, 2 * np.pi, (2, 3))
        img = np.stack([127.5 + 90 * np.sin(f[0, c] * xx + a[0, c]) * np.cos(f[1, c] * yy + a[1, c])
                        for c in range(3)], axis=-1) + rng.normal(0, 6, (h, w, 3))
        with open(os.path.join(root, "images", f"{i:04d}.png"), "wb") as fh:
            fh.write(png_encode(np.clip(np.round(img), 0, 255).astype(np.uint8)))
        disp = 2000 + 15000 * yy / h + 3000 * np.sin(f[0, 0] * xx + a[0, 0])
        np.savez(os.path.join(root, "depths", f"{i:04d}.npz"), disp.astype(np.float32))


def phase_data_files():
    """``[data files]``: a seeded 64-image PNG folder read by the file-backed
    datasets of the single-category configs; items/s in the main process
    and with 4 thread and 4 process workers, batch 0 held to the items
    loaded one by one. Returns the folder."""
    import numpy as np

    from ivid_tpu_torch.config import Config
    from ivid_tpu_torch.data import DataLoader, SingleCategorySR, SingleCategoryWarp, native

    root = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_files_"), "data")
    t0 = time.perf_counter()
    write_rgbd_folder(root)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    native.build()
    log(f"[data files] 64 RGB PNGs of 375x500 with npz disparities written in {write_s:.2f} s; "
        f"native resampler built with g++ in {time.perf_counter() - t0:.2f} s; host CPUs "
        f"{os.cpu_count()}")
    sets = {
        "SingleCategoryWarp 128²": SingleCategoryWarp(root, **Config.load(COND_CFG).dataset["args"]),
        "SingleCategorySR 256/128": SingleCategorySR(root, **Config.load(SC_SR_CFG).dataset["args"]),
    }
    rates = {}
    for name, ds in sets.items():
        t0 = time.perf_counter()
        items = [ds[i] for i in range(32)]
        rates[name] = {"main process": 32 / (time.perf_counter() - t0)}
        for mode in ("thread", "process"):
            loader = DataLoader(ds, 8, num_workers=4, worker_mode=mode, seed=0)
            it = iter(loader)
            t0 = time.perf_counter()
            first = next(it)
            t1 = time.perf_counter()
            for _ in range(15):
                next(it)
            rate = 15 * 8 / (time.perf_counter() - t1)
            it.close()
            rows = [ds[int(i)] for i in loader._epoch_indices(0)[0]]
            same = all(np.array_equal(first["x_0"][r], item["x_0"]) for r, item in enumerate(rows))
            if "y" in first:  # the blur's sigma is drawn in the worker; the depth is not
                same &= all(np.array_equal(first["y"][r, ..., 3], item["y"][..., 3])
                            for r, item in enumerate(rows))
            rates[name][f"4 {mode} workers"] = rate
            log(f"[data files] {name}, 4 {mode} workers: first batch of 8 after "
                f"{(t1 - t0) * 1e3:.1f} ms, then {rate:.1f} items/s over 15 batches; batch 0 "
                f"equal to the items loaded one by one: {same}")
            if not same:
                raise RuntimeError(f"{name}: the {mode} loader's batch 0 differs from its items")
        shapes = {k: tuple(v.shape) for k, v in items[0].items()}
        log(f"[data files] {name}: {rates[name]['main process']:.1f} items/s in the main "
            f"process; item {shapes}")
    return root


def phase_train_files(root, steps=4, device="cuda"):
    """``[train files]``: ``train.main`` with ``--distributed`` at world size
    1 (NCCL) on the full-width cond config over the ``[data files]`` folder,
    batch 8, 4 process workers: ``steps`` steps with a save at the last, a
    resume for 2 more, then 2 steps with ``warp_host``. Returns the launch
    counts of the first run."""
    import numpy as np
    import torch

    from ivid_tpu_torch import train
    from ivid_tpu_torch.training import checkpoint as ckpt_io
    from ivid_tpu_torch.training.trainer import StepRecord

    with open(COND_CFG) as f:
        cfg = json.load(f)
    cfg["trainer"]["args"].update(max_steps=steps, sample_at_init=False, i_ddpcheck=2,
                                  i_save=steps, i_log=2, i_sample=10 ** 9)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_files_")
    name = os.path.splitext(os.path.basename(COND_CFG))[0]

    def run(tag, extra, warp_host=False):
        cfg["trainer"]["args"]["warp_host"] = warp_host
        os.makedirs(os.path.join(tmp, tag), exist_ok=True)
        path = os.path.join(tmp, tag, os.path.basename(COND_CFG))
        with open(path, "w") as f:
            json.dump(cfg, f)
        os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="localhost",
                          MASTER_PORT=str(free_port()))
        rec = StepRecord(timing=True)
        reset_counts()
        t0 = time.perf_counter()
        tr = train.main(["--config", path, "--data_dir", root, "--output_dir",
                         os.path.join(tmp, "out" if tag != "host" else "out_host"),
                         "--distributed", "--num_workers", "4", "--worker_mode", "process",
                         "--device", device, *extra], record=rec)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts()
        n = len(rec.losses)
        losses = [float(x) for x in rec.losses]
        step_ms = [round(m["step"], 2) for m in rec.stage_ms()]
        wait_ms = [round(w * 1e3, 2) for w in rec.loader_waits]
        log(f"[train files] {tag}: {n} steps, wall {wall:.2f} s (with set-up and the workers' "
            f"start); ms per step (CUDA events) {step_ms}; loader wait ms per step {wait_ms}; "
            f"losses {np.round(losses, 5).tolist()}; launches per step "
            f"{ {k: v / n for k, v in counts.items() if v} }")
        ok = (n > 0 and np.isfinite(losses).all() and tr.ddp is not None and tr.world == 1
              and counts["K1"] == 5 * n and counts["K4"] == 5 * n
              and counts["GN"] == counts["RES"] == 0)
        if warp_host:
            ok &= counts["K2"] == counts["K3"] == 0
        else:
            ok &= counts["K3"] == 2 * n and counts["K2"] >= n
        if not ok:
            raise RuntimeError(f"[train files] {tag} failed its checks: launches {counts}")
        return tr, counts, step_ms

    tr, counts, step_ms = run("first", [])
    run_dir = os.path.join(tmp, "out", name)
    saved = ckpt_io.load(ckpt_io.misc_path(run_dir, steps))["loader_pos"]
    params = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
    del tr
    again, _, _ = run("resume", ["--ckpt", "latest", "--max_steps", str(steps + 2)])
    restored = saved == [0, steps] and again._loader_obj.position == (0, steps + 2)
    moved = any(not torch.equal(v.cpu(), params[k]) for k, v in again.model.state_dict().items())
    del again
    log(f"[train files] checkpoint cursor {saved} restored: {restored} (the resumed loader "
        f"stands at (0, {steps + 2})); parameters moved after the resume: {moved}")
    if not (restored and moved):
        raise RuntimeError("[train files] the resume did not continue from the checkpoint")
    _, _, host_ms = run("host", ["--max_steps", "2"], warp_host=True)
    log(f"[train files] warp_host steps ms {host_ms} beside on-device warp steps ms {step_ms}; "
        f"{os.cpu_count()} host CPUs, 4 process workers")
    return counts


def launch_ranks(kind, argv, nproc=2, timeout=600):
    """``torch.distributed.run`` of ``nproc`` ranks of this script's rank
    worker (``--rank-worker KIND``) with ``argv``; fails if a rank fails.
    Returns each rank's report and the launcher's wall seconds."""
    import subprocess

    import torch

    torch.cuda.empty_cache()  # leave the card's memory to the ranks
    out = tempfile.mkdtemp(prefix=f"chip_smoke_{kind}_ranks_")
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc_per_node={nproc}", os.path.abspath(__file__), "--rank-worker", kind, out,
           "--", *argv]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="2")
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        log(proc.stdout[-4000:])
        log(proc.stderr[-4000:])
        raise RuntimeError(f"[{kind}] torch.distributed.run failed with exit code "
                           f"{proc.returncode}")
    reports = []
    for r in range(nproc):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            reports.append(json.load(f))
    return reports, out, wall


def default_precision():
    """PyTorch's default precision flags, which a fresh process (a rank of
    ``launch_ranks``) runs with: cuDNN convolutions in TF32, matmuls in f32.
    Earlier phases set them otherwise."""
    import torch

    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def seeded_orbit(seed=0):
    """The ``random`` viewset's orbit drawn from a seeded generator (the
    sampling CLI draws it unseeded), so that two sampling runs take the same
    one."""
    import numpy as np

    from ivid_tpu_torch.inference import viewsets

    build = viewsets.build_viewset
    viewsets.build_viewset = lambda name, n: build(name, n, np.random.default_rng(seed))
    try:
        yield
    finally:
        viewsets.build_viewset = build


def rank_worker(kind, out, argv):
    """One rank of ``[tp train]`` (``train.main(argv)``) or ``[dp sample]``
    (``sample.main(argv)``): the launch counter set to 0 before and read
    after, the counts, times and peak memory (this process's, on card 0)
    written to ``out/rank{RANK}.json``."""
    import zlib

    import numpy as np
    import torch


    rank = int(os.environ["RANK"])
    reset_counts()
    t0 = time.perf_counter()
    report = {"rank": rank}
    if kind == "tp_train":
        from ivid_tpu_torch import train
        from ivid_tpu_torch.training.trainer import StepRecord

        rec = StepRecord(timing=True)
        tr = train.main(argv, record=rec)
        torch.cuda.synchronize()
        report.update(
            losses=[float(x) for x in rec.losses],
            step_ms=[m["step"] for m in rec.stage_ms()],
            mesh=[tr.data_size, tr.groups.model_size],
            shards={k: [s.dim, s.halves] for k, s in tr.tp_specs.items()},
            shard_crc={k: zlib.crc32(p.detach().cpu().numpy().tobytes())
                       for k, p in tr.model.named_parameters() if k in tr.tp_specs})
    elif kind == "dp_sample":
        from ivid_tpu_torch import sample

        with seeded_orbit():
            res = sample.main(argv)
        torch.cuda.synchronize()
        np.save(os.path.join(out, f"rank{rank}_samples.npy"), np.concatenate(res["samples"]))
        np.save(os.path.join(out, f"rank{rank}_masks.npy"),
                np.concatenate([c["depth"] > -1 for c in res["conds"]]))
        report["stage_ms"] = res["stage_ms"]
    else:
        raise ValueError(f"no rank worker {kind!r}")
    report.update(wall_s=time.perf_counter() - t0, counts=read_counts(),
                  k1_widths={str(k): v for k, v in k1_widths().items()},
                  peak_gib=torch.cuda.max_memory_allocated(0) / 2 ** 30)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(report, f)
    return 0


def phase_tp_train(steps=3):
    """``[tp train]``: the flagship cond model on 2 TP ranks sharing the card
    (gloo) against world size 1, global batch 8, ``steps`` AdamW steps, both
    from the same seeded random weights. Returns rank 0's launch counts."""
    import zlib

    import numpy as np
    import torch

    from ivid_tpu_torch import train
    from ivid_tpu_torch.config import Config, build_backbone
    from ivid_tpu_torch.models.adm import randomize_parameters
    from ivid_tpu_torch.parallel import tensor as tp
    from ivid_tpu_torch.training import checkpoint as ckpt_io
    from ivid_tpu_torch.training.trainer import StepRecord

    with open(FLAGSHIP_COND) as f:
        cfg = json.load(f)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_train_")
    t0 = time.perf_counter()
    start = randomize_parameters(build_backbone(Config.load(FLAGSHIP_COND)), 12).state_dict()
    weights = os.path.join(tmp, "random_weights.pt")
    ckpt_io.save(weights, start)
    log(f"[tp train] seeded random weights ({sum(v.numel() for v in start.values()) / 1e6:.1f}M "
        f"parameters) written in {time.perf_counter() - t0:.1f} s")
    args = cfg["dataset"]["args"]
    cfg["dataset"] = {"name": "SyntheticRGBDWarp", "args": dict(args, num_classes=1000,
                                                                length=64)}
    cfg["trainer"]["args"].update(max_steps=steps, batch_size_per_gpu=8, i_save=steps,
                                  i_log=steps, i_ddpcheck=1, i_sample=10 ** 9,
                                  sample_at_init=False, num_workers=2, finetune_ckpt=weights)
    lr = float(cfg["trainer"]["args"]["learning_rate"])
    path = os.path.join(tmp, os.path.basename(FLAGSHIP_COND))
    with open(path, "w") as f:
        json.dump(cfg, f)
    name = os.path.splitext(os.path.basename(FLAGSHIP_COND))[0]
    reports, _, launch_wall = launch_ranks("tp_train", [
        "--config", path, "--output_dir", os.path.join(tmp, "tp"), "--device", "cuda:0",
        "--distributed", "--model_parallel", "2"])
    for r in reports:
        log(f"[tp train] rank {r['rank']} of 2 (mesh data {r['mesh'][0]} x model {r['mesh'][1]}, "
            f"gloo on cuda:0): {len(r['losses'])} steps, losses "
            f"{np.round(r['losses'], 6).tolist()}; ms per step (CUDA events) "
            f"{np.round(r['step_ms'], 2).tolist()}; peak memory {r['peak_gib']:.2f} GiB; K1 "
            f"{r['counts']['K1']}, K4 {r['counts']['K4']}, K2 {r['counts']['K2']}, K3 "
            f"{r['counts']['K3']}, GN {r['counts']['GN']}; K1 launches by qkv width "
            f"{r['k1_widths']}; "
            f"{len(r['shards'])} parameters sharded; wall {r['wall_s']:.1f} s")
    default_precision()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    rec = StepRecord(timing=True)
    t0 = time.perf_counter()
    one = train.main(["--config", path, "--output_dir", os.path.join(tmp, "one"), "--device",
                      "cuda"], record=rec)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, widths = read_counts(), k1_widths()
    losses = [float(x) for x in rec.losses]
    log(f"[tp train] world size 1: losses {np.round(losses, 6).tolist()}; ms per step (CUDA "
        f"events) {[round(m['step'], 2) for m in rec.stage_ms()]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; K1 {counts['K1']}, K4 "
        f"{counts['K4']}, GN {counts['GN']}; K1 launches by qkv width {widths}; wall "
        f"{wall:.1f} s (the two ranks' "
        f"launcher {launch_wall:.1f} s, with their start)")
    del one
    tp_dir, one_dir = os.path.join(tmp, "tp", name), os.path.join(tmp, "one", name)
    got = {"model": ckpt_io.load(ckpt_io.model_path(tp_dir, steps)),
           "ema": ckpt_io.load(ckpt_io.ema_path(tp_dir, 0.9999, steps))}
    want = {"model": ckpt_io.load(ckpt_io.model_path(one_dir, steps)),
            "ema": ckpt_io.load(ckpt_io.ema_path(one_dir, 0.9999, steps))}
    same_layout = (got["model"].keys() == want["model"].keys() == start.keys()
                   and all(got["model"][k].shape == v.shape for k, v in want["model"].items()))
    if not same_layout:
        raise RuntimeError("[tp train] the TP run's checkpoint differs in names or shapes")
    keys = list(want["model"])
    flat = lambda d: torch.cat([d[k].float().reshape(-1) for k in keys])
    p0, a, b = flat(start), flat(got["model"]), flat(want["model"])
    update_rel = float((a - b).norm() / (b - p0).norm())
    flips = float(((a - b).abs() > lr / 2).float().mean())
    tensor_rel = {k: float((got["model"][k].float() - want["model"][k].float()).norm()
                           / (want["model"][k].float() - start[k].float()).norm())
                  for k in keys if start[k].numel() >= TP_TENSOR_MIN}
    top = sorted(tensor_rel, key=tensor_rel.get, reverse=True)
    worst = top[0]
    ema_b = flat(want["ema"])
    ema_over = float(((flat(got["ema"]) - ema_b).abs() - 1e-4 * (3 * (a - b).abs() + 7 * lr)
                      - TP_EMA_ULPS * 2.0 ** -23 * ema_b.abs()).max())
    loss_rel = [abs(x - y) / abs(y) for x, y in zip(reports[0]["losses"], losses)]
    # Each rank holds its slices of the full tensors that rank 0 saved, and
    # the slices of random weights differ between the ranks.
    crc = [r["shard_crc"] for r in reports]
    specs = {k: tp.Shard(*v) for k, v in reports[0]["shards"].items()}
    slices = sum(zlib.crc32(tp.shard_tensor(got["model"][k], s, r, 2).numpy().tobytes())
                 == crc[r][k] for k, s in specs.items() for r in (0, 1))
    differ = sum(crc[0][k] != crc[1][k] for k in crc[0])
    log(f"[tp train] TP 2 vs world size 1 at step {steps}: losses rel "
        f"{[float(f'{x:.3e}') for x in loss_rel]} (bound {TP_LOSS_REL}); parameters "
        f"{update_rel:.3e} of the {steps} steps' update (L2, bound {TP_UPDATE_REL}), worst "
        f"tensor {worst} {tensor_rel[worst]:.3e} (bound {TP_TENSOR_REL}, {len(tensor_rel)} "
        f"tensors of >= {TP_TENSOR_MIN} elements; next "
        + ", ".join(f"{k}{' (sharded)' if k in specs else ''} {tensor_rel[k]:.3e}"
                    for k in top[1:6])
        + f"; median {float(np.median(list(tensor_rel.values()))):.3e}), {flips:.3e} of "
        f"elements apart by more than lr/2 (bound {TP_FLIP_SHARE}), max abs "
        f"{float((a - b).abs().max()):.3e}; EMA's largest excess over 1e-4·(3·|Δp| + 7·lr) + "
        f"{TP_EMA_ULPS} ulps {ema_over:.3e} (bound 0); {slices} of {2 * len(specs)} rank "
        f"shards equal their slices of the saved tensors; {differ} of {len(crc[0])} shards "
        f"differ between the model ranks")
    ok = (all(len(r["losses"]) == steps and r["mesh"] == [1, 2] for r in reports)
          and reports[0]["losses"] == reports[1]["losses"] and len(losses) == steps
          and all(np.isfinite(losses)) and max(loss_rel) <= TP_LOSS_REL
          and update_rel <= TP_UPDATE_REL and tensor_rel[worst] <= TP_TENSOR_REL
          and flips <= TP_FLIP_SHARE and ema_over <= 0
          and reports[0]["shards"] == reports[1]["shards"] and len(specs) > 0
          and slices == 2 * len(specs) and differ == len(specs)
          and counts["K1"] == counts["K4"] == 5 * steps and widths == {1536: 5 * steps}
          and counts["GN"] == counts["RES"] == 0
          and all(r["counts"]["GN"] == r["counts"]["RES"] == 0 for r in reports)
          and all(r["counts"]["K1"] == r["counts"]["K4"] == 5 * steps
                  and r["k1_widths"] == {"768": 5 * steps} and r["counts"]["K3"] == 2 * steps
                  and r["counts"]["K2"] >= steps for r in reports))
    if not ok:
        raise RuntimeError("[tp train] failed its checks")
    return reports[0]["counts"]


def phase_dp_sample():
    """``[dp sample]``: ``sample.main --data_parallel`` on 2 ranks sharing the
    card (gloo) against world size 1: the flagship pair, 4 scenes at batch
    4, DDIM 50 + guided DDIM 10. Returns rank 0's launch counts."""
    import numpy as np

    from ivid_tpu_torch import sample

    argv = ["--config_uncond", FLAGSHIP_UNCOND, "--config_cond", FLAGSHIP_COND,
            "--ckpt_uncond", "random", "--ckpt_cond", "random", "--seeds", "0-3",
            "--viewset", "random", "--batchsize", "4",
            "--steps_uncond", "50", "--steps_cond", "10"]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp_sample_")
    reports, rank_dir, launch_wall = launch_ranks("dp_sample", argv + [
        "--output_dir", os.path.join(tmp, "dp"), "--device", "cuda:0", "--data_parallel"])
    default_precision()
    for r in reports:
        log(f"[dp sample] rank {r['rank']} of 2 (gloo on cuda:0, scenes {2 * r['rank']}-"
            f"{2 * r['rank'] + 1}): wall {r['wall_s']:.2f} s; stages (CUDA events) "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in r["stage_ms"].items())
            + f"; launches K1 {r['counts']['K1']} (f32 {r['counts']['K1 f32']}), K2 "
            f"{r['counts']['K2']}, GN {r['counts']['GN']}; peak memory {r['peak_gib']:.2f} GiB")
    reset_counts()
    t0 = time.perf_counter()
    with seeded_orbit():
        one = sample.main(argv + ["--output_dir", os.path.join(tmp, "one"), "--device", "cuda"])
    wall = time.perf_counter() - t0
    counts = read_counts()
    want = np.concatenate(one["samples"])
    want_mask = np.concatenate([c["depth"] > -1 for c in one["conds"]])
    got = np.concatenate([np.load(os.path.join(rank_dir, f"rank{r}_samples.npy"))
                          for r in (0, 1)])
    got_mask = np.concatenate([np.load(os.path.join(rank_dir, f"rank{r}_masks.npy"))
                               for r in (0, 1)])
    rel = lambda x, y: float(np.linalg.norm(x - y) / np.linalg.norm(y))
    first = max(rel(got[i, 0], want[i, 0]) for i in range(4))
    second = max(rel(got[i, 1], want[i, 1]) for i in range(4))
    flips = float((got_mask != want_mask).mean())
    names = lambda d: sorted(os.listdir(os.path.join(d, os.listdir(d)[0], "scenes")))
    same_files = names(os.path.join(tmp, "dp")) == names(os.path.join(tmp, "one"))
    log(f"[dp sample] world size 1: wall {wall:.2f} s (the two ranks' launcher "
        f"{launch_wall:.2f} s, with their start); launches K1 {counts['K1']} (f32 "
        f"{counts['K1 f32']}), K2 {counts['K2']}, GN {counts['GN']}, RES {counts['RES']} "
        f"({GN_SITES}, {RES_SITES} a forward of 5 K1 sites, on each rank and at world size 1)")
    log(f"[dp sample] 2 ranks vs 1, per scene: first view max rel L2 {first:.3e} (bound "
        f"{DP_F32_REL}), second view {second:.3e} (bound {SR_BF16_REL}); condition-mask pixels "
        f"differing {flips:.5f} (bound {CHAIN_MASK_FRAC}); the same scene files {same_files}")
    ok = (got.shape == want.shape == (4, 2, 128, 128, 4) and np.isfinite(got).all()
          and first <= DP_F32_REL and second <= SR_BF16_REL and flips <= CHAIN_MASK_FRAC
          and same_files
          and counts["K1"] % 5 == 0 and folded(counts, counts["K1"] // 5)
          and all(r["counts"]["K1"] == counts["K1"] and r["counts"]["K1 f32"] == counts["K1 f32"]
                  and r["counts"]["GN"] == counts["GN"] and r["counts"]["RES"] == counts["RES"]
                  and r["counts"]["K2"] == counts["K2"] >= 1 for r in reports))
    if not ok:
        raise RuntimeError("[dp sample] failed its checks")
    return reports[0]["counts"]


def phase_graft():
    """``[graft]``: ``graft_entry.entry()``'s flagship forward on the card,
    then ``dryrun_multichip(2, "cuda:0")``. Returns the forward's counts."""
    import torch

    from ivid_tpu_torch import graft_entry

    fn, args = graft_entry.entry("cuda")
    reset_counts()
    t0 = time.perf_counter()
    out = fn(*args)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    finite = bool(torch.isfinite(out).all())
    del fn, args
    t0 = time.perf_counter()
    line = graft_entry.dryrun_multichip(2, "cuda:0")
    dry = time.perf_counter() - t0
    log(f"[graft] entry(): flagship forward at batch 2 {tuple(out.shape)} finite {finite}, "
        f"{ms:.1f} ms with its first launches; launches {counts}; dryrun_multichip(2, cuda:0) "
        f"in {dry:.1f} s: {line}")
    if not (finite and tuple(out.shape) == (2, 128, 128, 4) and counts["K1 f32"] == 5
            and folded(counts, 1)
            and line.startswith("dryrun_multichip: mesh={'data': 1, 'model': 2} loss=")
            and line.endswith(" OK")):
        raise RuntimeError("[graft] failed its checks")
    return counts


def phase_sr27(steps=3, block=6):
    """``[SR 27]``: the SR cascade at ``sr.py``'s default chunk of 27 views.
    K1 bf16 at the chunk's guided shape [54, 4096, 768] (4 heads) against
    its plain version in f32 on the same bf16 inputs, computed ``block`` rows
    at a time, and timed against its bound; then one 27-view ``3x9`` scene
    of 128² views through ``ivid_tpu_torch.sr.main`` (the full-width SR
    model, seeded weights, ``steps`` guided DDIM steps, ``--batchsize 27``:
    one forward of 54 at 256² a step), whose forwards replay a CUDA graph,
    against ``sr.upsample_views`` on the same views, weights and noise with
    the model in train mode (the same forward, eager): bit for bit, with
    the memory the graph reserves and the wall seconds of each."""
    import numpy as np
    import torch

    from ivid_tpu_torch import sr
    from ivid_tpu_torch.bench_attention import bound_ms
    from ivid_tpu_torch.config import Config
    from ivid_tpu_torch.diffusion.noise import TorchNoise
    from ivid_tpu_torch.inference.scene_io import load_scene
    from ivid_tpu_torch.ops import attention
    from ivid_tpu_torch.ops import geometry as geom
    from ivid_tpu_torch.sample import build_model

    b, t, heads = 54, 4096, 4
    scale = float(64 ** -0.25)
    qkv = torch.from_numpy(np.random.default_rng(9).standard_normal(
        (b, t, 3 * heads * 64)).astype(np.float32)).to("cuda", torch.bfloat16)
    got = attention.packed_attention(qkv, heads, scale)
    err_max, err_sum = 0.0, 0.0
    for i in range(0, b, block):
        want = attention.reference_attention(qkv[i:i + block].float(), heads, scale)
        err = (got[i:i + block].float() - want).abs()
        err_max, err_sum = max(err_max, err.max().item()), err_sum + err.sum().item()
        del want, err
    err_mean = err_sum / got.numel()
    ms, host = timed(lambda: attention.packed_attention(qkv, heads, scale))
    bound, bound_by = bound_ms(b, t, heads, torch.bfloat16)
    log(f"[SR 27] K1 bf16 [{b},{t},{3 * heads * 64}] {heads} heads: max|err| {err_max:.3e} "
        f"(<= {K1_BF16_MAX}) mean {err_mean:.3e} (<= {K1_BF16_MEAN}) against the plain version "
        f"in f32 ({block} rows at a time); kernel {ms:.4f} ms device, {host:.4f} host, bound "
        f"{bound:.4f} ms by {bound_by} ({100 * bound / ms:.1f}% of it)")
    del qkv, got
    torch.cuda.empty_cache()
    if not (err_max <= K1_BF16_MAX and err_mean <= K1_BF16_MEAN):
        raise RuntimeError("K1 disagrees with its plain version at [54, 4096, 768]")

    root = write_scene(tempfile.mkdtemp(prefix="chip_smoke_sr27_"), 27, 128, seed=3)
    mem0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    graphed = sr.main(["--config_sr", SR_CFG, "--ckpt_sr", "random", "--scene_dir", root,
                       "--steps", str(steps), "--guidance", "3", "--classes", "mod",
                       "--batchsize", "27", "--device", "cuda"])["samples"][0]
    graphed_s = time.perf_counter() - t0
    launches = {"graphed": read_counts()}
    pool_gib = (torch.cuda.max_memory_reserved() - mem0) / 2 ** 30
    cfg = Config.load(SR_CFG)
    fw = build_model(cfg, "random", 0, torch.device("cuda"))
    fw.model.train()
    meshes, colors = load_scene(os.path.join(root, "scenes", "scene_seed00000.npz"),
                                device="cuda")
    views = torch.stack([torch.cat([torch.from_numpy(c).to("cuda"),
                                    geom.project_depth(m.depth, 0.6, 5.0)], dim=-1)
                         for m, c in zip(meshes, colors)])
    reset_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        eager = sr.upsample_views(
            fw, views, classes=0, noise=lambda i: TorchNoise.seeded(i, "cuda"), steps=steps,
            guidance=3.0, batchsize=27, image_size=256).cpu().numpy()
    eager_s = time.perf_counter() - t0
    launches["eager"] = read_counts()
    equal = graphed.shape == eager.shape == (27, 256, 256, 4) and np.array_equal(graphed, eager)
    diff = float(np.abs(graphed - eager).max()) if graphed.shape == eager.shape else float("nan")
    log(f"[SR 27] sr.main, {os.path.basename(SR_CFG)}, a 27-view 3x9 scene of 128² views, "
        f"--batchsize 27, {steps} guided steps (a forward of 54 at 256²): graphed vs eager "
        f"bit-equal {equal} (largest |diff| {diff:.3e}), finite {bool(np.isfinite(graphed).all())}; "
        f"reserved by the graphed run {pool_gib:.2f} GiB; wall s graphed {graphed_s:.2f} "
        f"(the graph's warm-up and capture included), eager {eager_s:.2f}; GN, GN bias and RES "
        f"launches { {k: [c[x] for x in ('GN', 'GN bias', 'RES')] for k, c in launches.items()} } "
        f"({GN_SITES}, {RES_SITES} and {RES_SITES} a forward x {steps} steps each)")
    del fw
    torch.cuda.empty_cache()
    if not (equal and np.isfinite(graphed).all()):
        raise RuntimeError("[SR 27] the graphed SR chunk differs from the eager one")
    if not all(folded(c, steps) for c in launches.values()):
        raise RuntimeError(f"[SR 27] the norm and residual kernels launched {launches} times, "
                           f"not {GN_SITES}, {RES_SITES} and {RES_SITES} a forward")
    return launches


def run_phase(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, then a ``[time]`` line with its wall seconds
    and the script's running total, so that the script's budget can be read
    phase by phase."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kwargs)
    finally:
        now = time.perf_counter()
        log(f"[time] {fn.__name__}: {now - t0:.1f} s (script at {now - T_START:.1f} s)")


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--rank-worker"]:
        kind, out, sep, *argv = sys.argv[2:]
        if sep != "--":
            raise SystemExit("usage: chip_smoke.py --rank-worker KIND OUT -- ARGV")
        return rank_worker(kind, out, argv)
    smi = run_phase(phase_device)
    k1 = run_phase(phase_attention, 2, 0, training=False)
    k1_train = run_phase(phase_attention, 8, 3, training=True)
    # The SR cascade's sampling shapes (a chunk of 2 views with CFG: batch 4;
    # T=4096 with 4 heads, T=1024 with 6), checked and timed in bf16.
    k1["other_shapes"] = [run_phase(phase_attention, 4, 5, False, t=4096, time_f32=False),
                          run_phase(phase_attention, 4, 6, False, heads=6, time_f32=False)]
    k2 = run_phase(phase_raster)
    k2_render = run_phase(phase_raster_render)
    k3, warp_inputs, r = run_phase(phase_resolve)
    skirt8, skirt1 = run_phase(phase_skirt, warp_inputs, r)
    k6 = run_phase(phase_tile, warp_inputs, r)
    del warp_inputs
    k5 = run_phase(phase_binned)
    benches = run_phase(phase_benches)
    k4 = run_phase(phase_attention_backward)
    # The SR trainer's shapes (micro-batch 2).
    k4["other_shapes"] = [
        run_phase(phase_attention_backward, 2, 4096, 4, seed=7, time_f32=False),
        run_phase(phase_attention_backward, 2, 1024, 6, seed=8, time_f32=False)]
    k1_f32, k4_f32 = run_phase(phase_f32_attention)
    gn_entry = run_phase(phase_group_norm)
    res_entry = run_phase(phase_residual)
    run_phase(phase_unet)
    run_phase(phase_flagship_unet)
    run_phase(phase_unet_graph)
    sr27_counts = run_phase(phase_sr27)
    sr_sites = run_phase(phase_sr_unet)
    run_phase(phase_chain)
    run_phase(phase_sr_chain)
    run_phase(phase_train_chain)
    sampling = run_phase(phase_pipeline)
    ckpt_sampling_counts, ckpt_resume_counts = run_phase(phase_ckpt_migrate)
    training, trainer = run_phase(phase_train)
    run_phase(phase_train_profile, trainer)
    del trainer
    file_training = run_phase(phase_train_files, run_phase(phase_data_files))
    flagship_sampling, flagship_scenes = run_phase(phase_flagship_pipeline)
    sr_sampling, sr_dir = run_phase(phase_sr, flagship_scenes, sr_sites)
    rendering, frames = run_phase(phase_render, flagship_scenes, sr_dir)
    run_phase(phase_eval, frames)
    del frames
    flagship_training, _ = run_phase(phase_flagship_train)
    sr_training, _ = run_phase(phase_sr_train, sr_sites)
    run_phase(phase_flagship_ab)
    tp_training = run_phase(phase_tp_train)
    dp_sampling = run_phase(phase_dp_sample)
    graft = run_phase(phase_graft)
    # ``launches``: the count of the path each kernel entry's shape stands
    # for (K1 at batch 2 and K2 on grids: sampling; the other entries:
    # training; K2 at B=1 is on neither path: the trainer warps the whole
    # batch at once).
    for entry, key, path in ((k1, "K1", sampling), (k1_train, "K1", training),
                             (k2, "K2", sampling), (k3, "K3", training),
                             (skirt8, "K2", training), (k4, "K4", training)):
        entry["launches"] = path[key]
        entry["launches_by_path"] = {"sampling": sampling[key], "training": training[key],
                                     "file training": file_training[key],
                                     "msgpack sampling": ckpt_sampling_counts[key],
                                     "msgpack resume": ckpt_resume_counts[key]}
    skirt1["launches"] = 0
    # The free-view render: one K2 launch per frame, over all of a scene's
    # slots (27 at 640² for a ``3x9`` scene, 2 at 1280² for an SR scene).
    k2["launches_by_path"]["render"] = rendering["640"]["K2"]
    for entry in k2["other_shapes"]:  # the 26-slot view: a ``3x9`` scene's sampling
        entry["launches"] = sampling["K2"]
        entry["launches_by_path"] = {"sampling": sampling["K2"]}
    for entry in k2_render:
        entry["launches"] = rendering[str(entry["r"])]["K2"]
        entry["launches_by_path"] = {"render": entry["launches"], "render per frame": 1}
    k2["other_shapes"] += k2_render
    # The f32 paths: the flagship model's sampling (K1 f32) and training (K4 f32).
    for entry, key, path in ((k1_f32, "K1 f32", flagship_sampling),
                             (k4_f32, "K4 f32", flagship_training)):
        entry["launches"] = path[key]
        entry["launches_by_path"] = {"flagship sampling": flagship_sampling[key],
                                     "flagship training": flagship_training[key]}
    # The SR paths (bf16): K1 at its sampling shapes, K4 at its training
    # shapes; every K1/K4 entry gets their counts of its own dtype.
    for entry, key in ((k1, "K1"), (k1_train, "K1"), (k4, "K4"), (k1_f32, "K1 f32"),
                       (k4_f32, "K4 f32")):
        entry["launches_by_path"].update({"sr sampling": sr_sampling[key],
                                          "sr training": sr_training[key]})
    for entry in k1["other_shapes"]:
        entry["launches"] = sr_sampling["K1"]
        entry["launches_by_path"] = {"sr sampling": sr_sampling["K1"],
                                     "sr training": sr_training["K1"]}
    for entry in k4["other_shapes"]:
        entry["launches"] = sr_training["K4"]
        entry["launches_by_path"] = {"sr sampling": sr_sampling["K4"],
                                     "sr training": sr_training["K4"]}
    # The parallel paths: rank 0's counts (each rank launches as many); the
    # bf16 entries count the bf16 launches (the flagship uncond model is f32).
    for entry, key in ((k1, "K1"), (k1_train, "K1"), (k4, "K4")):
        entry["launches_by_path"].update({
            "tp train (rank 0)": tp_training[key] - tp_training[key + " f32"],
            "dp sample (rank 0)": dp_sampling[key] - dp_sampling[key + " f32"]})
    for entry, key in ((k1_f32, "K1 f32"), (k4_f32, "K4 f32")):
        entry["launches_by_path"].update({"dp sample (rank 0)": dp_sampling[key],
                                          "graft entry": graft[key]})
    k2["launches_by_path"]["dp sample (rank 0)"] = dp_sampling["K2"]
    for entry, key in ((k3, "K3"), (skirt8, "K2")):
        entry["launches_by_path"]["tp train (rank 0)"] = tp_training[key]
    # K5 and K6: the count of the bench runs, their only path.
    for entry, key in ((k5, "K5"), (k6, "K6")):
        entry["launches"] = benches[key]
        entry["launches_by_path"] = {"sampling": sampling[key], "training": training[key],
                                     "benches": benches[key]}
    # The GroupNorm kernel: its launches on each main path (87 a forward on
    # the sampling paths, none in training).
    # The GroupNorm kernel and the residual sum: their launches on each main
    # path (87 and 35 a forward on the sampling paths, none in training).
    for entry, key in ((gn_entry, "GN"), (res_entry, "RES")):
        entry["launches"] = sr_sampling[key]
        entry["launches_by_path"] = {
            "sr sampling": sr_sampling[key], "sr 27 graphed": sr27_counts["graphed"][key],
            "sr 27 eager": sr27_counts["eager"][key], "sampling": sampling[key],
            "flagship sampling": flagship_sampling[key], "dp sample (rank 0)": dp_sampling[key],
            "msgpack sampling": ckpt_sampling_counts[key], "graft entry": graft[key],
            "training": training[key], "file training": file_training[key],
            "flagship training": flagship_training[key], "sr training": sr_training[key],
            "tp train (rank 0)": tp_training[key], "msgpack resume": ckpt_resume_counts[key]}
    from ivid_tpu_torch import timing

    log(f"[timing] device-time readings taken by queued CUDA events instead of "
        f"torch.profiler: {timing.fallbacks}")
    log(json.dumps({"kernels": [k1, k1_train, k1_f32, k2, skirt8, skirt1, k3, k4, k4_f32, k5,
                                k6, gn_entry, res_entry]}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
