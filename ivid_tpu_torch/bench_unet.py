"""Model-level A/B of the attention kernels on the flagship 1000-class f32
model (``configs/rgbd_imagenet_adm_128_large_cfg.json``, seeded random
weights, full width), on the card:

    python -m ivid_tpu_torch.bench_unet [--reps 3]

Two cells, each run with the attention sites at T >= 512 (five per forward,
at 32²) on three versions of the same function, in turns (kernel, plain,
SDPA, SDPA, plain, kernel):
- ``kernel``: the port's path, K1 f32 and, under autograd, K4 f32;
- ``plain``: the plain version (``attention.reference_attention``), with
  autograd for the backward;
- ``sdpa``: torch's scaled_dot_product_attention on the unpacked layout, with
  autograd through its backward (the library yardstick; the port never calls
  it).

Cells:
- ``uncond step``: one CFG DDPM step at ``BATCH`` (the sampler's default
  10): the UNet forward at [2·BATCH, 128, 128, 4] (cond and null fused) and
  the DDPM update;
- ``train step``: one ``BasicTrainer`` step at ``TRAIN_BATCH`` (the
  config's 16): CFG label drop, forward, backward, AdamW and EMA, on
  ``SyntheticRGBD`` 128² with 1000 classes (the ImageNet files are not in
  the repository).

The swap replaces ``ivid_tpu_torch.ops.attention.packed_attention`` inside
this process only, for the turn, and puts it back; it drops the model's
CUDA graphs, which replay the version they were captured with, so the
uncond step's turns replay graphs of their own version. Times are CUDA events
around ``--reps`` steps after one warm-up step, per step, in ms; with each
turn, the K1/K4 launches it made (0 for the other versions); per version,
one more step under torch.profiler (device time summed over its kernels,
their count, the five largest); and, for the uncond step, the largest
relative difference of its output from the plain version's. Prints one JSON line per cell, then the card's name and power
limit as nvidia-smi reads them.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

from ivid_tpu_torch import cuda_build, timing
from ivid_tpu_torch.bench_attention import sdpa_forward
from ivid_tpu_torch.ops import attention

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs",
                      "rgbd_imagenet_adm_128_large_cfg.json")
BATCH = 10  # sample.py's default sampling batch; the forward's is 2x (CFG)
TRAIN_BATCH = 16  # the config's batch_size_per_gpu
ORDER = ("kernel", "plain", "sdpa", "sdpa", "plain", "kernel")
VERSIONS = {
    "kernel": attention.packed_attention,
    "plain": attention.reference_attention,
    "sdpa": sdpa_forward,
}


def build(device, seed: int = 0):
    """The flagship framework (CFG) with seeded random weights on ``device``."""
    from ivid_tpu_torch.config import Config, build_backbone, build_framework_from_config
    from ivid_tpu_torch.models.adm import randomize_parameters

    cfg = Config.load(CONFIG)
    model = randomize_parameters(build_backbone(cfg), seed).to(device)
    return cfg, build_framework_from_config(cfg, model, device=device)


def _profile(step) -> dict:
    """Device time of one step under torch.profiler: the sum over its
    kernels, memsets and copies, and the five largest by name."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = timing.device_rows(prof, 1)
    return {"device_ms": sum(r[0] for r in rows), "kernels": sum(r[1] for r in rows),
            "top": [[round(ms, 4), n, name[:80]] for ms, n, name in rows[:5]]}


def _use(fn, model) -> None:
    """Route the attention sites through ``fn``, and drop ``model``'s CUDA
    graphs, which call the version they were captured with."""
    attention.packed_attention = fn
    model.graphs.clear()


def _turns(step, reps, model):
    """{version: [ms per step, ...]}, {version: [K1, K4 launches]} and
    {version: profile of one more step} over the turns of ORDER, each turn
    one warm-up step and ``reps`` timed ones."""
    ms, launches, prof = {}, {}, {}
    real = attention.packed_attention
    try:
        for name in ORDER:
            _use(VERSIONS[name], model)
            before = cuda_build.launches.copy()
            ms.setdefault(name, []).append(timing.host_ms(step, reps=reps, warmup=1))
            launches[name] = [cuda_build.launches[k] - before[k] for k in ("K1", "K4")]
            if name not in prof:
                prof[name] = _profile(step)
    finally:
        _use(real, model)
    return ms, launches, prof


def uncond_cell(fw, batch: int, reps: int, seed: int = 1) -> dict:
    """One CFG DDPM step at ``batch`` (the forward at 2·batch), by version."""
    from ivid_tpu_torch.diffusion import schedules as sched

    dev = next(fw.model.parameters()).device
    s = fw.schedule
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((batch, 128, 128, 4), generator=gen, device=dev)
    z = torch.randn(x.shape, generator=gen, device=dev)
    t = torch.full((batch,), 500, dtype=torch.long, device=dev)
    cond = {"classes": torch.arange(batch, device=dev) * 97 % 1000}
    fw.model.eval()

    @torch.no_grad()
    def step():
        eps = fw.model_inference(None, x, t, cond, guidance=3.0)
        pred = sched.predict_xstart_from_eps(s, x, t, eps)
        mean, _, log_var = sched.q_posterior_mean_variance(s, pred, x, t)
        return mean + torch.exp(0.5 * log_var) * z

    ms, launches, prof = _turns(step, reps, fw.model)
    outs = {}
    real = attention.packed_attention
    try:
        for name, fn in VERSIONS.items():
            _use(fn, fw.model)
            outs[name] = step()
    finally:
        _use(real, fw.model)
    ref = outs["plain"]
    diff = {n: ((o - ref).abs().max() / ref.abs().max()).item() for n, o in outs.items()}
    return {"cell": "uncond step", "batch": batch, "forward_batch": 2 * batch, "ms": ms,
            "launches": launches, "profile": prof, "max_rel_diff_vs_plain": diff}


def train_cell(fw, cfg, batch: int, reps: int) -> dict:
    """One BasicTrainer step at ``batch``, by version, with the peak memory."""
    from ivid_tpu_torch.data import SyntheticRGBD
    from ivid_tpu_torch.training.trainer import BasicTrainer

    args = dict(cfg.dataset["args"])
    data = SyntheticRGBD(image_size=args["image_size"], length=batch * (len(ORDER) * (reps + 1) + 1),
                         num_classes=1000, normalize=args["normalize"],
                         normalize_depth=args["normalize_depth"],
                         prepocess_depth=args["prepocess_depth"])
    targs = dict(cfg.trainer["args"], batch_size_per_gpu=batch, max_steps=10 ** 9,
                 i_sample=10 ** 9, i_save=10 ** 9, sample_at_init=False)
    dev = next(fw.model.parameters()).device
    tr = BasicTrainer(fw, data, tempfile.mkdtemp(prefix="bench_unet_"), device=dev, **targs)
    torch.cuda.reset_peak_memory_stats()
    ms, launches, prof = _turns(tr.run_step, reps, fw.model)
    return {"cell": "train step", "batch": batch, "batch_split": tr.batch_split, "ms": ms,
            "launches": launches, "profile": prof,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("bench_unet: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, fw = build(torch.device("cuda"))
    lines = [uncond_cell(fw, BATCH, args.reps), train_cell(fw, cfg, TRAIN_BATCH, args.reps)]
    for line in lines:
        print(json.dumps(line), flush=True)
    print(timing.card_line(), flush=True)
    return lines


if __name__ == "__main__":
    main()
