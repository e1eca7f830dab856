"""Multiview RGBD scene sampling CLI: ``python -m ivid_tpu_torch.sample``.

The port of the repo's ``sample.py``, with its flags, plus ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions). Two
configs (uncond + cond), seeds or num_samples, class selection, viewsets
``uncond``/``random``/``3x9``, and the output tree
``{output_dir}/viewset_{v}_steps_u{u}_c{c}_guidance{g}/{scenes,conds,grids,results}``
with the same file names. ``--ckpt_* random`` draws every parameter from a
numpy seed (0 for uncond, 1 for cond); any other value is a model or EMA
file: a JAX package ``.msgpack`` file (a run of the root ``train.py``) or a
PyTorch state dict (``.pt``: the port's, or the reference's, whose names
this port's UNet shares).

Besides the JAX CLI's records it writes every scene's npz for the ``random``
viewset too. Depth grids use the INFERNO colormap, as the JAX CLI's.
``--profile_dir DIR`` runs the first batch under torch.profiler and writes
its Chrome trace, with the pipeline's, samplers' and UNet's spans, into
``DIR`` (as ``train.py --profile_dir`` does for the first steps).

``--data_parallel`` shards every batch over the ranks that
``torch.distributed.run`` starts (the reference's per-GPU sampling
processes, which the JAX pipeline's batch-sharded mesh stands for)::

    python -m torch.distributed.run --standalone --nproc_per_node W \
        -m ivid_tpu_torch.sample ... --data_parallel

Rank r takes rows ``[r·b/W, (r+1)·b/W)`` of every batch of b: its seeds'
noise, its classes and its views. Its noise source is its rows of the
whole batch's draws (``parallel.RowShardNoise``), so a scene does not
depend on W. Each rank writes its own scenes' files, named by their global
index; a batch that W does not divide is refused. ``--device cuda`` puts
one rank on each card (NCCL), ``cuda:K`` every rank on card K (gloo),
``cpu`` runs gloo on the CPU. Rank 0 draws the classes and the ``random``
viewset's orbit and sends them to the others.
"""

from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config_uncond", type=str, default="configs/rgbd_imagenet_adm_128_large_cfg.json")
    p.add_argument("--config_cond", type=str, default="configs/rgbd_imagenet_adm_128_large_cond.json")
    p.add_argument("--ckpt_uncond", type=str, default="ckpts/imagenet128_uncond.pt")
    p.add_argument("--ckpt_cond", type=str, default="ckpts/imagenet128_cond.pt")
    p.add_argument("--output_dir", type=str, default="samples/imagenet128")
    p.add_argument("--seeds", type=str, default="0-8")
    p.add_argument("--num_samples", type=int, default=None)
    p.add_argument("--classes", type=str, default="mod")
    p.add_argument("--viewset", type=str, default="3x9")
    p.add_argument("--steps_uncond", type=int, default=1000)
    p.add_argument("--steps_cond", type=int, default=50)
    p.add_argument("--guidance", type=float, default=3.0)
    p.add_argument("--batchsize", type=int, default=10)
    p.add_argument("--fov", type=float, default=45)
    p.add_argument("--near", type=float, default=0.6)
    p.add_argument("--far", type=float, default=5)
    p.add_argument("--atol", type=float, default=0.03)
    p.add_argument("--rtol", type=float, default=0.03)
    p.add_argument("--erode_rgb", type=int, default=3)
    p.add_argument("--max_agg_views", type=int, default=None,
                   help="Aggregate only the K angularly-nearest prior views per novel "
                        "view (default: all). Lossy: dropped views change the depth "
                        "and mask conditioning")
    p.add_argument("--data_parallel", action="store_true",
                   help="shard every batch over the ranks of torch.distributed.run")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="trace the first batch with torch.profiler into this directory")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def build_model(cfg, ckpt: str, seed: int, device):
    """Backbone + framework of ``cfg`` with random (``ckpt == "random"``) or
    checkpoint weights (``.msgpack`` or ``.pt``, see
    ``training.checkpoint.load_model_state``), on ``device``."""
    from ivid_tpu_torch.config import build_backbone, build_framework_from_config
    from ivid_tpu_torch.models.adm import randomize_parameters
    from ivid_tpu_torch.training.checkpoint import load_model_state

    model = build_backbone(cfg)
    if ckpt == "random":
        randomize_parameters(model, seed)
    else:
        model.load_state_dict(load_model_state(ckpt, model.arch_args))
    model.to(device).eval()
    return build_framework_from_config(cfg, model, device=device)


def save_records(out, viewset, suffix, samples, conds, meshes, colors):
    """One scene's files, named as the JAX CLI names them."""
    from ivid_tpu_torch.inference.scene_io import save_scene
    from ivid_tpu_torch.inference.viewsets import reorder
    from ivid_tpu_torch.utils.images import colorize_depth, save_image, save_image_grid

    scene = os.path.join(out, "scenes", f"scene_{suffix}.npz")
    if viewset == "uncond":
        save_image(os.path.join(out, "results", f"rgb_{suffix}.png"), samples[0, ..., :3] * 0.5 + 0.5)
    elif viewset == "random":
        save_image_grid(os.path.join(out, "grids", f"rgb_{suffix}.png"), samples[..., :3], nrow=2)
        save_image(os.path.join(out, "conds", f"rgb_{suffix}.png"), samples[0, ..., :3] * 0.5 + 0.5)
        save_image(os.path.join(out, "results", f"rgb_{suffix}.png"), samples[1, ..., :3] * 0.5 + 0.5)
    elif viewset == "3x9":
        save_image_grid(os.path.join(out, "grids", f"rgb_{suffix}.png"), reorder(samples[..., :3]), nrow=9)
        save_image_grid(os.path.join(out, "grids", f"depth_{suffix}.png"),
                        colorize_depth(samples[..., 3:]), nrow=9)
        save_image_grid(os.path.join(out, "conds", f"rgb_cond_{suffix}.png"),
                        reorder(conds["color"][..., :3]), nrow=9)
        save_image_grid(os.path.join(out, "conds", f"depth_cond_{suffix}.png"),
                        reorder(colorize_depth(conds["depth"])), nrow=9)
    else:
        raise NotImplementedError(viewset)
    save_scene(scene, meshes, colors)


def main(argv=None) -> dict:
    """Run the CLI; returns ``output_dir``, this rank's rows of every batch
    as ``samples`` (numpy [b/W, V, s, s, 4]) and ``conds`` (the pipeline's
    condition dicts, or None for the ``uncond`` viewset), the per-stage
    device milliseconds ``stage_ms`` (CUDA only) and the wall seconds. With
    ``--data_parallel`` it joins the process group of the launcher's
    environment and leaves it when it returns."""
    opt = parse_args(argv)
    from ivid_tpu_torch import parallel

    t_start = time.perf_counter()
    if not opt.data_parallel:
        return _sample(opt, torch.device(opt.device), t_start)
    device = parallel.init_from_env(opt.device)
    try:
        return _sample(opt, device, t_start)
    finally:
        parallel.shutdown()


def _broadcast(obj):
    """Rank 0's ``obj`` on every rank (itself without a process group)."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def _sample(opt, device, t_start) -> dict:
    from ivid_tpu_torch import parallel
    from ivid_tpu_torch.config import Config
    from ivid_tpu_torch.diffusion.noise import TorchNoise
    from ivid_tpu_torch.inference.pipeline import ScenePipeline
    from ivid_tpu_torch.inference.viewsets import build_viewset
    from ivid_tpu_torch.utils.images import parse_int_list
    from ivid_tpu_torch.utils.profiling import trace

    rank, world = parallel.rank(), parallel.world_size()
    cfg_uncond = Config.load(opt.config_uncond)
    cfg_cond = Config.load(opt.config_cond) if opt.viewset != "uncond" else None

    out = os.path.join(
        opt.output_dir,
        f"viewset_{opt.viewset}_steps_u{opt.steps_uncond}_c{opt.steps_cond}_guidance{opt.guidance}",
    )
    for sub in ["scenes", "conds", "grids", "results"]:
        os.makedirs(os.path.join(out, sub), exist_ok=True)

    if opt.num_samples is not None:
        num_samples, seeds = opt.num_samples, None
    else:
        seeds = parse_int_list(opt.seeds)
        num_samples = len(seeds)
    num_classes = cfg_uncond.backbone["args"].get("num_classes")
    classes = None
    if num_classes:
        seed_basis = seeds if seeds is not None else list(range(num_samples))
        if opt.classes == "mod":
            classes = [seed_basis[i] % num_classes for i in range(num_samples)]
        elif opt.classes == "random":
            classes = [np.random.randint(num_classes) for _ in range(num_samples)]
        elif opt.classes == "uniform":
            classes = [i % num_classes for i in range(num_samples)]
        else:
            classes = parse_int_list(opt.classes)

    sizes = {min(opt.batchsize, num_samples - start)
             for start in range(0, num_samples, opt.batchsize)}
    uneven = sorted(b for b in sizes if b % world)
    if uneven:
        raise ValueError(f"batches of {uneven} scenes do not split over {world} ranks: give a "
                         f"--batchsize and a sample count that {world} divides")
    modelviews = build_viewset(opt.viewset, num_samples)
    # The ranks share rank 0's random draws (classes and orbits).
    classes, modelviews = _broadcast((classes, modelviews))
    per_sample_views = isinstance(modelviews[0], list)

    fw_uncond = build_model(cfg_uncond, opt.ckpt_uncond, 0, device)
    fw_cond = build_model(cfg_cond, opt.ckpt_cond, 1, device) if cfg_cond is not None else None

    image_size = cfg_uncond.backbone["args"]["image_size"]
    pipe = ScenePipeline(
        fw_uncond, fw_cond, image_size=image_size, fov=opt.fov, near=opt.near,
        far=opt.far, atol=opt.atol, rtol=opt.rtol, erode_rgb=opt.erode_rgb,
        steps_uncond=opt.steps_uncond, steps_cond=opt.steps_cond,
        guidance=opt.guidance, max_agg_views=opt.max_agg_views, device=device,
    )

    all_samples, all_conds = [], []
    for start in range(0, num_samples, opt.batchsize):
        lb = min(opt.batchsize, num_samples - start) // world
        rows = range(start + rank * lb, start + (rank + 1) * lb)  # this rank's scenes
        b_classes = (torch.tensor([classes[i] for i in rows], device=device)
                     if classes is not None else None)
        noise = None
        if seeds is not None:
            noise = torch.cat([
                torch.randn((1, image_size, image_size, 4),
                            generator=torch.Generator().manual_seed(seeds[i]))
                for i in rows
            ])
        views = (np.asarray([modelviews[i] for i in rows])
                 if per_sample_views else np.asarray(modelviews))
        rng = TorchNoise.seeded(1234 + start, device)
        if world > 1:
            rng = parallel.RowShardNoise(rng, rank, world)
        profiled = opt.profile_dir is not None and start == 0
        with (trace(opt.profile_dir, cuda=device.type == "cuda", rank=rank) if profiled
              else contextlib.nullcontext()):
            state, samples, conds = pipe.sample_batch(rng, views, batch=lb, classes=b_classes,
                                                      noise=noise)
            samples = samples.cpu().numpy()
            conds = {k: v.cpu().numpy() for k, v in conds.items()} if conds else None
        if profiled:
            print(f"profiler trace of the first batch written to {opt.profile_dir}", flush=True)
        all_samples.append(samples)
        all_conds.append(conds)
        n_views = samples.shape[1]
        for j, i in enumerate(rows):
            suffix = []
            if classes is not None:
                suffix.append(f"class{classes[i]:03d}")
            suffix.append(f"seed{seeds[i]:05d}" if seeds is not None else f"{i:05d}")
            suffix = "_".join(suffix)
            meshes, colors = pipe.state_to_host_scene(state, j, n_views)
            s_conds = {k: v[j] for k, v in conds.items()} if conds is not None else None
            save_records(out, opt.viewset, suffix, samples[j], s_conds, meshes, colors)
            print(f"[{i + 1}/{num_samples}] saved {suffix}", flush=True)
    return {
        "output_dir": out,
        "samples": all_samples,
        "conds": all_conds,
        "stage_ms": pipe.stage_ms(),
        "seconds": time.perf_counter() - t_start,
    }


if __name__ == "__main__":
    res = main()
    stages = ", ".join(f"{k} {v:.1f} ms" for k, v in res["stage_ms"].items())
    print(f"done in {res['seconds']:.2f} s" + (f"; device time by stage: {stages}" if stages else ""))
