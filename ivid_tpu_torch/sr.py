"""Super-resolution cascade CLI: ``python -m ivid_tpu_torch.sr --scene_dir DIR``.

The port of the repo's ``sr.py``, with its flags, plus ``--device`` (default
``cuda``; ``cpu`` runs the kernels' plain versions). It reads the scenes
that ``python -m ivid_tpu_torch.sample`` wrote (``{scene_dir}/scenes/*.npz``),
upsamples every view with the SR model (``SuperResCFG``, guided DDIM, 50
steps by default) and writes ``{output_dir}/results_sr/{name}.png`` (the
first view) and, with ``--save_scenes``, ``scenes_sr/{name}.npz`` (each view
lifted to a frustum-skirted mesh, as the sampling pipeline does).

- ``--ckpt_sr random`` draws every parameter from numpy seed 0; any other
  value is a model or EMA file: a ``.pt`` state dict (the port's or the
  reference's) or a JAX package ``.msgpack`` file.
- ``--classes mod`` conditions a scene on ``seed % num_classes``, the seed
  parsed from its file name (``sample``'s default class choice); a name
  without ``seed<digits>``, or ``--classes none``, samples without CFG.
- The views of a scene go through in ``--batchsize`` chunks; the chunk of
  scene ``si`` that starts at view ``i`` draws its noise from seed
  ``1000 * si + i``.
"""

from __future__ import annotations

import argparse
import functools
import glob
import os
import re
import time

import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config_sr", type=str,
                   default="configs/rgbd_imagenet_adm_256_128_small_sr.json")
    p.add_argument("--ckpt_sr", type=str, default="ckpts/imagenet256_sr.pt")
    p.add_argument("--scene_dir", type=str, required=True, help="sample's output dir")
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--guidance", type=float, default=3.0)
    p.add_argument("--classes", type=str, default="mod", choices=["mod", "none"],
                   help="mod: class = seed %% num_classes parsed from the scene file name; "
                        "none: unconditional")
    p.add_argument("--batchsize", type=int, default=27)
    p.add_argument("--near", type=float, default=0.6)
    p.add_argument("--far", type=float, default=5.0)
    p.add_argument("--save_scenes", action="store_true")
    p.add_argument("--max_scenes", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def scene_class(name: str, num_classes, classes: str):
    """The class a scene was sampled with, or None (no CFG)."""
    if not num_classes or classes != "mod":
        return None
    m = re.search(r"seed(\d+)", name)
    return int(m.group(1)) % num_classes if m else None


def main(argv=None, noise=None) -> dict:
    """Run the CLI; returns ``output_dir``, the upsampled views of each scene
    (``samples``, numpy [V, S, S, 4] in [0, 1]), the device milliseconds per
    stage ``stage_ms`` (load, sr, mesh; CUDA only) and the wall seconds.
    ``noise(seed)``, when given, makes the noise source of a chunk (default:
    a ``TorchNoise`` seeded with ``seed`` on the device)."""
    opt = parse_args(argv)
    from ivid_tpu_torch.config import Config
    from ivid_tpu_torch.diffusion import samplers
    from ivid_tpu_torch.diffusion.noise import TorchNoise
    from ivid_tpu_torch.inference.pipeline import StageClock
    from ivid_tpu_torch.inference.scene_io import load_scene, save_scene
    from ivid_tpu_torch.ops import geometry as geom
    from ivid_tpu_torch.sample import build_model
    from ivid_tpu_torch.utils.images import save_image

    t_start = time.perf_counter()
    device = torch.device(opt.device)
    noise = noise or functools.partial(TorchNoise.seeded, device=device)
    cfg = Config.load(opt.config_sr)
    fw = build_model(cfg, opt.ckpt_sr, 0, device)
    s_hi = cfg.backbone["args"]["image_size"]
    num_classes = cfg.backbone["args"].get("num_classes")
    clock = StageClock(device, "sr")

    out_dir = opt.output_dir or opt.scene_dir
    os.makedirs(os.path.join(out_dir, "results_sr"), exist_ok=True)
    if opt.save_scenes:
        os.makedirs(os.path.join(out_dir, "scenes_sr"), exist_ok=True)
    scenes = sorted(glob.glob(os.path.join(opt.scene_dir, "scenes", "*.npz")))
    if opt.max_scenes:
        scenes = scenes[:opt.max_scenes]
    print(f"Found {len(scenes)} scenes.")

    all_samples = []
    for si, scene_path in enumerate(scenes):
        name = os.path.basename(scene_path)[:-4]
        cls = scene_class(name, num_classes, opt.classes)
        with clock("load"):
            meshes, colors = load_scene(scene_path, device=device)
            views = torch.stack([
                torch.cat([torch.from_numpy(c).to(device),
                           geom.project_depth(m.depth, opt.near, opt.far)], dim=-1)
                for m, c in zip(meshes, colors)])
        out_views = []
        for i in range(0, len(views), opt.batchsize):
            y = views[i:i + opt.batchsize] * 2 - 1
            cond, guidance = {"y": y}, 0.0
            if cls is not None:
                cond["classes"] = torch.full((y.shape[0],), cls, dtype=torch.long, device=device)
                guidance = opt.guidance
            with clock("sr"):
                out = samplers.ddim_sample(fw, noise(1000 * si + i), num=y.shape[0],
                                           image_size=s_hi, cond=cond, guidance=guidance,
                                           steps=opt.steps)["samples"]
            out_views.append(out * 0.5 + 0.5)
        out_views = torch.cat(out_views)
        host = out_views.cpu().numpy()
        all_samples.append(host)
        save_image(os.path.join(out_dir, "results_sr", f"{name}.png"), host[0, ..., :3])
        if opt.save_scenes:
            with clock("mesh"):
                sr_meshes = [
                    geom.depth_to_mesh(
                        geom.linearize_depth(v[..., 3:], opt.near, opt.far), padding="frustum",
                        fov=mesh.fov, modelview=mesh.modelview, atol=0.03, rtol=0.03,
                        erode_rgb=3, cal_normal=True,
                    ).map(lambda x: x.cpu().numpy())
                    for v, mesh in zip(out_views, meshes)]
            save_scene(os.path.join(out_dir, "scenes_sr", f"{name}.npz"), sr_meshes,
                       [v[..., :3] for v in host])
        print(f"[{si + 1}/{len(scenes)}] SR {name}: {host.shape}", flush=True)
    return {
        "output_dir": out_dir,
        "samples": all_samples,
        "stage_ms": clock.totals(),
        "seconds": time.perf_counter() - t_start,
    }


if __name__ == "__main__":
    res = main()
    stages = ", ".join(f"{k} {v:.1f} ms" for k, v in res["stage_ms"].items())
    print(f"done in {res['seconds']:.2f} s" + (f"; device time by stage: {stages}" if stages else ""))
