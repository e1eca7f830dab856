"""Free-view fusion rendering CLI: ``python -m ivid_tpu_torch.render --scene_dir DIR``.

The port of the repo's ``render.py``, with its flags, plus ``--device``
(default ``cuda``; ``cpu`` runs the kernels' plain versions, and ``cuda``
without a card raises). It loads the scenes that ``python -m
ivid_tpu_torch.sample`` (or ``sr --save_scenes``) wrote
(``{scene_dir}/scenes/*.npz``) and renders each with the aggregation
renderer at ``--ssaa`` times the views' size: every frame is one K2 raster
over all of the scene's views. Then the color is Lanczos-resized to the
views' size and the depth subsampled at pixel centres.

- ``--traj swing``: a ``--frames`` orbit sweep, written as
  ``videos/{name}.mp4`` and ``videos/{name}_depth.mp4`` (the depth
  tone-mapped with ``project_depth``'s default near/far, 0.5 and 100, not
  the renderer's 0.1 and 200, as the reference does); ``--save_frames``
  also writes ``videos/{name}/{k:03d}.png``.
- ``--traj random``: one random pose, written as ``results/{name}.png``.

Videos go through OpenCV's mp4v writer, else imageio (mp4 with
imageio-ffmpeg, GIF without). Where neither library is installed the frames
are written as PNG files with the port's own encoder, into
``videos/{name}/`` and ``videos/{name}_depth/``, and a note says so.

The JAX CLI passes ``interior_level=ssaa + 1`` to its renderer; only its
hybrid fragment raster reads it (a sample lattice per triangle). The port
renders in full mode alone, with exact pixel-centre coverage, so it has no
lattice to set. It renders the scene's live views only; the JAX CLI pads to
27 slots with views that contribute nothing.
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--scene_dir", type=str, required=True)
    p.add_argument("--output_dir", type=str, default=None)
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--traj", type=str, default="swing", choices=["swing", "random"])
    p.add_argument("--atol", type=float, default=0.03)
    p.add_argument("--rtol", type=float, default=0.03)
    p.add_argument("--erode_rgb", type=int, default=3)
    p.add_argument("--ssaa", type=int, default=5)
    p.add_argument("--max_scenes", type=int, default=None)
    p.add_argument("--save_frames", action="store_true")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def write_pngs(directory: str, frames) -> None:
    """uint8 [H,W,3] ``frames`` as ``{directory}/{k:03d}.png``."""
    from ivid_tpu_torch.utils.images import png_encode

    os.makedirs(directory, exist_ok=True)
    for k, fr in enumerate(frames):
        with open(os.path.join(directory, f"{k:03d}.png"), "wb") as f:
            f.write(png_encode(fr))


def save_video(path_stem: str, frames, fps: int = 30) -> str:
    """Write uint8 RGB ``frames`` as ``{path_stem}.mp4`` (OpenCV's mp4v, else
    imageio with ffmpeg), ``.gif`` (imageio without ffmpeg), or, with
    neither library, PNG files in the directory ``path_stem``. Returns the
    path written."""
    try:
        import cv2

        out = path_stem + ".mp4"
        h, w = frames[0].shape[:2]
        vw = cv2.VideoWriter(out, cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h))
        if vw.isOpened():
            for f in frames:
                vw.write(np.ascontiguousarray(f[..., ::-1]))  # RGB -> BGR
            vw.release()
            return out
        vw.release()
    except ImportError:
        pass
    try:
        import imageio.v2 as imageio
    except ImportError:
        write_pngs(path_stem, frames)
        print(f"note: neither OpenCV nor imageio is installed: wrote {len(frames)} PNG frames "
              f"to {path_stem}/ instead of {path_stem}.mp4.")
        return path_stem
    try:
        import imageio_ffmpeg  # noqa: F401 (presence check only)

        out = path_stem + ".mp4"
        imageio.mimsave(out, frames, fps=fps)
        return out
    except ImportError:
        out = path_stem + ".gif"
        imageio.mimsave(out, frames, duration=1 / fps, loop=0)
        print(f"note: no mp4 writer found (cv2 codec-less, no ffmpeg): wrote GIF instead of "
              f"{path_stem}.mp4.")
        return out


# The renderer's clip planes (the depth images are tone-mapped with
# project_depth's own defaults instead, as the reference does).
NEAR, FAR = 0.1, 200.0


def render_frame(meshes, colors: torch.Tensor, modelview: torch.Tensor, ssaa: int, clock):
    """One frame: the aggregation render at ``s * ssaa`` (``colors`` [N,s,s,3]),
    the color Lanczos-resized to ``s`` (8-bit), the linear depth subsampled
    at pixel centres. Returns color [s,s,3] and depth [s,s,1]. ``clock`` is
    a ``StageClock``."""
    from ivid_tpu_torch.ops import image as im_ops
    from ivid_tpu_torch.ops import renderer as rend

    s = colors.shape[1]
    with clock("render"):
        res = rend.render_aggregation(meshes, colors, modelview, fov=45.0,
                                      render_size=s * ssaa, near=NEAR, far=FAR)
    with clock("resize"):
        color = im_ops.resize_lanczos_8bit(res["color"], s)
        depth = im_ops.ssaa_subsample(res["depth"], ssaa)
    return color, depth


def main(argv=None) -> dict:
    """Run the CLI; returns ``output_dir``, the frames of each scene
    (``frames[name] = (color, depth)``, uint8 [F, s, s, 3] each; depth is
    the INFERNO image), the device milliseconds per stage ``stage_ms``
    (load, render, resize, write; CUDA only), the number of frames rendered
    and the wall seconds."""
    opt = parse_args(argv)
    from ivid_tpu_torch.inference.pipeline import StageClock
    from ivid_tpu_torch.inference.scene_io import load_scene
    from ivid_tpu_torch.inference.viewsets import random_trajectory, swing_trajectory
    from ivid_tpu_torch.ops import geometry as geom
    from ivid_tpu_torch.utils.images import colorize_depth, png_encode, to8b

    device = torch.device(opt.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("render: no CUDA device (pass --device cpu to render on the CPU)")
    t_start = time.perf_counter()
    clock = StageClock(device, "render")
    out_dir = opt.output_dir or opt.scene_dir
    os.makedirs(os.path.join(out_dir, "results"), exist_ok=True)
    os.makedirs(os.path.join(out_dir, "videos"), exist_ok=True)
    scenes = sorted(glob.glob(os.path.join(opt.scene_dir, "scenes", "*.npz")))
    if opt.max_scenes:
        scenes = scenes[:opt.max_scenes]
    print(f"Found {len(scenes)} scenes.")

    frames, n_frames = {}, 0
    for i, scene_path in enumerate(scenes):
        name = os.path.basename(scene_path)[:-4]
        with clock("load"):
            meshes, colors = load_scene(scene_path, atol=opt.atol, rtol=opt.rtol,
                                        erode_rgb=opt.erode_rgb, device=device)
            meshes = geom.stack_meshes(meshes)
            colors = torch.from_numpy(np.stack(colors)).to(device)
        if opt.traj == "random":
            poses = [random_trajectory()]
        else:
            poses = swing_trajectory(opt.frames)
        frames_c, frames_d = [], []
        for mv in poses:
            color, depth = render_frame(meshes, colors, torch.from_numpy(mv).to(device),
                                        opt.ssaa, clock)
            with clock("write"):
                frames_c.append(to8b(color.cpu().numpy()))
                d = geom.project_depth(depth, 0.5, 100.0)[..., 0].cpu().numpy()
                frames_d.append(to8b(colorize_depth(d, vmin=0, vmax=1)))
        n_frames += len(poses)
        with clock("write"):
            if opt.traj == "random":
                with open(os.path.join(out_dir, "results", f"{name}.png"), "wb") as f:
                    f.write(png_encode(frames_c[0]))
            else:
                save_video(os.path.join(out_dir, "videos", name), frames_c)
                save_video(os.path.join(out_dir, "videos", f"{name}_depth"), frames_d)
                if opt.save_frames:
                    write_pngs(os.path.join(out_dir, "videos", name), frames_c)
        frames[name] = (np.stack(frames_c), np.stack(frames_d))
        print(f"[{i + 1}/{len(scenes)}] rendered {name}", flush=True)
    return {
        "output_dir": out_dir,
        "frames": frames,
        "n_frames": n_frames,
        "stage_ms": clock.totals(),
        "seconds": time.perf_counter() - t_start,
    }


if __name__ == "__main__":
    res = main()
    stages = ", ".join(f"{k} {v:.1f} ms" for k, v in res["stage_ms"].items())
    print(f"done: {res['n_frames']} frames in {res['seconds']:.2f} s"
          + (f"; device time by stage: {stages}" if stages else ""))
