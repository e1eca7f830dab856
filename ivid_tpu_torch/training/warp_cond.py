"""Per-sample warp-conditioning synthesis of the inpaint trainer.

Port of ``ivid_tpu/training/warp_cond.py``. The trainer synthesizes the cond
model's input from each clean RGBD sample: a random orbit pose
(:func:`presample`), the forward-backward warp (batched over the whole batch
by the trainer, per sample in :func:`synthesize_single`), and the post-warp
augments (:func:`postprocess`). Every draw goes through the noise source in
the JAX package's key layout: one source ``r`` per sample; :func:`presample`
draws from ``r.split(8)[0:6]``, :func:`postprocess` from ``r.split(8)[6:8]``
and ``r.fold_in(99).split(4)``.
"""

from __future__ import annotations

import torch

from ivid_tpu_torch.ops import camera as cam
from ivid_tpu_torch.ops import geometry as geom
from ivid_tpu_torch.ops import image as im_ops
from ivid_tpu_torch.ops import warp as warp_ops
from ivid_tpu_torch.utils.profiling import span


def presample(rgbd01, r, *, augments, pose_std):
    """Pre-warp augment and random orbit pose for one [s,s,4] sample in
    [0, 1]. Returns ``(rgbd_in, modelview1 [4,4], pose [theta, phi])``."""
    dev = rgbd01.device
    rs = r.split(8)
    rgbd_in = rgbd01
    if "prewarp_noise" in augments:
        sigma = 0.005 * rs[0].uniform(()).to(dev)
        rgbd_in = rgbd_in + sigma * rs[1].normal(rgbd_in.shape).to(dev)
    theta = pose_std * rs[2].normal(()).to(dev)
    phi = pose_std * rs[3].normal(()).to(dev)
    radius = 1.0 + 0.1 * rs[4].normal(()).to(dev)
    center = 0.05 * rs[5].normal((3,)).to(dev)
    eye = torch.stack([
        radius * torch.cos(phi) * torch.sin(theta),
        radius * torch.sin(phi),
        radius * torch.cos(phi) * torch.cos(theta),
    ])
    mv1 = cam.look_at(eye, center, torch.tensor([0.0, 1.0, 0.0], device=dev))
    return rgbd_in, mv1, torch.stack([theta, phi])


def postprocess(rgbd01, r, color, depth, mask, *, augments):
    """Post-warp augments of one sample: noise, blur, RGB-mask erosion,
    masking and the [0,1] → [-1,1] rescale of all four channels. Returns
    ``{"y", "mask"[, "mask_rgb"]}``."""
    dev = rgbd01.device
    rs = r.split(8)
    y = torch.cat([color, depth], dim=-1)
    if "postwarp_noise" in augments:
        sigma = 0.03 * rs[6].uniform(()).to(dev)
        y = y + sigma * rs[7].normal(y.shape).to(dev)

    extra = r.fold_in(99).split(4)
    if "blur" in augments:
        blurred = im_ops.gaussian_blur_random_sigma(extra[0], rgbd01[..., :3])
        use_blur = extra[1].uniform(()).to(dev) < 0.8
        y = torch.cat([torch.where(use_blur, blurred, y[..., :3]), y[..., 3:]], dim=-1)

    out = {}
    if "erode_rgb" in augments:
        # Radius uniform in {0, ..., 4}.
        radius = int(extra[2].randint((), 0, 5))
        mask_rgb = geom.erode(mask, radius)
        y = torch.cat([y[..., :3] * mask_rgb, y[..., 3:]], dim=-1)
        out["mask_rgb"] = mask_rgb
    y = y * mask
    y = y * 2 - 1
    out.update({"y": y, "mask": mask})
    return out


def synthesize_single(rgbd01, r, *, augments, pose_std, near, far):
    """The whole conditioning of one [s,s,4] sample in [0,1]: pose draw,
    forward-backward warp (padding = the image size), post augments.
    Returns ``{"y", "mask", "pose"[, "mask_rgb"]}``."""
    augments = tuple(augments)
    rgbd_in, mv1, pose = presample(rgbd01, r, augments=augments, pose_std=pose_std)
    res = warp_ops.forward_backward_warp(rgbd_in, mv1, padding=rgbd01.shape[0], near=near,
                                         far=far)
    out = postprocess(rgbd01, r, res["color"], res["depth"], res["mask"], augments=augments)
    out["pose"] = pose
    return out


def synthesize_batch(rgbd01, rngs, *, augments, pose_std, near, far):
    """:func:`synthesize_single` over a [B,s,s,4] batch with one noise source
    per sample, the warp batched over the whole batch. Returns the same keys
    with a leading batch axis. Under torch.profiler its three parts are the
    spans ``warp_cond.presample``, ``warp_cond.warp`` and
    ``warp_cond.postprocess``."""
    augments = tuple(augments)
    with span("warp_cond.presample"):
        pre = [presample(x, r, augments=augments, pose_std=pose_std)
               for x, r in zip(rgbd01, rngs)]
    with span("warp_cond.warp"):
        res = warp_ops.forward_backward_warp_batch(
            torch.stack([p[0] for p in pre]), torch.stack([p[1] for p in pre]),
            padding=rgbd01.shape[1], near=near, far=far,
        )
    with span("warp_cond.postprocess"):
        posts = [
            postprocess(x, r, res["color"][i], res["depth"][i], res["mask"][i],
                        augments=augments)
            for i, (x, r) in enumerate(zip(rgbd01, rngs))
        ]
        out = {k: torch.stack([p[k] for p in posts]) for k in posts[0]}
    out["pose"] = torch.stack([p[2] for p in pre])
    return out
