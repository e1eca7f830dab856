"""The stages of one batch of multiview scenes, plain PyTorch.

A frozen copy of what ``ivid_tpu_torch/inference/pipeline.py:ScenePipeline.
sample_batch`` computes: the first view by (guided) strided DDIM of the
uncond model, its lift to a frustum-skirted grid mesh, and for each novel
view the aggregated RGBD condition of all earlier views and its completion
by guided DDIM with the replace/constrain edits (weights 0.1/0.2/0.5). The
noise sources are split as ``sample_batch`` splits them.

:func:`check_batch` follows a finished batch stage by stage: the first view
from the batch's noise, and each novel view's condition and completion from
the views the judged side produced before it (teacher forcing), so that one
stage's rounding does not carry into the next stage's reading.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from port_bench.reference import diffusion
from port_bench.reference import geometry as geom
from port_bench.reference import warp as warp_ops


def scene_sources(rng, n_views: int):
    """``(r0, rn, [r1 … r_{V-1}])``: the uncond sampler's source, the first
    view's noise source and each novel view's, split as ``sample_batch``
    splits them (noise drawn by the pipeline)."""
    rng, r0 = rng.split()
    rng, rn = rng.split()
    novel = []
    for _ in range(1, n_views):
        rng, rj = rng.split()
        novel.append(rj)
    return r0, rn, novel


def first_view(fw, r0, rn, batch: int, image_size: int, classes, p: dict):
    noise = rn.normal((batch, image_size, image_size, 4))
    cond = {"classes": classes} if classes is not None else None
    return diffusion.ddim_sample(fw, r0, noise=noise, cond=cond, guidance=p["guidance"],
                                 steps=p["steps_uncond"])


def make_meshes(rgbd01, modelview, p: dict) -> geom.Mesh:
    """The batched depth → mesh lift of views in [0, 1]."""
    return geom.stack_meshes([
        geom.depth_to_mesh(
            geom.linearize_depth(x[..., 3:], p["near"], p["far"]),
            padding="frustum", fov=p["fov"], modelview=mv, atol=p["atol"],
            rtol=p["rtol"], erode_rgb=p["erode_rgb"], cal_normal=True)
        for x, mv in zip(rgbd01, modelview)
    ])


def aggregate(views01, mvs, j: int, p: dict) -> dict:
    """The condition of view ``j`` from views ``0 … j-1`` ([B, s, s, 4] each,
    in [0, 1]) under the per-sample cameras ``mvs`` [B, V, 4, 4]."""
    meshes = geom.stack_meshes([make_meshes(v, mvs[:, k], p) for k, v in enumerate(views01)],
                               dim=1)
    colors = torch.stack([v[..., :3] for v in views01], dim=1)
    return warp_ops.aggregate_conditions_batch(
        meshes, colors, mvs[:, j], fov=p["fov"], near=p["near"], far=p["far"],
        atol=p["atol"], rtol=p["rtol"], erode_rgb=p["erode_rgb"], ssaa=p["ssaa"])


def complete_view(fw, rj, agg: dict, classes, image_size: int, p: dict):
    color2 = agg["color"] * 2 - 1
    depth2 = agg["depth"] * 2 - 1
    cond = {"y": torch.cat([color2, depth2], dim=-1), "mask": agg["mask"],
            "mask_rgb": agg["mask_rgb"]}
    if classes is not None:
        cond["classes"] = classes
    edits = diffusion.PredX0Edits(
        replace_rgb=(0.1, color2, agg["mask_rgb"]),
        replace_depth=(0.2, depth2, agg["mask"]),
        constrain_depth=(0.5, agg["depth_convex"] * 2 - 1))
    return diffusion.ddim_sample(fw, rj, num=agg["color"].shape[0], image_size=image_size,
                                 cond=cond, guidance=p["guidance"], steps=p["steps_cond"],
                                 edits=edits)


def rel_l2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per sample ``|a - b| / |b|`` over all but the leading axis."""
    a, b = a.double().flatten(1), b.double().flatten(1)
    return (a - b).norm(dim=1) / b.norm(dim=1).clamp(min=1e-30)


def check_batch(judged: dict, fw_uncond, fw_cond, rng, mvs, classes, p: dict) -> dict:
    """Readings of one finished batch against the reference frameworks.

    ``judged``: ``samples`` [B, V, s, s, 4] in [-1, 1] and ``conds``
    (``color`` [B, V-1, s, s, 3], ``depth`` [B, V-1, s, s, 1], each
    condition ``·2 − 1``; None without novel views), as ``sample_batch``
    returns them. Returns the worst sample's relative L2 distance of the
    first views (``uncond_rel``), of the completed views (``cond_rel``) and,
    where ``conds`` is given, of the conditions (``agg_rel``): each novel
    view's condition and completion by the reference come from the judged
    views before it."""
    samples, conds = judged["samples"], judged.get("conds")
    b, n_views, s = samples.shape[0], samples.shape[1], samples.shape[2]
    r0, rn, novel = scene_sources(rng, n_views)
    x0 = first_view(fw_uncond, r0, rn, b, s, classes, p)
    out = {"uncond_rel": float(rel_l2(samples[:, 0], x0).max())}
    cond_rel, agg_rel = [], []
    views01 = [samples[:, 0] * 0.5 + 0.5]
    for j in range(1, n_views):
        agg = aggregate(views01, mvs, j, p)
        if conds is not None:
            agg_rel.append(condition_gap(conds, agg, j))
        xj = complete_view(fw_cond, novel[j - 1], agg, classes, s, p)
        cond_rel.append(rel_l2(samples[:, j], xj))
        views01.append(samples[:, j] * 0.5 + 0.5)
    if cond_rel:
        out["cond_rel"] = float(torch.stack(cond_rel).max())
    if agg_rel:
        out["agg_rel"] = float(torch.stack(agg_rel).max())
    return out


def condition_gap(conds: dict, agg: dict, j: int) -> torch.Tensor:
    """Per sample, the judged condition of view ``j`` against the
    reference's ``agg``: the L2 distance in the judged side's ``·2 − 1``
    form, over the L2 norm of the reference's colour and depth condition
    (0 where both saw nothing)."""
    got = torch.cat([conds["color"][:, j - 1], conds["depth"][:, j - 1]], dim=-1)
    ref01 = torch.cat([agg["color"], agg["depth"]], dim=-1)
    gap = (got.to(ref01.device).double() - (ref01 * 2 - 1).double()).flatten(1).norm(dim=1)
    return gap / (2 * ref01.double().flatten(1).norm(dim=1)).clamp(min=1e-30)


def run_batch(fw_uncond, fw_cond, rng, mvs, classes, batch: int, image_size: int, p: dict,
              view_round: Optional[Callable] = None) -> torch.Tensor:
    """The whole batch by the reference, each view from its own earlier
    views: ``samples`` [B, V, s, s, 4] as ``sample_batch`` returns them.
    With ``view_round``, each finished view is passed through it before it
    is lifted and aggregated (the control's lower-precision geometry)."""
    n_views = mvs.shape[1]
    r0, rn, novel = scene_sources(rng, n_views)
    views = [first_view(fw_uncond, r0, rn, batch, image_size, classes, p)]
    rnd = view_round or (lambda x: x)
    for j in range(1, n_views):
        agg = aggregate([rnd(v * 0.5 + 0.5) for v in views], mvs, j, p)
        views.append(complete_view(fw_cond, novel[j - 1], agg, classes, image_size, p))
    return torch.stack(views, dim=1)
