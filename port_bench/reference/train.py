"""The first steps of the inpaint trainer, plain PyTorch.

A frozen copy of what ``ivid_tpu_torch/training/trainer.py:InpaintTrainer``
computes in a step on one device: the step's noise split off the trainer's
source, the warp conditioning of every row (``warp_cond.synthesize_batch``
on its own source, ``split(B)`` of the step's preparation source), the
framework's eps-MSE loss, its gradient, AdamW (optax's defaults: betas
0.9/0.999, eps 1e-8, decoupled weight decay) and the EMA of the parameters
after every step, in float32 (``ema = ema·rate + param·(1−rate)``).
"""

from __future__ import annotations

import torch

from port_bench.reference import warp_cond


def ema_update(ema: dict, params: dict, rate: float) -> None:
    """``ema = ema·rate + param·(1−rate)``, leaf by leaf, in place."""
    with torch.no_grad():
        for k, p in params.items():
            ema[k].mul_(rate).add_(p.detach(), alpha=1.0 - rate)


def steps(fw, params: dict, batches, rng, *, augments, pose_std: float, near: float,
          far: float, lr: float, weight_decay: float, ema_rate: float,
          ema=ema_update) -> dict:
    """Run ``len(batches)`` steps from ``params`` (the model's parameters,
    ``{name: tensor}``, updated in place) on the ``x_0`` batches [B, s, s, 4]
    in [-1, 1]. Returns each step's ``losses``, the first step's gradient
    ``grad0``, the parameters' change ``change`` and the EMA's change
    ``ema_change`` after the last step (``{name: tensor}`` each). ``ema``
    updates the EMA after each step (a planted fault may replace it)."""
    start = {k: v.detach().clone() for k, v in params.items()}
    averaged = {k: v.clone() for k, v in start.items()}
    opt = torch.optim.AdamW(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay, foreach=False)
    losses, grad0 = [], None
    for x_0 in batches:
        rng, step_rng = rng.split()
        rng_prep, rng_loss = step_rng.split()
        rows = rng_prep.split(x_0.shape[0])
        with torch.no_grad():
            cond = warp_cond.synthesize_batch(x_0 * 0.5 + 0.5, rows, augments=augments,
                                              pose_std=pose_std, near=near, far=far)
        batch = {"x_0": x_0, **cond}
        opt.zero_grad(set_to_none=True)
        loss = fw.training_loss(rng_loss, batch)
        loss.backward()
        if grad0 is None:
            grad0 = {k: v.grad.detach().clone() for k, v in params.items()}
        opt.step()
        ema(averaged, params, ema_rate)
        losses.append(float(loss.detach()))
    change = {k: (v.detach() - start[k]) for k, v in params.items()}
    ema_change = {k: averaged[k] - start[k] for k in params}
    return {"losses": losses, "grad0": grad0, "change": change, "ema_change": ema_change}


def leaf_norms(tensors: dict) -> dict:
    """``{name: float}`` L2 norm of each leaf (in float64)."""
    return {k: float(v.double().norm()) for k, v in tensors.items()}


def worst_leaf_gap(got: dict, ref: dict, keep=None) -> float:
    """The widest gap between two sides' norms of a leaf, ``|got - ref|``,
    over the larger of the reference's norm of that leaf and of the median
    leaf; ``keep`` names the leaves that count (default all)."""
    names = [k for k in ref if keep is None or k in keep]
    vals = sorted(ref[k] for k in names)
    median = vals[len(vals) // 2] if vals else 0.0
    return max((abs(got[k] - ref[k]) / max(ref[k], median, 1e-30) for k in names),
               default=0.0)


def median_leaf_gap(got: dict, ref: dict, keep=None) -> float:
    """The median over the leaves of the same gap as :func:`worst_leaf_gap`."""
    names = [k for k in ref if keep is None or k in keep]
    vals = sorted(ref[k] for k in names)
    median = vals[len(vals) // 2]
    gaps = sorted(abs(got[k] - ref[k]) / max(ref[k], median, 1e-30) for k in names)
    return gaps[len(gaps) // 2]


def moving_mask(grad: dict, share: float = 1e-3) -> dict:
    """Per leaf, the elements whose reference gradient is at least ``share``
    of the median leaf's root-mean-square gradient. The others (as the key
    part of an attention block's qkv bias, nought to rounding under
    softmax) move under Adam by round-off alone and are left out of the
    change; a leaf with none left is left out whole."""
    rms = sorted(float(g.double().pow(2).mean().sqrt()) for g in grad.values())
    cut = share * rms[len(rms) // 2]
    return {k: g.abs() >= cut for k, g in grad.items()}


def masked_norms(tensors: dict, mask: dict) -> dict:
    """``{name: float}`` L2 norm of each leaf's kept elements (in float64),
    for the leaves with any kept."""
    out = {}
    for k, m in mask.items():
        if bool(m.any()):
            out[k] = float(tensors[k].to(m.device)[m].double().norm())
    return out
