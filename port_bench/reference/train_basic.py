"""The first steps of the basic trainer, plain PyTorch.

A frozen copy of what ``ivid_tpu_torch/training/trainer.py:BasicTrainer``
computes in a step on one device, without the inpaint trainer's warp: the
step's source split off the trainer's (``rng, step = rng.split()``), the
step's preparation and loss sources split off that (the preparation's is
unused: the basic trainer hands the batch on as it is), the framework's
eps-MSE loss with classifier-free guidance's label drop (labels set to the
null class -1 with ``p_uncond``), its gradient, AdamW (optax's defaults)
and the EMA of the parameters after every step, in float32. The optimizer,
the EMA and the norms are those of :mod:`port_bench.reference.train`.
"""

from __future__ import annotations

import torch

from port_bench.reference.train import ema_update


def steps(fw, params: dict, batches, rng, *, lr: float, weight_decay: float,
          ema_rate: float, ema=ema_update) -> dict:
    """Run ``len(batches)`` steps from ``params`` (``{name: tensor}``, updated
    in place) on the batches ``{"x_0": [B, s, s, 4] in [-1, 1], "classes":
    [B]}``. Returns each step's ``losses``, the first step's gradient
    ``grad0``, and the change of the parameters ``change`` and of the EMA
    ``ema_change`` after the last step, as
    :func:`port_bench.reference.train.steps` does."""
    start = {k: v.detach().clone() for k, v in params.items()}
    averaged = {k: v.clone() for k, v in start.items()}
    opt = torch.optim.AdamW(list(params.values()), lr=lr, betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=weight_decay, foreach=False)
    losses, grad0 = [], None
    for batch in batches:
        rng, step_rng = rng.split()
        _, rng_loss = step_rng.split()
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
