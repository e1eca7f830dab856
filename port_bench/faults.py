"""Faults planted in the reference where it stands in the program's place,
to read how far each moves a training cell's numbers (the upper readings of
its limits). A fault is a dict: its ``framework`` maps a reference
framework to a broken one, its ``ema`` replaces the EMA's update
(:func:`port_bench.reference.train.ema_update`).

- ``half_batch``: the loss is the mean over the first half of the rows
  only; the other half is left out.
- ``row_altered``: one row's condition is altered where the warp produces
  it (its image condition and mask are blanked).
- ``ema_skipped``: the EMA is never updated.
- ``ema_thinned``: the EMA is updated after every other step only.
- ``ema_bf16``: the EMA is kept in bfloat16.

A step that returns its state unchanged needs no run: its change reads 1
by the worst-leaf measure.
"""

from __future__ import annotations

import torch

from port_bench.reference.train import ema_update


def half_batch(fw):
    loss = fw.training_loss

    def broken(rng, batch):
        half = batch["x_0"].shape[0] // 2
        return loss(rng, {k: v[:half] for k, v in batch.items()})

    fw.training_loss = broken
    return fw


def row_altered(fw):
    loss = fw.training_loss

    def broken(rng, batch):
        batch = dict(batch)
        for k, fill in (("y", -1.0), ("mask", 0.0), ("mask_rgb", 0.0)):
            if k in batch:
                v = batch[k].clone()
                v[0] = fill
                batch[k] = v
        return loss(rng, batch)

    fw.training_loss = broken
    return fw


def ema_skipped(ema, params, rate):
    pass


def ema_thinned():
    calls = [0]

    def update(ema, params, rate):
        calls[0] += 1
        if calls[0] % 2 == 0:
            ema_update(ema, params, rate)

    return update


def ema_bf16(ema, params, rate):
    ema_update(ema, params, rate)
    with torch.no_grad():
        for v in ema.values():
            v.copy_(v.to(torch.bfloat16))


def train_faults() -> dict:
    """A fresh set of the planted training faults, by name."""
    return {"half_batch": {"framework": half_batch},
            "row_altered": {"framework": row_altered},
            "ema_skipped": {"ema": ema_skipped},
            "ema_thinned": {"ema": ema_thinned()},
            "ema_bf16": {"ema": ema_bf16}}


# ---- faults planted in the program, under a sampling cell's timed path ----
# Each takes ``patch(obj, name, value)`` (pytest's ``monkeypatch.setattr``,
# or :class:`Patches` outside a test) and breaks the program's aggregation.

def condition_dropped(patch):
    """The aggregation's condition saw nothing: colour, depth and both
    masks zero on every pixel."""
    from ivid_tpu_torch.ops import warp

    original = warp.aggregate_conditions_batch

    def broken(*args, **kwargs):
        out = dict(original(*args, **kwargs))
        for k in ("color", "depth", "mask", "mask_rgb"):
            out[k] = torch.zeros_like(out[k])
        return out

    patch(warp, "aggregate_conditions_batch", broken)


def condition_shifted(patch):
    """The aggregation's condition one pixel to the right of where it was
    rendered."""
    from ivid_tpu_torch.ops import warp

    original = warp.aggregate_conditions_batch

    def broken(*args, **kwargs):
        return {k: torch.roll(v, 1, dims=-2)
                for k, v in original(*args, **kwargs).items()}

    patch(warp, "aggregate_conditions_batch", broken)


SAMPLE_PROGRAM_FAULTS = {"condition_dropped": condition_dropped,
                         "condition_shifted": condition_shifted}


class Patches:
    """``patch(obj, name, value)`` that :meth:`undo` reverts."""

    def __init__(self):
        self._saved = []

    def __call__(self, obj, name, value):
        self._saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self):
        while self._saved:
            obj, name, value = self._saved.pop()
            setattr(obj, name, value)
