"""Faults planted in the program under an ``sr`` cell's timed path, to read
how far each moves ``sr_rel`` (the upper readings of its limit). Each takes
``patch(obj, name, value)`` (pytest's ``monkeypatch.setattr``, or
:class:`port_bench.faults.Patches` outside a test) and breaks the program's
``SuperResCFG``:

- ``condition_dropped``: the low-resolution views are zeroed before they
  are packed (the model sees a flat grey condition).
- ``condition_shifted``: the views are rolled by 8 low-resolution pixels
  along their width before they are packed.
- ``guidance_off``: every step runs one forward with the class, without
  classifier-free guidance.
"""

from __future__ import annotations

import torch

SHIFT = 8


def _wrap_pack(patch, change_y):
    from ivid_tpu_torch.diffusion import frameworks

    original = frameworks.SuperResCFG.pack_inputs

    def broken(self, rng, x, cond):
        return original(self, rng, x, dict(cond, y=change_y(cond["y"])))

    patch(frameworks.SuperResCFG, "pack_inputs", broken)


def condition_dropped(patch):
    _wrap_pack(patch, torch.zeros_like)


def condition_shifted(patch):
    _wrap_pack(patch, lambda y: torch.roll(y, SHIFT, dims=-2))


def guidance_off(patch):
    from ivid_tpu_torch.diffusion import frameworks

    original = frameworks.SuperResCFG.model_inference

    def broken(self, rng, x, t, cond=None, guidance=0.0):
        return original(self, rng, x, t, cond, 0.0)

    patch(frameworks.SuperResCFG, "model_inference", broken)


SR_PROGRAM_FAULTS = {"condition_dropped": condition_dropped,
                     "condition_shifted": condition_shifted, "guidance_off": guidance_off}
