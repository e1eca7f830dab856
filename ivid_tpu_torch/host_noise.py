"""A noise source that draws on the CPU and moves the draws to a device, so
that a run on the card and one on the CPU see the same noise (the chains
that ``chip_smoke.py`` holds to the CPU path, and seeded bench inputs)."""

from __future__ import annotations

import torch


class HostNoise:
    """The sampler's and trainer's noise interface (``split``, ``fold_in``,
    ``normal``, ``uniform``, ``randint``) over one seeded CPU generator, the
    draws moved to ``device``."""

    def __init__(self, seed, device):
        self.gen = torch.Generator().manual_seed(seed)
        self.device = device

    def split(self, num=2):
        return (self,) * num

    def fold_in(self, i):
        return self

    def normal(self, shape):
        return torch.randn(tuple(shape), generator=self.gen).to(self.device)

    def uniform(self, shape):
        return torch.rand(tuple(shape), generator=self.gen).to(self.device)

    def randint(self, shape, low, high):
        return torch.randint(low, high, tuple(shape), generator=self.gen).to(self.device)
