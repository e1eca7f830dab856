"""The noise source every random draw of the samplers, frameworks and
pipeline goes through.

Its ``split``/``fold_in`` calls follow the key derivation of the JAX package
(``jax.random.split`` / ``fold_in``) step for step, so an implementation that
replays ``jax.random`` keys reproduces the JAX chain's noise exactly (the
tests do this). A source draws ``normal``, ``uniform`` and ``randint``
samples. The default, :class:`TorchNoise`, ignores the derivation and draws
every sample in call order from one ``torch.Generator``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch


class TorchNoise:
    """Standard normal draws from one ``torch.Generator``, on its device.
    ``split`` and ``fold_in`` return the source itself, so draws are
    sequential in call order."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    @classmethod
    def seeded(cls, seed: int, device=None) -> "TorchNoise":
        return cls(torch.Generator(device=device or "cpu").manual_seed(seed))

    def split(self, num: int = 2) -> Tuple["TorchNoise", ...]:
        return (self,) * num

    def fold_in(self, i: int) -> "TorchNoise":
        del i
        return self

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        """Float32 samples of ``shape``."""
        return torch.randn(tuple(shape), generator=self.generator,
                           device=self.generator.device)

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        """Float32 samples of ``shape`` from U[0, 1)."""
        return torch.rand(tuple(shape), generator=self.generator,
                          device=self.generator.device)

    def randint(self, shape: Sequence[int], low: int, high: int) -> torch.Tensor:
        """Int64 samples of ``shape`` from {low, ..., high - 1}."""
        return torch.randint(low, high, tuple(shape), generator=self.generator,
                             device=self.generator.device)

    def state_dict(self) -> dict:
        return {"generator": self.generator.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self.generator.set_state(state["generator"])
