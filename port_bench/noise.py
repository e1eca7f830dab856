"""The benchmark's noise source: every random draw of a run's inputs.

A source is a 63-bit key. ``split`` and ``fold_in`` derive child keys by
hashing, in the key layout of the JAX package (``jax.random.split`` /
``fold_in``), which the port's samplers, frameworks, pipeline and trainer
follow; each draw seeds a fresh ``torch.Generator`` on the source's device
from its key. So a source's numbers depend only on how it was derived, not
on what was drawn before, and the program and the reference, handed sources
derived alike, draw the same numbers whatever order they draw them in.
"""

from __future__ import annotations

import hashlib
from typing import Sequence, Tuple

import torch


def derive(key: int, *path) -> int:
    """A 63-bit key from ``key`` and the derivation ``path``."""
    digest = hashlib.blake2b(repr((int(key),) + path).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


class Noise:
    """Counter-based draws from a 63-bit key (the interface of the port's
    noise sources: ``split``, ``fold_in``, ``normal``, ``uniform``,
    ``randint``)."""

    def __init__(self, key: int, device=None):
        self.key = int(key)
        self.device = torch.device(device or "cpu")

    @classmethod
    def seeded(cls, seed: int, *path, device=None) -> "Noise":
        """The source of ``seed`` (any whole number) and a ``path`` that names
        what it is for."""
        return cls(derive(0, "port_bench", int(seed), *path), device)

    def split(self, num: int = 2) -> Tuple["Noise", ...]:
        return tuple(Noise(derive(self.key, "split", num, i), self.device) for i in range(num))

    def fold_in(self, i: int) -> "Noise":
        return Noise(derive(self.key, "fold_in", int(i)), self.device)

    def generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.key)

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self.generator(), device=self.device)

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self.generator(), device=self.device)

    def randint(self, shape: Sequence[int], low: int, high: int) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape), generator=self.generator(),
                             device=self.device)

    def state_dict(self) -> dict:
        return {"key": self.key}

    def load_state_dict(self, state: dict) -> None:
        self.key = int(state["key"])
