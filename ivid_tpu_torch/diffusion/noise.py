"""The noise source every random draw of the samplers, frameworks and
pipeline goes through.

Its ``split``/``fold_in`` calls follow the key derivation of the JAX package
(``jax.random.split`` / ``fold_in``) step for step, so an implementation that
replays ``jax.random`` keys reproduces the JAX chain's noise exactly (the
tests do this). A source draws ``normal``, ``uniform`` and ``randint``
samples. :class:`TorchNoise` ignores the derivation and draws every sample
in call order from one ``torch.Generator``; :class:`KeyedNoise` (the
trainers' default) follows it, so that a source's numbers depend only on how
it was derived, not on what was drawn before.
"""

from __future__ import annotations

import hashlib
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


def _derive(key: int, *path) -> int:
    """A 63-bit key from ``key`` and the derivation ``path``."""
    digest = hashlib.blake2b(repr((key,) + path).encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


class KeyedNoise:
    """Counter-based draws: a source is a 63-bit key; ``split`` and
    ``fold_in`` derive child keys by hashing (as ``jax.random`` derives its
    keys, with another hash), and each draw seeds a fresh ``torch.Generator``
    on ``device`` from the key. Distinct derivations give independent
    streams, whatever was drawn before or elsewhere: ranks and loader workers
    that derive the same key draw the same numbers."""

    def __init__(self, key: int, device=None):
        self.key = int(key)
        self.device = torch.device(device or "cpu")

    @classmethod
    def seeded(cls, seed: int, device=None) -> "KeyedNoise":
        return cls(_derive(0, "seed", int(seed)), device)

    @classmethod
    def from_jax_key(cls, key: Sequence[int], device=None) -> "KeyedNoise":
        """A source derived from the two uint32 words of a ``jax.random``
        key, deterministically. It does not continue the key's stream:
        threefry cannot be continued here, so its draws differ from JAX's."""
        return cls(_derive(0, "jax_key", *(int(w) for w in key)), device)

    def split(self, num: int = 2) -> Tuple["KeyedNoise", ...]:
        return tuple(KeyedNoise(_derive(self.key, "split", num, i), self.device)
                     for i in range(num))

    def fold_in(self, i: int) -> "KeyedNoise":
        return KeyedNoise(_derive(self.key, "fold_in", int(i)), self.device)

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(self.key)

    def normal(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.randn(tuple(shape), generator=self._generator(), device=self.device)

    def uniform(self, shape: Sequence[int]) -> torch.Tensor:
        return torch.rand(tuple(shape), generator=self._generator(), device=self.device)

    def randint(self, shape: Sequence[int], low: int, high: int) -> torch.Tensor:
        return torch.randint(low, high, tuple(shape), generator=self._generator(),
                             device=self.device)

    def state_dict(self) -> dict:
        return {"key": self.key}

    def load_state_dict(self, state: dict) -> None:
        self.key = int(state["key"])
