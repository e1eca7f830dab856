"""Shuffled, drop-last, endless batch loader with a resumable cursor.

Port of ``ivid_tpu/data/loader.py`` for one process: every epoch is a
permutation drawn from ``seed + epoch``, cut into full batches (the ragged
tail is dropped). ``position`` is the (epoch, batch) cursor of the next batch
to be yielded, updated as batches are consumed, so a loader built with
``start=position`` yields exactly the remaining sequence. Items load in the
calling thread, in order.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np


class DataLoader:
    def __init__(self, dataset, batch_size: int, *, seed: int = 0,
                 start: Tuple[int, int] = (0, 0)):
        self.dataset = dataset
        self.batch_size = batch_size
        self.seed = seed
        self.position = tuple(int(x) for x in start)

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        """Item indices per batch of ``epoch``: [n_batches, batch_size]."""
        n = len(self.dataset)
        idx = np.random.default_rng(self.seed + epoch).permutation(n)
        usable = (n // self.batch_size) * self.batch_size
        return idx[:usable].reshape(-1, self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Endless batches from ``position`` on: dicts of stacked item arrays."""
        epoch, b0 = self.position
        while True:
            batches = self._epoch_indices(epoch)
            if len(batches) == 0:
                raise ValueError(f"dataset (len {len(self.dataset)}) yields no full batch "
                                 f"of {self.batch_size}")
            for b in range(b0, len(batches)):
                items = [self.dataset[int(i)] for i in batches[b]]
                self.position = (epoch, b + 1) if b + 1 < len(batches) else (epoch + 1, 0)
                yield {k: np.stack([it[k] for it in items]) for k in items[0]}
            epoch, b0 = epoch + 1, 0
