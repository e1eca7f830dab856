"""Seeded batch collection from a dataset (reference: inference/utils.py:58-71).

A copy of ``ivid_tpu/data/collect.py``: one item per seed (the seed picks
the index) with its fields stacked, used to build conditional-sampling demo
batches from real data."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def collect_data(dataset, seeds: Sequence[int]) -> Dict[str, np.ndarray]:
    out: Dict[str, list] = {}
    for seed in seeds:
        idx = int(np.random.default_rng(seed).integers(0, len(dataset)))
        for k, v in dataset[idx].items():
            out.setdefault(k, []).append(np.asarray(v))
    return {k: np.stack(v, axis=0) for k, v in out.items()}
