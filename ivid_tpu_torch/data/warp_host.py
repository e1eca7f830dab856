"""Warp conditioning synthesized in loader workers, on the CPU.

Port of ``ivid_tpu/data/warp_host.py``. :class:`HostWarpDataset` wraps a
warp dataset and attaches ``y``, ``mask``, ``pose`` (and ``mask_rgb``) to
every item by running ``training/warp_cond.synthesize_single`` on CPU
tensors, the kernels' plain versions, in whichever loader worker loads the
item. With enough process workers the conditioning of batch k+1 is made
while the card trains on batch k. The inpaint trainer uses it when its
``warp_host`` argument is true; by default the warp runs on the card inside
the step (K2 and K3).

Noise: item ``index`` on its ``visit``-th load draws from
``noise.fold_in(index).fold_in(visit)`` of a :class:`KeyedNoise` seeded with
``seed``: deterministic within a worker's life, fresh augments every epoch.
A resumed run restarts the visit counts, so its augments differ from an
unbroken run's (the data stream itself stays exact).

The dataset pickles (process workers get a copy, and the loader gives each
its share of the cores); ``__getstate__`` drops the per-process visit counts.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from ivid_tpu_torch.diffusion.noise import KeyedNoise
from ivid_tpu_torch.training import warp_cond


class HostWarpDataset:
    def __init__(self, base, *, augments, pose_std, near, far, seed=0):
        self.base = base
        self.augments = tuple(augments)
        self.pose_std = float(pose_std)
        self.near = float(near)
        self.far = float(far)
        self.seed = int(seed)
        self._visits = {}
        self._lock = threading.Lock()

    def __len__(self):
        return len(self.base)

    @property
    def image_size(self):
        return self.base.image_size

    def __getstate__(self):
        state = dict(self.__dict__)
        del state["_lock"]
        state["_visits"] = {}
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()

    def get_with_rng(self, index, rng) -> dict:
        """The base item with its conditioning drawn from the noise source
        ``rng`` (on the CPU)."""
        item = dict(self.base[index])
        x01 = torch.from_numpy(np.asarray(item["x_0"], np.float32)) * 0.5 + 0.5
        out = warp_cond.synthesize_single(x01, rng, augments=self.augments,
                                          pose_std=self.pose_std, near=self.near, far=self.far)
        item.update({k: v.numpy() for k, v in out.items()})
        return item

    def __getitem__(self, index) -> dict:
        with self._lock:  # thread workers may load one index at once
            visit = self._visits.get(index, 0)
            self._visits[index] = visit + 1
        rng = KeyedNoise.seeded(self.seed).fold_in(index).fold_in(visit)
        return self.get_with_rng(index, rng)
