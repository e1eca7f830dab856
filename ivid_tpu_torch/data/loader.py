"""Shuffled, drop-last, endless batch loader with worker threads or processes,
ordered prefetch, row shards and a resumable cursor.

Port of ``ivid_tpu/data/loader.py``. Every epoch is a permutation drawn from
``seed + epoch``, cut into full global batches of ``batch_size`` (the ragged
tail is dropped). With ``num_shards`` ranks, every rank cuts the same
permutation and loads only its own block of ``batch_size / num_shards`` rows
of each global batch, so the ranks' rows are disjoint and together make up
the global batch.

``num_workers`` threads (``worker_mode="thread"``) or spawned processes
(``"process"``, which hold a pickled copy of the dataset, never touch CUDA,
and share the host's cores for torch's intra-op threads: many workers that
each spin up every core thrash) load the items; ``prefetch`` batches are in flight, and batches come
out in order. ``position`` is the (epoch, batch) cursor of the next batch to
be yielded, updated as batches are consumed, so a loader built with
``start=position`` yields exactly the remaining sequence.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time
from collections import deque
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from typing import Dict, Iterator, Tuple

import numpy as np

_WORKER_DATASET = None


def _process_worker_init(dataset, torch_threads: int):
    """Runs once in each spawned worker: keep the unpickled dataset and take
    the worker's share of the cores for torch."""
    import torch

    global _WORKER_DATASET
    _WORKER_DATASET = dataset
    torch.set_num_threads(torch_threads)


def _process_worker_get(i: int):
    item = _WORKER_DATASET[i]
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        raise RuntimeError("a loader worker process initialised CUDA")
    return item


class DataLoader:
    def __init__(self, dataset, batch_size: int, *, num_workers: int = 4, seed: int = 0,
                 shard_index: int = 0, num_shards: int = 1, prefetch: int = 4,
                 start: Tuple[int, int] = (0, 0), worker_mode: str = "thread"):
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode must be 'thread' or 'process', not {worker_mode!r}")
        if batch_size % num_shards:
            raise ValueError(f"global batch {batch_size} not divisible by {num_shards} shards")
        self.dataset = dataset
        self.batch_size = batch_size
        self.worker_mode = worker_mode
        self.num_workers = max(1, num_workers)
        self.seed = seed
        self.shard_index = shard_index
        self.num_shards = num_shards
        self.prefetch = max(1, prefetch)
        #: rows this rank loads and yields per global batch.
        self.local_batch_size = batch_size // num_shards
        self.position = tuple(int(x) for x in start)
        #: items fetched from the dataset (this rank's rows only).
        self.items_loaded = 0
        #: seconds the consumer waited for items that were not loaded yet.
        self.wait_seconds = 0.0
        # Only the newest iterator may advance the cursor.
        self._iter_gen = 0

    def _epoch_indices(self, epoch: int) -> np.ndarray:
        """This rank's item indices per global batch: [n_batches, local_batch_size]."""
        n = len(self.dataset)
        idx = np.random.default_rng(self.seed + epoch).permutation(n)
        usable = (n // self.batch_size) * self.batch_size
        batches = idx[:usable].reshape(-1, self.batch_size)
        lo = self.shard_index * self.local_batch_size
        return batches[:, lo:lo + self.local_batch_size]

    def _cursors(self, start: Tuple[int, int]):
        """Endless (next position, item indices) from ``start``."""
        epoch, batch0 = start
        while True:
            batches = self._epoch_indices(epoch)
            if len(batches) == 0:
                raise ValueError(f"dataset (len {len(self.dataset)}) yields zero full global "
                                 f"batches of size {self.batch_size}")
            for b in range(batch0, len(batches)):
                nxt = (epoch, b + 1) if b + 1 < len(batches) else (epoch + 1, 0)
                yield nxt, batches[b]
            epoch, batch0 = epoch + 1, 0

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        """Endless batches from ``position`` on: dicts of stacked item arrays.
        A new iterator supersedes the previous one, which then raises."""
        self._iter_gen += 1
        gen = self._iter_gen
        if self.worker_mode == "process":
            threads = max(1, (os.cpu_count() or 1) // self.num_workers)
            pool = ProcessPoolExecutor(max_workers=self.num_workers,
                                       mp_context=multiprocessing.get_context("spawn"),
                                       initializer=_process_worker_init,
                                       initargs=(self.dataset, threads))
            get_item = _process_worker_get
        else:
            pool = ThreadPoolExecutor(max_workers=self.num_workers)
            get_item = self.dataset.__getitem__
        cursors = self._cursors(self.position)
        pending: deque = deque()

        def submit_next():
            nxt, batch_idx = next(cursors)
            pending.append((nxt, [pool.submit(get_item, int(i)) for i in batch_idx]))
            self.items_loaded += len(batch_idx)

        try:
            for _ in range(self.prefetch):
                submit_next()
            while True:
                if self._iter_gen != gen:
                    raise RuntimeError("this DataLoader iterator was superseded by a newer "
                                       "iter() call; use one live iterator per loader")
                nxt, futs = pending.popleft()
                t0 = time.perf_counter()
                items = [f.result() for f in futs]
                self.wait_seconds += time.perf_counter() - t0
                submit_next()
                self.position = nxt
                yield {k: np.stack([it[k] for it in items]) for k in items[0]}
        finally:
            for _, futs in pending:
                for f in futs:
                    f.cancel()
            pool.shutdown(wait=self.worker_mode == "process", cancel_futures=True)
