"""The port's worker loader vs the JAX package's (CPU): the same batches for
the same seed, global batch and shard, with thread and spawned process
workers, and the loader's contracts (resume cursor, superseded iterators,
local item counts, the zero-batch error, no CUDA in process workers). All
exact: the permutations are the same numpy code and the items the same
procedural ones."""

import numpy as np
import pytest

from ivid_tpu.data import DataLoader as JDataLoader
from ivid_tpu.data import SyntheticRGBD as JSyntheticRGBD
from ivid_tpu_torch.data import DataLoader, SyntheticRGBD
from ivid_tpu_torch.data import loader as loader_mod

ARGS = dict(image_size=4, length=22, num_classes=5, normalize=True, normalize_depth=True,
            prepocess_depth="z_buffer")


def _take(it, n):
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("shard,shards", [(0, 1), (1, 2)], ids=["one-rank", "rank1-of-2"])
@pytest.mark.parametrize("mode", ["thread", "process"])
def test_batches_match_jax(mode, shard, shards):
    """Two loaders' streams over more than two epochs (5 global batches of 4
    per epoch): every batch and cursor equal."""
    kw = dict(num_workers=2, seed=3, shard_index=shard, num_shards=shards, worker_mode=mode,
              prefetch=2)
    got_loader, want_loader = DataLoader(SyntheticRGBD(**ARGS), 4, **kw), JDataLoader(
        JSyntheticRGBD(**ARGS), 4, **kw)
    got_it, want_it = iter(got_loader), iter(want_loader)
    try:
        for _ in range(11):
            a, b = next(got_it), next(want_it)
            assert sorted(a) == sorted(b) and a["x_0"].shape[0] == 4 // shards
            for k in b:
                np.testing.assert_array_equal(a[k], b[k])
            assert got_loader.position == want_loader.position
        assert got_loader.items_loaded == want_loader.items_loaded
    finally:
        got_it.close()
        want_it.close()


def test_shards_are_disjoint_and_make_up_the_global_batch():
    ds = SyntheticRGBD(**ARGS)
    blocks = [DataLoader(ds, 4, seed=1, shard_index=r, num_shards=2)._epoch_indices(e)
              for e in (0, 1) for r in (0, 1)]
    for e in (0, 1):
        a, b = blocks[2 * e], blocks[2 * e + 1]
        whole = DataLoader(ds, 4, seed=1)._epoch_indices(e)
        assert not set(a.ravel()) & set(b.ravel())
        np.testing.assert_array_equal(np.concatenate([a, b], axis=1), whole)


def test_resume_cursor_and_items_loaded():
    ds = SyntheticRGBD(**ARGS)
    loader = DataLoader(ds, 4, seed=2, shard_index=1, num_shards=2, num_workers=2, prefetch=3)
    it = iter(loader)
    _take(it, 7)
    # Items are counted as they are submitted: this rank's 2 rows of the 7
    # consumed batches and the 3 in flight.
    assert loader.items_loaded == (7 + 3) * 2
    assert loader.position == (1, 2) and loader.wait_seconds >= 0
    resumed = iter(DataLoader(ds, 4, seed=2, shard_index=1, num_shards=2, start=loader.position))
    for a, b in zip(_take(resumed, 6), _take(it, 6)):
        np.testing.assert_array_equal(a["x_0"], b["x_0"])
    it.close()
    resumed.close()


def test_a_superseded_iterator_raises():
    loader = DataLoader(SyntheticRGBD(**ARGS), 4, num_workers=1)
    first = iter(loader)
    next(first)
    second = iter(loader)
    next(second)
    with pytest.raises(RuntimeError, match="superseded"):
        next(first)
    second.close()


def test_zero_full_batches_raise():
    with pytest.raises(ValueError, match="zero full global batches"):
        next(iter(DataLoader(SyntheticRGBD(**dict(ARGS, length=3)), 4)))
    with pytest.raises(ValueError, match="not divisible"):
        DataLoader(SyntheticRGBD(**ARGS), 5, num_shards=2)
    with pytest.raises(ValueError, match="worker_mode"):
        DataLoader(SyntheticRGBD(**ARGS), 4, worker_mode="fork")


def test_process_worker_refuses_a_cuda_context(monkeypatch):
    """A process worker's item is refused if loading it initialised CUDA."""
    import torch

    monkeypatch.setattr(loader_mod, "_WORKER_DATASET", SyntheticRGBD(**ARGS))
    assert loader_mod._process_worker_get(0)["x_0"].shape == (4, 4, 4)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    with pytest.raises(RuntimeError, match="initialised CUDA"):
        loader_mod._process_worker_get(0)
