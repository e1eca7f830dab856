"""Data parallelism over ``torch.distributed``: one process per GPU.

The counterpart of ``ivid_tpu/parallel/`` for the port. :func:`init_from_env`
starts the default process group from the environment that
``torch.distributed.run`` sets (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``): NCCL on ``cuda:LOCAL_RANK``, or gloo on
the CPU. :func:`check_replication` holds every parameter to be the same on
every rank, and :class:`RowShardNoise` gives each rank its rows of draws
made over the whole world's batch. Without a process group every function
here sees one rank.
"""

from __future__ import annotations

import os
import zlib

import torch
import torch.distributed as dist


def init_from_env(device_type: str = "cuda") -> torch.device:
    """Join the default process group as ``RANK`` of ``WORLD_SIZE``; returns
    this rank's device (``cuda:LOCAL_RANK``, or the CPU with gloo)."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if device_type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(device)
        dist.init_process_group("nccl", init_method="env://", rank=rank, world_size=world,
                                device_id=device)
    elif device_type == "cpu":
        device = torch.device("cpu")
        dist.init_process_group("gloo", init_method="env://", rank=rank, world_size=world)
    else:
        raise ValueError(f"data parallelism runs on 'cuda' or 'cpu', not {device_type!r}")
    return device


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier() -> None:
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


def shutdown() -> None:
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def mean_over_ranks(t: torch.Tensor) -> torch.Tensor:
    """The mean of ``t`` over the ranks (``t`` itself on one)."""
    if not dist.is_initialized():
        return t
    total = t.detach().clone()
    dist.all_reduce(total)
    return total / dist.get_world_size()


def check_replication(named_params) -> None:
    """Raise unless every parameter is bit-equal on every rank: a crc32
    digest of each parameter's bytes, all-gathered as int64 (a dtype NCCL
    carries), the first parameter whose digests differ named. Every rank
    must call it."""
    names, digests = [], []
    for name, p in named_params:
        names.append(name)
        raw = p.detach().reshape(-1).view(torch.uint8).cpu().numpy()
        digests.append(zlib.crc32(raw.tobytes()))
    if not dist.is_initialized():
        return
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    local = torch.tensor(digests, dtype=torch.int64, device=device)
    gathered = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(gathered, local)
    table = torch.stack(gathered).cpu()
    differs = (table != table[0]).any(dim=0).nonzero()
    if len(differs):
        i = int(differs[0])
        raise RuntimeError(f"parameter {names[i]} differs across ranks "
                           f"(crc32 by rank: {table[:, i].tolist()})")


class RowShardNoise:
    """A noise source whose draws of ``b`` rows are this rank's block
    ``[rank·b, (rank+1)·b)`` of one draw of ``world·b`` rows from ``base``:
    ranks that hold the same source draw one global batch between them, no
    row shared, as one device would draw it. Scalar draws are taken whole."""

    def __init__(self, base, rank: int, world: int):
        self.base, self.rank, self.world = base, rank, world

    def split(self, num: int = 2):
        return tuple(RowShardNoise(s, self.rank, self.world) for s in self.base.split(num))

    def fold_in(self, i: int):
        return RowShardNoise(self.base.fold_in(i), self.rank, self.world)

    def _rows(self, draw, shape):
        shape = tuple(shape)
        if not shape:
            return draw(shape)
        b = shape[0]
        return draw((b * self.world,) + shape[1:])[self.rank * b:(self.rank + 1) * b]

    def normal(self, shape):
        return self._rows(self.base.normal, shape)

    def uniform(self, shape):
        return self._rows(self.base.uniform, shape)

    def randint(self, shape, low, high):
        return self._rows(lambda s: self.base.randint(s, low, high), shape)
