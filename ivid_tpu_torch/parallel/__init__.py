"""Data and tensor parallelism over ``torch.distributed``: one process per
rank.

The counterpart of ``ivid_tpu/parallel/`` for the port. :func:`init_from_env`
starts the default process group from the environment that
``torch.distributed.run`` sets (``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) on the device the caller names: NCCL with
one rank per card (``cuda``), gloo with every rank on one card (``cuda:K``;
NCCL refuses two ranks on one device) or on the CPU. :func:`make_groups`
splits the ranks into the ``(data, model)`` mesh of ``make_mesh``, and
:mod:`ivid_tpu_torch.parallel.tensor` shards the UNet over the model group.
:func:`check_replication` holds every parameter to be the same on every rank
that must hold it, and :class:`RowShardNoise` gives each data rank its rows
of draws made over the whole batch. Without a process group every function
here sees one rank.
"""

from __future__ import annotations

import dataclasses
import os
import zlib
from typing import Collection, Optional

import torch
import torch.distributed as dist


def placement(device="cuda"):
    """``(backend, device)`` of this rank for the device the caller names
    (see :func:`init_from_env`), from ``RANK``, ``LOCAL_RANK`` and
    ``LOCAL_WORLD_SIZE``; raises where the host has too few cards."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", os.environ["RANK"]))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", local + 1))
        cards = torch.cuda.device_count()
        if max(local, local_world - 1) >= cards:
            raise RuntimeError(f"{local_world} local ranks but {cards} CUDA devices: give "
                               "--device cuda:K to put every rank on card K (gloo)")
        return "nccl", torch.device("cuda", local)
    if device.type in ("cuda", "cpu"):
        return "gloo", device
    raise ValueError(f"process groups run on 'cuda', 'cuda:K' or 'cpu', not {str(device)!r}")


def init_from_env(device="cuda") -> torch.device:
    """Join the default process group as ``RANK`` of ``WORLD_SIZE`` on the
    device named; returns this rank's device:

    - ``cuda``: ``cuda:LOCAL_RANK`` with NCCL, one rank per card (raises if
      this host has more local ranks than cards);
    - ``cuda:K``: every rank on card K with gloo, which carries CUDA tensors
      through the host (NCCL refuses two ranks on one device);
    - ``cpu``: gloo.

    Rank 0 prints the backend and the device."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    backend, device = placement(device)
    kwargs = {}
    if device.type == "cuda":
        torch.cuda.set_device(device)
        if backend == "nccl":
            kwargs["device_id"] = device
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world, **kwargs)
    if rank == 0:
        print(f"process group: {backend}, {world} ranks, rank 0 on {device}", flush=True)
    return device


@dataclasses.dataclass(frozen=True)
class Groups:
    """This rank's place in the ``(data, model)`` mesh: the process group of
    its data replicas (the ranks that hold the same shards) and of its model
    peers (the ranks that hold one model between them), with its index and
    the size of each. The model group is None without tensor parallelism;
    both are None without a process group."""

    data: Optional[object]
    model: Optional[object]
    data_rank: int = 0
    data_size: int = 1
    model_rank: int = 0
    model_size: int = 1


def make_groups(model_parallel: int = 1) -> Groups:
    """The counterpart of ``make_mesh(model=model_parallel)``: rank
    ``d·model + m`` sits at ``(d, m)`` of a ``(world/model, model)`` mesh,
    as ``reshape(data, model)`` places the devices. Every rank creates every
    group, in the same order (data groups, then model groups), as
    ``torch.distributed.new_group`` requires."""
    if model_parallel < 1:
        raise ValueError(f"model_parallel={model_parallel} must be at least 1")
    if not dist.is_initialized():
        if model_parallel != 1:
            raise ValueError(f"model_parallel={model_parallel} needs a process group of "
                             f"{model_parallel} ranks or more (--distributed)")
        return Groups(None, None)
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % model_parallel:
        raise ValueError(f"{world} ranks do not split into model groups of {model_parallel}")
    data = world // model_parallel
    if model_parallel == 1:
        return Groups(dist.group.WORLD, None, rank, world, 0, 1)
    data_groups = [dist.new_group([d * model_parallel + m for d in range(data)])
                   for m in range(model_parallel)]
    model_groups = [dist.new_group([d * model_parallel + m for m in range(model_parallel)])
                    for d in range(data)]
    d, m = divmod(rank, model_parallel)
    return Groups(data_groups[m], model_groups[d], d, data, m, model_parallel)


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


def check_replication(named_params, sharded: Collection[str] = (), model_size: int = 1) -> None:
    """Raise unless every parameter is bit-equal on every rank that must
    hold it: a replicated one on every rank, one named in ``sharded`` (this
    rank's slice under tensor parallelism) on the ranks of its data group,
    which hold the same slice (ranks ``r`` with the same ``r % model_size``).
    A crc32 digest of each parameter's bytes is all-gathered as int64 (a
    dtype NCCL carries); the first parameter whose digests differ is named.
    Every rank must call it."""
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
    # Each rank's reference row: its data group's first rank for a shard,
    # rank 0 for a replicated parameter.
    ranks = torch.arange(len(table))
    shard_ref = table[ranks % model_size]
    is_shard = torch.tensor([name in sharded for name in names], dtype=torch.bool)
    ref = torch.where(is_shard[None, :], shard_ref, table[:1])
    differs = (table != ref).any(dim=0).nonzero()
    if len(differs):
        i = int(differs[0])
        kind = "shard" if is_shard[i] else "parameter"
        raise RuntimeError(f"{kind} {names[i]} differs across ranks "
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
