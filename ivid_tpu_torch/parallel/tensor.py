"""Tensor parallelism of the ADM UNet over the model group: the port's
counterpart of ``ivid_tpu/parallel/sharding.py``, in Megatron's pattern.

The JAX package names a layout per parameter (``_param_spec``) and lets XLA
insert the collectives. Here each rank holds its slice of the layers that
carry the products, and two autograd functions place the collectives by
hand: :func:`copy_to_model` (identity forward, all-reduce of the gradient
backward) where a replicated activation enters a column-parallel layer, and
:func:`reduce_from_model` (all-reduce forward, identity backward) where a
row-parallel layer's partial sums leave it. Only ``all_reduce`` (here) and
``all_gather`` (:func:`gather_state_dict`) are used; gloo carries both for
CUDA tensors in bf16 and f32 (seen on the H100 machine), so the
activations are reduced in their own type: a bf16 torso's partial sums are
rounded to bf16 before they are summed.

:func:`shard_unet` replaces, in place, the layers of a full model (built
identically on every rank) with this rank's slices:

================================  ===========================  ==============================
port module                       JAX name (``_param_spec``)   layout here
================================  ===========================  ==============================
``ResBlock.in_layers[2]``         ``in_conv`` (column)         ``C_out/m`` output channels
``ResBlock.emb_layers[1]``        ``emb_proj`` (column)        this rank's rows of the scale
                                                               half and of the shift half
``ResBlock.out_layers[0]``        replicated                   ``GroupNorm(groups/m, C_out/m)``
``ResBlock.out_layers[3]``        ``out_conv`` (row)           ``C_out/m`` input channels,
                                                               all-reduce, bias added once
``AttentionBlock.qkv``            ``qkv`` (column)             ``heads/m`` whole heads
``AttentionBlock.proj_out``       ``proj`` (row)               ``C/m`` input channels,
                                                               all-reduce, bias added once
================================  ===========================  ==============================

Every layer computes the function of the full one. Where the layouts differ
from ``_param_spec``:

- ``emb_proj``: JAX splits the ``2C`` outputs contiguously, so its rank 0
  holds the whole scale half and XLA moves the halves; here each rank holds
  the rows of both halves that its channels need, and no collective runs.
- ``out_layers[0]``, a GroupNorm that JAX replicates, is sharded: the
  groups are contiguous channel blocks, so ``groups/m`` of them on ``C/m``
  channels need no statistic from another rank.
- The residual blocks' ``skip_connection`` (JAX's ``skip_conv``, row) stays
  replicated: it reads the replicated input, and sharding it would add an
  all-reduce for a 1x1 product.
- The UNet's own first and last convolutions, which ``_param_spec`` catches
  by their names ``in_conv``/``out_conv``, stay replicated, as do the
  norms, the time and class embeddings and every bias of a row-parallel
  layer.

A block whose channels, groups or heads ``m`` does not divide stays
replicated, as ``_param_spec`` leaves such a leaf. A checkpoint is written
whole (:func:`gather_state_dict`) and read whole (:func:`shard_state_dict`),
so its files do not depend on ``m``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ivid_tpu_torch.models import adm


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def copy_to_model(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over the model group."""
    return _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the model group; its gradient passed through."""
    return _ReduceFromModel.apply(x, group)


class ColumnConv2d(adm.Conv2d):
    """This rank's output channels of a convolution with a replicated input."""

    def __init__(self, *args, group=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.group = group

    def forward(self, x):
        return super().forward(copy_to_model(x, self.group))


class RowConv2d(adm.Conv2d):
    """This rank's input channels of a convolution: partial sums, summed over
    the model group, then the (replicated) bias."""

    def __init__(self, *args, group=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.group = group

    def forward(self, x):
        y = reduce_from_model(self._conv_forward(x, self.weight.to(x.dtype), None), self.group)
        return y + self.bias.to(y.dtype)[:, None, None]


class ColumnLinear(nn.Linear):
    """This rank's output rows of a linear layer with a replicated input."""

    def __init__(self, *args, group=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.group = group

    def forward(self, x):
        return super().forward(copy_to_model(x, self.group))


class ColumnTokenConv1d(adm.TokenConv1d):
    """This rank's output channels of a token-major 1x1 projection."""

    def __init__(self, *args, group=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.group = group

    def forward(self, x):
        return super().forward(copy_to_model(x, self.group))


class RowTokenConv1d(adm.TokenConv1d):
    """This rank's input channels of a token-major 1x1 projection: partial
    sums, summed over the model group, then the (replicated) bias."""

    def __init__(self, *args, group=None, **kwargs):
        super().__init__(*args, **kwargs)
        self.group = group

    def forward(self, x):
        y = reduce_from_model(F.linear(x, self.weight[:, :, 0].to(x.dtype)), self.group)
        return y + self.bias.to(y.dtype)


#: The layers :func:`shard_unet` puts in; a UNet that holds one runs its
#: inference forward eagerly (``AdmUnet2d.graphable``).
LAYERS = (ColumnConv2d, RowConv2d, ColumnLinear, ColumnTokenConv1d, RowTokenConv1d)


@dataclasses.dataclass(frozen=True)
class Shard:
    """How a parameter is split over the model group: along ``dim`` in
    ``m`` contiguous blocks, or, with ``halves``, each half of ``dim`` so
    (``emb_layers[1]``'s ``[scale; shift]`` rows)."""

    dim: int
    halves: bool = False


def shard_tensor(full: torch.Tensor, shard: Shard, rank: int, size: int) -> torch.Tensor:
    """Rank ``rank``'s slice of ``full`` (a contiguous copy)."""
    if shard.halves:
        return torch.cat([h.chunk(size, shard.dim)[rank] for h in full.chunk(2, shard.dim)],
                         shard.dim).contiguous()
    return full.chunk(size, shard.dim)[rank].contiguous()


def unshard_tensor(parts, shard: Shard) -> torch.Tensor:
    """The full tensor from every rank's slice, in rank order."""
    if shard.halves:
        halves = [p.chunk(2, shard.dim) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves], shard.dim)
    return torch.cat(list(parts), shard.dim)


def _local(module: nn.Module, make, tensors: Dict[str, torch.Tensor]) -> nn.Module:
    """``make()`` on ``module``'s device and type, holding ``tensors``."""
    p = next(module.parameters())
    new = make().to(device=p.device, dtype=p.dtype)
    with torch.no_grad():
        for name, t in tensors.items():
            getattr(new, name).copy_(t)
    return new


def _shard_res_block(block: adm.ResBlock, prefix: str, rank: int, size: int, group,
                     specs: Dict[str, Shard]) -> None:
    conv_in, lin, norm, conv_out = (block.in_layers[2], block.emb_layers[1],
                                    block.out_layers[0], block.out_layers[3])
    cols, rows, halves = Shard(0), Shard(1), Shard(0, halves=block.use_scale_shift_norm)
    part = lambda t, s: shard_tensor(t.detach(), s, rank, size)
    c_in, c_out = conv_in.in_channels, conv_in.out_channels // size
    k = conv_in.kernel_size[0]
    block.in_layers[2] = _local(conv_in, lambda: ColumnConv2d(c_in, c_out, k, padding=k // 2,
                                                              group=group),
                                {"weight": part(conv_in.weight, cols),
                                 "bias": part(conv_in.bias, cols)})
    block.emb_layers[1] = _local(lin, lambda: ColumnLinear(lin.in_features,
                                                           lin.out_features // size,
                                                           group=group),
                                 {"weight": part(lin.weight, halves),
                                  "bias": part(lin.bias, halves)})
    block.out_layers[0] = _local(norm, lambda: adm.GroupNorm32(norm.num_groups // size, c_out),
                                 {"weight": part(norm.weight, cols),
                                  "bias": part(norm.bias, cols)})
    k = conv_out.kernel_size[0]
    block.out_layers[3] = _local(conv_out, lambda: RowConv2d(c_out, conv_out.out_channels, k,
                                                             padding=k // 2, group=group),
                                 {"weight": part(conv_out.weight, rows),
                                  "bias": conv_out.bias.detach()})
    specs.update({
        f"{prefix}in_layers.2.weight": cols, f"{prefix}in_layers.2.bias": cols,
        f"{prefix}emb_layers.1.weight": halves, f"{prefix}emb_layers.1.bias": halves,
        f"{prefix}out_layers.0.weight": cols, f"{prefix}out_layers.0.bias": cols,
        f"{prefix}out_layers.3.weight": rows,
    })


def _shard_attention(block: adm.AttentionBlock, prefix: str, rank: int, size: int, group,
                     specs: Dict[str, Shard]) -> None:
    qkv, proj = block.qkv, block.proj_out
    cols, rows = Shard(0), Shard(1)
    part = lambda t, s: shard_tensor(t.detach(), s, rank, size)
    c = proj.out_channels
    # qkv's outputs are head-major [h][q|k|v][D]: a contiguous block of them
    # is heads/m whole heads.
    block.qkv = _local(qkv, lambda: ColumnTokenConv1d(c, 3 * c // size, 1, group=group),
                       {"weight": part(qkv.weight, cols), "bias": part(qkv.bias, cols)})
    block.proj_out = _local(proj, lambda: RowTokenConv1d(c // size, c, 1, group=group),
                            {"weight": part(proj.weight, rows), "bias": proj.bias.detach()})
    block.heads //= size
    specs.update({f"{prefix}qkv.weight": cols, f"{prefix}qkv.bias": cols,
                  f"{prefix}proj_out.weight": rows})


def shard_unet(model: nn.Module, groups) -> Dict[str, Shard]:
    """Replace ``model``'s residual and attention blocks, in place, by this
    rank's slices over ``groups.model`` (``parallel.make_groups``); returns
    each sharded parameter's :class:`Shard` by name. A block ``m`` does not
    divide (channels and groups of a residual block, heads of an attention
    block) stays replicated. With a model group of one, nothing changes."""
    size, rank, group = groups.model_size, groups.model_rank, groups.model
    specs: Dict[str, Shard] = {}
    if size == 1:
        return specs
    for mod in model.modules():
        if isinstance(mod, adm.AdmUnet2d):
            mod.graphs.clear()  # its graphs read the layers replaced here
    for name, mod in list(model.named_modules()):
        prefix = f"{name}." if name else ""
        if isinstance(mod, adm.ResBlock):
            c_out = mod.in_layers[2].out_channels
            if c_out % size == 0 and mod.out_layers[0].num_groups % size == 0:
                _shard_res_block(mod, prefix, rank, size, group, specs)
        elif isinstance(mod, adm.AttentionBlock) and mod.heads % size == 0:
            _shard_attention(mod, prefix, rank, size, group, specs)
    return specs


def gather_state_dict(state: Dict[str, torch.Tensor], specs: Dict[str, Shard],
                      groups) -> Dict[str, torch.Tensor]:
    """``state`` (this rank's tensors by parameter name, as a model's state
    dict, an EMA copy or AdamW's moments) with every shard in ``specs``
    replaced by the full tensor, all-gathered over the model group in the
    order of ``state``. Every rank of the group must call it."""
    out = {}
    for name, t in state.items():
        shard = specs.get(name)
        if shard is None:
            out[name] = t
            continue
        t = t.detach().contiguous()
        parts = [torch.empty_like(t) for _ in range(groups.model_size)]
        dist.all_gather(parts, t, group=groups.model)
        out[name] = unshard_tensor(parts, shard)
    return out


def shard_state_dict(state: Dict[str, torch.Tensor], specs: Dict[str, Shard],
                     groups) -> Dict[str, torch.Tensor]:
    """``state`` of full tensors with every tensor named in ``specs``
    replaced by this rank's slice."""
    return {name: (shard_tensor(t, specs[name], groups.model_rank, groups.model_size)
                   if name in specs else t) for name, t in state.items()}
