"""``model_summary.txt``: parameter counts per top-level module and the
FLOPs of one forward. The port's counterpart of ``ivid_tpu/utils/summary.py``
(which groups by the flax tree's top-level names and takes its FLOPs from
XLA's cost model)."""

from __future__ import annotations

from typing import Sequence

import torch
from torch.utils.flop_counter import FlopCounterMode


def forward_flops(model: torch.nn.Module, example_inputs: Sequence[torch.Tensor]) -> int:
    """FLOPs of ``model(*example_inputs)`` as ``torch.utils.flop_counter``
    counts them (matrix products and convolutions, 2 per multiply-add),
    run on the meta device: shapes only, no arithmetic and no kernel; the
    attention blocks take their plain version there, so attention counts as
    its two products."""
    meta = {k: torch.empty_like(v, device="meta")
            for k, v in list(model.named_parameters()) + list(model.named_buffers())}
    inputs = [x.to("meta") if isinstance(x, torch.Tensor) else x for x in example_inputs]
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        torch.func.functional_call(model, meta, tuple(inputs))
    return int(counter.get_total_flops())


def model_summary(model: torch.nn.Module, example_inputs: Sequence[torch.Tensor]) -> str:
    """The summary text: one line per top-level module with its parameter
    count, the total (``Total params: N (X MB fp32)``, in the JAX summary's
    words) and the forward FLOPs of ``example_inputs``."""
    lines = [model.__class__.__name__, "=" * 72]
    groups: dict = {}
    for name, p in model.named_parameters():
        key = name.split(".")[0]
        groups[key] = groups.get(key, 0) + p.numel()
    total = sum(groups.values())
    width = max(len(k) for k in groups)
    for key in groups:
        lines.append(f"{key:<{width}}  {groups[key]:>14,}")
    lines.append("=" * 72)
    lines.append(f"Total params: {total:,} ({total * 4 / 1e6:.1f} MB fp32)")
    batch = next(iter(example_inputs)).shape[0]
    flops = forward_flops(model, example_inputs)
    lines.append(f"Forward FLOPs (torch.utils.flop_counter, batch {batch}: matrix products and "
                 f"convolutions; the JAX package's XLA cost model counts other operations): "
                 f"{flops / 1e9:.2f} GFLOP")
    return "\n".join(lines)
