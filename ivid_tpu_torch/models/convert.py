"""JAX (flax) AdmUnet2d parameters ↔ the port's state dict.

The port's counterpart of ``ivid_tpu/models/torch_compat.py``: the same
construction loops find each flax module's reference name, and the layouts
convert:

- flax conv ``[kh, kw, I, O]`` ↔ Conv2d ``[O, I, kh, kw]``
- flax Dense ``[I, O]`` of the attention qkv/proj ↔ Conv1d ``[O, I, 1]``
- flax Dense ``[I, O]`` of the embedding MLPs ↔ Linear ``[O, I]``

:func:`flax_to_state_dict` takes numpy leaves (or anything ``np.asarray``
accepts) and gives float32 torch tensors ready for ``load_state_dict``;
:func:`state_dict_to_flax` is its inverse (``torch_state_dict_to_flax`` of
the JAX package), from tensors or arrays to float32 numpy leaves. Applied to
any tree of the parameters' structure (AdamW's moments, gradients) they map
it the same way.
"""

from __future__ import annotations

from typing import Dict, Iterator, Sequence, Tuple

import numpy as np
import torch

def _norm_leaves(flax, port):
    """Leaves of a GroupNorm: (path in the flax block, port name, layout)."""
    return [((flax, "GroupNorm_0", "scale"), f"{port}.weight", "vec"),
            ((flax, "GroupNorm_0", "bias"), f"{port}.bias", "vec")]


def _conv_leaves(flax, port, layout="conv2d"):
    """Leaves of a convolution or dense layer."""
    return [((flax, "kernel"), f"{port}.weight", layout), ((flax, "bias"), f"{port}.bias", "vec")]


_RES = (_norm_leaves("in_norm", "in_layers.0") + _conv_leaves("in_conv", "in_layers.2")
        + _conv_leaves("emb_proj", "emb_layers.1", "linear") + _norm_leaves("out_norm", "out_layers.0")
        + _conv_leaves("out_conv", "out_layers.3"))
_SKIP = _conv_leaves("skip_conv", "skip_connection")
_ATTN = (_norm_leaves("norm", "norm") + _conv_leaves("qkv", "qkv", "conv1d")
         + _conv_leaves("proj", "proj_out", "conv1d"))

# flax → port, and port → flax, per layout.
_TO_PORT = {
    "vec": lambda k: k,
    "conv2d": lambda k: np.transpose(k, (3, 2, 0, 1)),  # [kh,kw,I,O] -> [O,I,kh,kw]
    "conv1d": lambda k: np.transpose(k, (1, 0))[:, :, None],  # [I,O] -> [O,I,1]
    "linear": lambda k: np.transpose(k, (1, 0)),  # [I,O] -> [O,I]
}
_TO_FLAX = {
    "vec": lambda w: w,
    "conv2d": lambda w: np.transpose(w, (2, 3, 1, 0)),
    "conv1d": lambda w: np.transpose(w[:, :, 0], (1, 0)),
    "linear": lambda w: np.transpose(w, (1, 0)),
}


def _leaves(
    *,
    image_size: int,
    model_channels: int,
    num_res_blocks: int,
    channel_mult: Sequence[float],
    attention_resolutions: Sequence[int],
    num_classes=None,
    **_unused,
) -> Iterator[Tuple[tuple, str, str]]:
    """(flax path, port name, layout) of every parameter, in the order of
    the JAX package's ``torch_state_dict_to_flax`` tree."""

    def block(flax, port, table):
        for path, name, layout in table:
            yield (flax,) + path, f"{port}.{name}", layout

    yield from (_conv_leaves("time_embed_1", "time_embed.1", "linear")
                + _conv_leaves("time_embed_2", "time_embed.3", "linear")
                + _conv_leaves("in_conv", "input_blocks.0.0"))
    if num_classes is not None:
        yield ("label_emb",), "label_emb.weight", "vec"

    idx, ds = 1, image_size
    ch = int(channel_mult[0] * model_channels)
    for level, mult in enumerate(channel_mult):
        for i in range(num_res_blocks):
            out_ch = int(mult * model_channels)
            yield from block(f"down_{level}_{i}", f"input_blocks.{idx}.0",
                             _RES + (_SKIP if out_ch != ch else []))
            ch = out_ch
            if ds in attention_resolutions:
                yield from block(f"down_{level}_{i}_attn", f"input_blocks.{idx}.1", _ATTN)
            idx += 1
        if level != len(channel_mult) - 1:
            yield from block(f"downsample_{level}", f"input_blocks.{idx}.0", _RES)
            idx += 1
            ds //= 2

    yield from block("mid_res1", "middle_block.0", _RES)
    yield from block("mid_attn", "middle_block.1", _ATTN)
    yield from block("mid_res2", "middle_block.2", _RES)

    idx = 0
    for level, mult in list(enumerate(channel_mult))[::-1]:
        for i in range(num_res_blocks + 1):
            # The skip concat widens every decoder block's input.
            yield from block(f"up_{level}_{i}", f"output_blocks.{idx}.0", _RES + _SKIP)
            sub = 1
            if ds in attention_resolutions:
                yield from block(f"up_{level}_{i}_attn", f"output_blocks.{idx}.{sub}", _ATTN)
                sub += 1
            if level and i == num_res_blocks:
                yield from block(f"upsample_{level}", f"output_blocks.{idx}.{sub}", _RES)
                ds *= 2
            idx += 1

    yield from _norm_leaves("out_norm", "out.0") + _conv_leaves("out_conv", "out.2")


def flax_to_state_dict(params: dict, **arch) -> Dict[str, torch.Tensor]:
    """Map the flax param tree of ``ivid_tpu``'s AdmUnet2d to this port's
    state dict (the reference's names) for the same architecture args
    (``image_size``, ``model_channels``, ``num_res_blocks``,
    ``channel_mult``, ``attention_resolutions``, ``num_classes``)."""
    sd = {}
    for path, name, layout in _leaves(**arch):
        leaf = params
        for key in path:
            leaf = leaf[key]
        # A copy: leaves fetched from JAX or read from a file may be read-only.
        sd[name] = torch.from_numpy(
            np.array(_TO_PORT[layout](np.asarray(leaf)), np.float32, order="C"))
    return sd


def state_dict_to_flax(sd: Dict[str, torch.Tensor], **arch) -> dict:
    """The inverse of :func:`flax_to_state_dict`: the port's state dict
    (tensors or numpy arrays) as the flax param tree of the JAX package's
    AdmUnet2d, float32 numpy leaves, the tree the JAX package's
    ``torch_state_dict_to_flax`` makes of the same weights."""
    tree: dict = {}
    for path, name, layout in _leaves(**arch):
        w = sd[name]
        if isinstance(w, torch.Tensor):
            w = w.detach().cpu().float().numpy()
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.ascontiguousarray(_TO_FLAX[layout](np.asarray(w, np.float32)))
    return tree
