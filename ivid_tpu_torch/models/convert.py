"""JAX (flax) AdmUnet2d parameters → the port's state dict.

The inverse of ``ivid_tpu/models/torch_compat.py:torch_state_dict_to_flax``:
it replays the same construction loops to find each flax module's reference
name, and converts layouts back:

- flax conv ``[kh, kw, I, O]`` → Conv2d ``[O, I, kh, kw]``
- flax Dense ``[I, O]`` of the attention qkv/proj → Conv1d ``[O, I, 1]``
- flax Dense ``[I, O]`` of the embedding MLPs → Linear ``[O, I]``

Input leaves are numpy arrays (or anything ``np.asarray`` accepts); outputs
are float32 torch tensors ready for ``load_state_dict``.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    # A copy: leaves fetched from JAX are read-only arrays.
    return torch.from_numpy(np.array(x, np.float32, order="C"))


def _conv2d(k):  # [kh,kw,I,O] -> [O,I,kh,kw]
    return _t(np.transpose(np.asarray(k), (3, 2, 0, 1)))


def _conv1d(k):  # [I,O] -> [O,I,1]
    return _t(np.transpose(np.asarray(k), (1, 0))[:, :, None])


def _linear(k):  # [I,O] -> [O,I]
    return _t(np.transpose(np.asarray(k), (1, 0)))


def _resblock(sd, prefix, p, has_skip):
    sd[f"{prefix}.in_layers.0.weight"] = _t(p["in_norm"]["GroupNorm_0"]["scale"])
    sd[f"{prefix}.in_layers.0.bias"] = _t(p["in_norm"]["GroupNorm_0"]["bias"])
    sd[f"{prefix}.in_layers.2.weight"] = _conv2d(p["in_conv"]["kernel"])
    sd[f"{prefix}.in_layers.2.bias"] = _t(p["in_conv"]["bias"])
    sd[f"{prefix}.emb_layers.1.weight"] = _linear(p["emb_proj"]["kernel"])
    sd[f"{prefix}.emb_layers.1.bias"] = _t(p["emb_proj"]["bias"])
    sd[f"{prefix}.out_layers.0.weight"] = _t(p["out_norm"]["GroupNorm_0"]["scale"])
    sd[f"{prefix}.out_layers.0.bias"] = _t(p["out_norm"]["GroupNorm_0"]["bias"])
    sd[f"{prefix}.out_layers.3.weight"] = _conv2d(p["out_conv"]["kernel"])
    sd[f"{prefix}.out_layers.3.bias"] = _t(p["out_conv"]["bias"])
    if has_skip:
        sd[f"{prefix}.skip_connection.weight"] = _conv2d(p["skip_conv"]["kernel"])
        sd[f"{prefix}.skip_connection.bias"] = _t(p["skip_conv"]["bias"])


def _attnblock(sd, prefix, p):
    sd[f"{prefix}.norm.weight"] = _t(p["norm"]["GroupNorm_0"]["scale"])
    sd[f"{prefix}.norm.bias"] = _t(p["norm"]["GroupNorm_0"]["bias"])
    sd[f"{prefix}.qkv.weight"] = _conv1d(p["qkv"]["kernel"])
    sd[f"{prefix}.qkv.bias"] = _t(p["qkv"]["bias"])
    sd[f"{prefix}.proj_out.weight"] = _conv1d(p["proj"]["kernel"])
    sd[f"{prefix}.proj_out.bias"] = _t(p["proj"]["bias"])


def flax_to_state_dict(
    params: dict,
    *,
    image_size: int,
    model_channels: int,
    num_res_blocks: int,
    channel_mult: Sequence[float],
    attention_resolutions: Sequence[int],
    num_classes=None,
    **_unused,
) -> Dict[str, torch.Tensor]:
    """Map the flax param tree of ``ivid_tpu``'s AdmUnet2d to this port's
    state dict (the reference's names) for the same architecture args."""
    sd: Dict[str, torch.Tensor] = {
        "time_embed.1.weight": _linear(params["time_embed_1"]["kernel"]),
        "time_embed.1.bias": _t(params["time_embed_1"]["bias"]),
        "time_embed.3.weight": _linear(params["time_embed_2"]["kernel"]),
        "time_embed.3.bias": _t(params["time_embed_2"]["bias"]),
        "input_blocks.0.0.weight": _conv2d(params["in_conv"]["kernel"]),
        "input_blocks.0.0.bias": _t(params["in_conv"]["bias"]),
    }
    if num_classes is not None:
        sd["label_emb.weight"] = _t(params["label_emb"])

    idx, ds = 1, image_size
    ch = int(channel_mult[0] * model_channels)
    for level, mult in enumerate(channel_mult):
        for i in range(num_res_blocks):
            out_ch = int(mult * model_channels)
            _resblock(sd, f"input_blocks.{idx}.0", params[f"down_{level}_{i}"], out_ch != ch)
            ch = out_ch
            if ds in attention_resolutions:
                _attnblock(sd, f"input_blocks.{idx}.1", params[f"down_{level}_{i}_attn"])
            idx += 1
        if level != len(channel_mult) - 1:
            _resblock(sd, f"input_blocks.{idx}.0", params[f"downsample_{level}"], False)
            idx += 1
            ds //= 2

    _resblock(sd, "middle_block.0", params["mid_res1"], False)
    _attnblock(sd, "middle_block.1", params["mid_attn"])
    _resblock(sd, "middle_block.2", params["mid_res2"], False)

    idx = 0
    for level, mult in list(enumerate(channel_mult))[::-1]:
        for i in range(num_res_blocks + 1):
            _resblock(sd, f"output_blocks.{idx}.0", params[f"up_{level}_{i}"], True)
            sub = 1
            if ds in attention_resolutions:
                _attnblock(sd, f"output_blocks.{idx}.{sub}", params[f"up_{level}_{i}_attn"])
                sub += 1
            if level and i == num_res_blocks:
                _resblock(sd, f"output_blocks.{idx}.{sub}", params[f"upsample_{level}"], False)
                ds *= 2
            idx += 1

    sd["out.0.weight"] = _t(params["out_norm"]["GroupNorm_0"]["scale"])
    sd["out.0.bias"] = _t(params["out_norm"]["GroupNorm_0"]["bias"])
    sd["out.2.weight"] = _conv2d(params["out_conv"]["kernel"])
    sd["out.2.bias"] = _t(params["out_conv"]["bias"])
    return sd
