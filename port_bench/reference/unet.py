"""The ADM UNet in plain PyTorch: the benchmark's reference model.

A frozen copy of the layer equations of ``ivid_tpu_torch/models/adm.py``
with the same parameter names (``time_embed.{1,3}``, ``label_emb``,
``input_blocks.N.k``, ``middle_block.k``, ``output_blocks.N.k``,
``out.{0,2}``), so one set of weights drawn by :mod:`port_bench.weights`
loads into both. Attention is the two-product form with an f32 softmax at
every site; no kernel of the port is used.

``precision`` chooses how the torso computes:

- ``"f32"``: float32 throughout (the reference; the caller turns TF32 off).
- ``"bf16"``: a bfloat16 torso, f32 GroupNorm, embedding MLP and output
  head, as the port computes a ``use_fp16`` model.
- ``"fp8"``: the ``"bf16"`` torso with both operands of every convolution,
  qkv/output projection and attention product rounded to float8 e4m3 (one
  scale per tensor, its absolute maximum at 448): the control one step
  below a bfloat16 model.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

PRECISIONS = ("f32", "bf16", "fp8")
_E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    absolute maximum maps to 448), returned in ``x``'s type. The gradient
    passes straight through the rounding."""
    with torch.no_grad():
        scale = x.abs().amax().float().clamp(min=1e-12) / _E4M3_MAX
        q = ((x.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(x.dtype)
    return x + (q - x).detach() if x.requires_grad else q


def timestep_embedding(t: torch.Tensor, dim: int, max_freq: float = 10000.0) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_freq) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        return timestep_embedding(t, self.dim)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm in float32 (eps 1e-5) whatever the activation type."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__(num_groups, num_channels, eps=1e-5)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


class Conv2d(nn.Conv2d):
    """Convolution in its input's type; fp8 operands when ``quant``."""

    quant = False

    def forward(self, x):
        w = self.weight.to(x.dtype)
        if self.quant:
            x, w = fp8_round(x), fp8_round(w)
        return self._conv_forward(x, w, self.bias.to(x.dtype))


class TokenConv1d(nn.Conv1d):
    """A 1x1 Conv1d's ``[out, in, 1]`` parameters applied to ``[B, T, in]``."""

    quant = False

    def forward(self, x):
        w = self.weight[:, :, 0].to(x.dtype)
        if self.quant:
            x, w = fp8_round(x), fp8_round(w)
        return F.linear(x, w, self.bias.to(x.dtype))


def attention(qkv: torch.Tensor, heads: int, scale: float, quant: bool) -> torch.Tensor:
    """Packed ``[B, T, 3C]`` qkv (head-major ``[h][q|k|v][D]`` columns):
    logits of ``q*scale`` and ``k*scale``, softmax in f32 cast back to the
    input type, then the value product."""
    b, t, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    q, k, v = qkv.reshape(b, t, heads, 3 * d).split(d, dim=-1)
    q, k = q * scale, k * scale
    if quant:
        q, k, v = fp8_round(q), fp8_round(k), fp8_round(v)
    logits = torch.einsum("bthd,bshd->bhts", q, k)
    w = torch.softmax(logits.float(), dim=-1).to(logits.dtype)
    if quant:
        w = fp8_round(w)
    return torch.einsum("bhts,bshd->bthd", w, v).reshape(b, t, c)


def _down(x):
    return F.avg_pool2d(x.float(), 2).to(x.dtype)


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ResBlock(nn.Module):
    def __init__(self, channels, emb_channels, out_channels, num_groups=32, up=False,
                 down=False):
        super().__init__()
        self.up, self.down = up, down
        self.in_layers = nn.Sequential(GroupNorm32(num_groups, channels), nn.SiLU(),
                                       Conv2d(channels, out_channels, 3, padding=1))
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(emb_channels, 2 * out_channels))
        self.out_layers = nn.Sequential(GroupNorm32(num_groups, out_channels), nn.SiLU(),
                                        nn.Dropout(0.0),
                                        Conv2d(out_channels, out_channels, 3, padding=1))
        self.skip_connection = (Conv2d(channels, out_channels, 1)
                                if channels != out_channels else nn.Identity())

    def forward(self, x, emb):
        h = self.in_layers[1](self.in_layers[0](x))
        if self.up:
            h, x = _up(h), _up(x)
        elif self.down:
            h, x = _down(h), _down(x)
        h = self.in_layers[2](h)
        scale, shift = self.emb_layers(emb).to(h.dtype)[..., None, None].chunk(2, dim=1)
        norm, act, _, conv = self.out_layers
        h = act(norm(h) * (1 + scale) + shift)
        return self.skip_connection(x) + conv(h)


class AttentionBlock(nn.Module):
    def __init__(self, channels, num_groups=32, num_head_channels=64):
        super().__init__()
        self.heads = channels // num_head_channels
        self.head_dim = num_head_channels
        self.norm = GroupNorm32(num_groups, channels)
        self.qkv = TokenConv1d(channels, 3 * channels, 1)
        self.proj_out = TokenConv1d(channels, channels, 1)
        self.quant = False

    def forward(self, x):
        b, c, hh, ww = x.shape
        t = hh * ww
        tokens = x.reshape(b, c, t).transpose(1, 2)
        normed = self.norm(x).reshape(b, c, t).transpose(1, 2)
        scale = float(1.0 / math.sqrt(math.sqrt(self.head_dim)))
        out = self.proj_out(attention(self.qkv(normed), self.heads, scale, self.quant))
        return (tokens + out).transpose(1, 2).reshape(b, c, hh, ww)


class EmbedSequential(nn.Sequential):
    def forward(self, x, emb):
        for layer in self:
            x = layer(x, emb) if isinstance(layer, ResBlock) else layer(x)
        return x


class Unet(nn.Module):
    """``unet(x, t, classes)``: ``x`` [B,H,W,C] NHWC, ``t`` [B] integer
    timesteps, ``classes`` [B] or None (-1: the null class). Returns float32
    [B,H,W,out_channels]."""

    def __init__(self, image_size: int, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int, attention_resolutions: Sequence[int],
                 channel_mult: Sequence[float], num_classes: Optional[int] = None,
                 num_groups: int = 32, num_head_channels: int = 64, precision: str = "f32"):
        super().__init__()
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.image_size = image_size
        self.num_classes = num_classes
        self.dtype = torch.float32 if precision == "f32" else torch.bfloat16
        ed = model_channels * 4
        self.time_embed = nn.Sequential(TimestepEmbedding(model_channels),
                                        nn.Linear(model_channels, ed), nn.SiLU(),
                                        nn.Linear(ed, ed))
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, ed)
        attn = dict(num_groups=num_groups, num_head_channels=num_head_channels)
        ch = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList([EmbedSequential(Conv2d(in_channels, ch, 3,
                                                                  padding=1))])
        chans = [ch]
        ds = image_size
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                out_ch = int(mult * model_channels)
                layers = [ResBlock(ch, ed, out_ch, num_groups)]
                ch = out_ch
                if ds in attention_resolutions:
                    layers.append(AttentionBlock(ch, **attn))
                self.input_blocks.append(EmbedSequential(*layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(EmbedSequential(ResBlock(ch, ed, ch, num_groups,
                                                                  down=True)))
                chans.append(ch)
                ds //= 2
        self.middle_block = EmbedSequential(ResBlock(ch, ed, ch, num_groups),
                                            AttentionBlock(ch, **attn),
                                            ResBlock(ch, ed, ch, num_groups))
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                out_ch = int(mult * model_channels)
                layers = [ResBlock(ch + chans.pop(), ed, out_ch, num_groups)]
                ch = out_ch
                if ds in attention_resolutions:
                    layers.append(AttentionBlock(ch, **attn))
                if level and i == num_res_blocks:
                    layers.append(ResBlock(ch, ed, ch, num_groups, up=True))
                    ds *= 2
                self.output_blocks.append(EmbedSequential(*layers))
        self.out = nn.Sequential(GroupNorm32(num_groups, ch), nn.SiLU(),
                                 Conv2d(ch, out_channels, 3, padding=1))
        if precision == "fp8":
            for m in self.modules():
                if isinstance(m, (Conv2d, TokenConv1d, AttentionBlock)) and m is not self.out[2]:
                    m.quant = True

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                classes: Optional[torch.Tensor] = None) -> torch.Tensor:
        emb = self.time_embed(t)
        if self.num_classes is not None and classes is not None:
            valid = classes >= 0
            class_emb = self.label_emb(torch.where(valid, classes, torch.zeros_like(classes)))
            emb = emb + class_emb * valid[:, None].float()
        h = x.permute(0, 3, 1, 2).to(self.dtype)
        hs = []
        for block in self.input_blocks:
            h = block(h, emb)
            hs.append(h)
        h = self.middle_block(h, emb)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb)
        h = self.out(h.float())
        return h.permute(0, 2, 3, 1)


def build_unet(args: dict, precision: str = "f32") -> Unet:
    """A reference UNet from a reference-schema backbone ``args`` dict (the
    ``backbone.args`` of a config)."""
    return Unet(
        image_size=args["image_size"], in_channels=args["in_channels"],
        model_channels=args["model_channels"], out_channels=args["out_channels"],
        num_res_blocks=args["num_res_blocks"],
        attention_resolutions=args["attention_resolutions"],
        channel_mult=args["channel_mult"], num_classes=args.get("num_classes"),
        num_groups=args.get("num_groups", 32),
        num_head_channels=args.get("num_head_channels") or 64, precision=precision)
