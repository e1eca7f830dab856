"""ADM UNet diffusion backbone as ``nn.Module``s.

Port of ``ivid_tpu/models/adm.py`` with the reference's module layout, so its
state-dict names are the reference's (``time_embed.{1,3}``, ``label_emb``,
``input_blocks.N.{0,1}``, ``middle_block.{0,1,2}``, ``output_blocks.N.k``,
``out.{0,2}``; ``in_layers``/``emb_layers``/``out_layers``/``skip_connection``
in residual blocks, ``norm``/``qkv``/``proj_out`` in attention blocks) and a
reference checkpoint loads as it is.

Precision: every parameter is stored in float32 (the master weights an
optimizer updates). With ``use_fp16`` the torso computes in bfloat16: its
activations are bf16, and the convolutions and attention projections cast
their weights to bf16 per call. GroupNorm runs in float32 with eps 1e-5, the
timestep/class embedding MLP in float32, and the output head in float32. The
public call takes and returns NHWC tensors; internally activations are NCHW.

Dropout applies only where a caller asks for it (``deterministic=False``),
as in the JAX package, whose callers never do: the module's
``train()``/``eval()`` mode changes nothing in the forward. The dropout
module stays at index 2 of ``out_layers``, so the reference's names
(``out_layers.3``) hold.

Initialization follows the reference: the residual blocks' second
convolution, the attention output projection and the output convolution
start at zero, so a fresh model predicts exactly zero.

Attention mirrors the JAX package's choice of implementation: the packed
CUDA kernel (:func:`ivid_tpu_torch.ops.attention.packed_attention`) where it
would pick its packed Pallas kernel (T ≥ 512 tokens, 64-wide heads), the plain
matmul form elsewhere.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ivid_tpu_torch.ops import attention as attn_ops
from ivid_tpu_torch.utils.profiling import span


def timestep_embedding(t: torch.Tensor, dim: int, max_freq: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding ``[cos(t f_i), sin(t f_i)]``, ``f_i = max_freq^{-i/(dim/2)}``."""
    assert dim % 2 == 0, "dim must be even"
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_freq) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class TimestepEmbedding(nn.Module):
    """Parameter-free first stage of ``time_embed``."""

    def __init__(self, dim: int):
        super().__init__()
        self.dim = dim

    def forward(self, t):
        return timestep_embedding(t, self.dim)


class GroupNorm32(nn.GroupNorm):
    """GroupNorm computed in float32 whatever the activation type."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__(num_groups, num_channels, eps=1e-5)

    def forward(self, x):
        return F.group_norm(x.float(), self.num_groups, self.weight, self.bias,
                            self.eps).to(x.dtype)


class Conv2d(nn.Conv2d):
    """Convolution in its input's type: f32 parameters cast per call."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), bias)


def _conv(cin: int, cout: int, k: int, zero: bool = False) -> Conv2d:
    conv = Conv2d(cin, cout, k, padding=k // 2)
    if zero:
        nn.init.zeros_(conv.weight)
        nn.init.zeros_(conv.bias)
    return conv


def _down(x):
    """2x2 average pool, summed in float32."""
    return F.avg_pool2d(x.float(), 2).to(x.dtype)


def _up(x):
    return F.interpolate(x, scale_factor=2, mode="nearest")


class ResBlock(nn.Module):
    """Residual block with scale-shift-norm timestep conditioning and
    optional in-block resampling."""

    def __init__(self, channels, emb_channels, out_channels, num_groups=32,
                 dropout=0.0, use_scale_shift_norm=True, up=False, down=False):
        super().__init__()
        self.up, self.down = up, down
        self.use_scale_shift_norm = use_scale_shift_norm
        self.in_layers = nn.Sequential(
            GroupNorm32(num_groups, channels), nn.SiLU(), _conv(channels, out_channels, 3)
        )
        self.emb_layers = nn.Sequential(
            nn.SiLU(),
            nn.Linear(emb_channels, 2 * out_channels if use_scale_shift_norm else out_channels),
        )
        self.out_layers = nn.Sequential(
            GroupNorm32(num_groups, out_channels), nn.SiLU(), nn.Dropout(dropout),
            _conv(out_channels, out_channels, 3, zero=True),
        )
        self.skip_connection = (
            _conv(channels, out_channels, 1) if channels != out_channels else nn.Identity()
        )

    def forward(self, x, emb, deterministic: bool = True):
        with span("unet.resblock"):
            h = self.in_layers[1](self.in_layers[0](x))
            if self.up:
                h, x = _up(h), _up(x)
            elif self.down:
                h, x = _down(h), _down(x)
            h = self.in_layers[2](h)
            emb_out = self.emb_layers(emb).to(h.dtype)[..., None, None]
            norm, act, drop, conv = self.out_layers
            if self.use_scale_shift_norm:
                scale, shift = emb_out.chunk(2, dim=1)
                h = act(norm(h) * (1 + scale) + shift)
            else:
                h = act(norm(h + emb_out))
            if not deterministic and drop.p > 0:
                # torch's global generator draws the mask (the JAX package's
                # ``dropout`` rng stream has no counterpart here).
                h = F.dropout(h, drop.p, training=True)
            return self.skip_connection(x) + conv(h)


class TokenConv1d(nn.Conv1d):
    """A 1x1 ``Conv1d`` (the reference's ``[out, in, 1]`` parameters) applied
    to token-major ``[B, T, in]`` input in its type: f32 parameters cast per
    call."""

    def forward(self, x):
        return F.linear(x, self.weight[:, :, 0].to(x.dtype), self.bias.to(x.dtype))


class AttentionBlock(nn.Module):
    """Global spatial self-attention over a packed qkv projection with an f32
    softmax; q and k are each scaled by ``1/sqrt(sqrt(D))``. ``heads`` is the
    count this module computes: under tensor parallelism
    (``parallel/tensor.py``) its share of the block's heads, whose qkv
    columns it holds."""

    def __init__(self, channels, num_groups=32, num_heads=1, num_head_channels=-1):
        super().__init__()
        if num_head_channels != -1:
            assert channels % num_head_channels == 0, (
                f"channels {channels} not divisible by num_head_channels {num_head_channels}"
            )
            self.heads = channels // num_head_channels
        else:
            self.heads = num_heads
        self.head_dim = channels // self.heads
        self.norm = GroupNorm32(num_groups, channels)
        self.qkv = TokenConv1d(channels, 3 * channels, 1)
        self.proj_out = TokenConv1d(channels, channels, 1)
        nn.init.zeros_(self.proj_out.weight)
        nn.init.zeros_(self.proj_out.bias)

    def uses_kernel(self, tokens: int) -> bool:
        """Whether an input of ``tokens`` positions goes through the packed
        kernel (the JAX package's choice: T >= 512 and 64-wide heads)."""
        return tokens >= 512 and self.head_dim == attn_ops.HEAD_DIM

    def forward(self, x):
        with span("unet.attnblock"):
            b, c, hh, ww = x.shape
            t = hh * ww
            tokens = x.reshape(b, c, t).transpose(1, 2)
            normed = self.norm(x).reshape(b, c, t).transpose(1, 2)
            qkv = self.qkv(normed).contiguous()
            scale = float(1.0 / np.sqrt(np.sqrt(self.head_dim)))
            # Meta tensors carry only shapes (``utils/summary.py`` counts a
            # forward's FLOPs on them): the plain version's products stand in.
            if self.uses_kernel(t) and qkv.device.type != "meta":
                out = attn_ops.packed_attention(qkv, self.heads, scale)
            else:
                out = attn_ops.reference_attention(qkv, self.heads, scale)
            out = self.proj_out(out)
            return (tokens + out).transpose(1, 2).reshape(b, c, hh, ww)


class EmbedSequential(nn.Sequential):
    """Sequential that hands the timestep embedding to its residual blocks."""

    def forward(self, x, emb, deterministic: bool = True):
        for layer in self:
            x = layer(x, emb, deterministic) if isinstance(layer, ResBlock) else layer(x)
        return x


class AdmUnet2d(nn.Module):
    """The ADM UNet. ``unet(x, t, classes)``: ``x`` [B,H,W,C] NHWC, ``t`` [B]
    integer timesteps, ``classes`` [B] labels or None (label -1 is the null
    class when ``has_null_class``). Returns float32 [B,H,W,out_channels].
    ``deterministic=False`` applies dropout (JAX's flag of the same name).
    Under torch.profiler a forward is the span ``unet.forward`` around its
    blocks' ``unet.resblock`` and ``unet.attnblock`` spans.
    ``arch_args`` holds the arguments that name the parameters, as the
    converters of ``models/convert.py`` take them."""

    def __init__(self, image_size: int, in_channels: int, model_channels: int,
                 out_channels: int, num_res_blocks: int,
                 attention_resolutions: Sequence[int], dropout: float = 0.0,
                 channel_mult: Sequence[float] = (1, 2, 4, 8),
                 num_classes: Optional[int] = None, has_null_class: bool = False,
                 num_groups: int = 32, num_heads: int = 1, num_head_channels: int = -1,
                 use_scale_shift_norm: bool = True, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.image_size = image_size
        self.in_channels = in_channels
        self.num_classes = num_classes
        self.dtype = dtype
        self.arch_args = dict(
            image_size=image_size, model_channels=model_channels, num_res_blocks=num_res_blocks,
            channel_mult=list(channel_mult), attention_resolutions=list(attention_resolutions),
            num_classes=num_classes)
        ed = model_channels * 4
        self.time_embed = nn.Sequential(
            TimestepEmbedding(model_channels), nn.Linear(model_channels, ed), nn.SiLU(),
            nn.Linear(ed, ed),
        )
        if num_classes is not None:
            self.label_emb = nn.Embedding(num_classes, ed)
        res_kw = dict(num_groups=num_groups, dropout=dropout,
                      use_scale_shift_norm=use_scale_shift_norm)
        attn_kw = dict(num_groups=num_groups, num_heads=num_heads or 1,
                       num_head_channels=num_head_channels)

        ch = int(channel_mult[0] * model_channels)
        self.input_blocks = nn.ModuleList([EmbedSequential(_conv(in_channels, ch, 3))])
        chans = [ch]
        ds = image_size
        for level, mult in enumerate(channel_mult):
            for _ in range(num_res_blocks):
                out_ch = int(mult * model_channels)
                layers = [ResBlock(ch, ed, out_ch, **res_kw)]
                ch = out_ch
                if ds in attention_resolutions:
                    layers.append(AttentionBlock(ch, **attn_kw))
                self.input_blocks.append(EmbedSequential(*layers))
                chans.append(ch)
            if level != len(channel_mult) - 1:
                self.input_blocks.append(EmbedSequential(ResBlock(ch, ed, ch, down=True, **res_kw)))
                chans.append(ch)
                ds //= 2
        self.middle_block = EmbedSequential(
            ResBlock(ch, ed, ch, **res_kw), AttentionBlock(ch, **attn_kw),
            ResBlock(ch, ed, ch, **res_kw),
        )
        self.output_blocks = nn.ModuleList()
        for level, mult in list(enumerate(channel_mult))[::-1]:
            for i in range(num_res_blocks + 1):
                skip_ch = chans.pop()
                out_ch = int(mult * model_channels)
                layers = [ResBlock(ch + skip_ch, ed, out_ch, **res_kw)]
                ch = out_ch
                if ds in attention_resolutions:
                    layers.append(AttentionBlock(ch, **attn_kw))
                if level and i == num_res_blocks:
                    layers.append(ResBlock(ch, ed, ch, up=True, **res_kw))
                    ds *= 2
                self.output_blocks.append(EmbedSequential(*layers))
        assert not chans
        self.out = nn.Sequential(GroupNorm32(num_groups, ch), nn.SiLU(),
                                 _conv(ch, out_channels, 3, zero=True))

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                classes: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        assert x.shape[1] == x.shape[2] == self.image_size, (
            f"expected {self.image_size}^2 input, got {tuple(x.shape)}"
        )
        assert x.shape[-1] == self.in_channels
        with span("unet.forward"):
            emb = self.time_embed(t)
            if self.num_classes is not None and classes is not None:
                valid = classes >= 0
                class_emb = self.label_emb(torch.where(valid, classes, torch.zeros_like(classes)))
                emb = emb + class_emb * valid[:, None].float()

            h = x.permute(0, 3, 1, 2).to(self.dtype)
            hs = []
            for block in self.input_blocks:
                h = block(h, emb, deterministic)
                hs.append(h)
            h = self.middle_block(h, emb, deterministic)
            for block in self.output_blocks:
                h = block(torch.cat([h, hs.pop()], dim=1), emb, deterministic)
            h = self.out(h.float())
            return h.permute(0, 2, 3, 1)


def build_adm_unet(args: dict, dtype: Optional[torch.dtype] = None) -> AdmUnet2d:
    """An AdmUnet2d from a reference-schema backbone config dict.
    ``use_fp16`` selects the bf16 torso unless ``dtype`` is given;
    ``conv_resample``/``resblock_updown`` are accepted and ignored."""
    args = dict(args)
    use_low_precision = args.pop("use_fp16", False)
    args.pop("conv_resample", None)
    args.pop("resblock_updown", None)
    if args.get("num_heads") is None:
        args["num_heads"] = 1
    if args.get("num_head_channels") is None:
        args["num_head_channels"] = -1
    if dtype is None:
        dtype = torch.bfloat16 if use_low_precision else torch.float32
    return AdmUnet2d(**args, dtype=dtype)


BACKBONES = {"AdmUnet2d": build_adm_unet}


def randomize_parameters(model: nn.Module, seed: int) -> nn.Module:
    """Draw every parameter from a numpy seed, in name order: weights
    N(0, 1/fan_in), biases N(0, 0.02²), norm scales 1 + N(0, 0.1²) and shifts
    N(0, 0.1²), class embeddings N(0, 1). Unlike a fresh init (whose output
    convolution and attention projections are zero, so the model outputs
    exactly zero), every layer then reaches the output."""
    rng = np.random.default_rng(seed)
    norms = {id(m.weight) for m in model.modules() if isinstance(m, nn.GroupNorm)}
    norms |= {id(m.bias) for m in model.modules() if isinstance(m, nn.GroupNorm)}
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            z = rng.standard_normal(tuple(p.shape))
            if id(p) in norms:
                v = (1.0 if name.endswith("weight") else 0.0) + 0.1 * z
            elif name.startswith("label_emb"):
                v = z
            elif p.dim() >= 2:
                v = z / np.sqrt(p[0].numel())
            else:
                v = 0.02 * z
            p.copy_(torch.from_numpy(v.astype(np.float32)).to(p.dtype))
    return model
