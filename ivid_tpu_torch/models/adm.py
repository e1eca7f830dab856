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
their weights to bf16 per call. GroupNorm's statistics are float32 with eps
1e-5, the timestep/class embedding MLP runs in float32, and the output head
in float32. An inference forward on the card normalises through one kernel
per site (:mod:`ivid_tpu_torch.ops.group_norm`): GroupNorm with its
scale-shift (read from the embedding's f32 output) and its SiLU, computed in
float32 from the bf16 input and rounded once, to bf16 in the torso and to
f32 at the head. Training, and any call autograd records, keeps the
composition: the input cast to f32, GroupNorm, the result cast back, the
scale-shift in the torso's type, then the SiLU. The public call takes and
returns NHWC tensors; internally activations are NCHW, and in inference on
the card NCHW in memory too (the kernel reads each group as one slab).
There, too, a residual block's convolutions run without their biases: the
first one's is added in f32 by the output norm's kernel as it reads the
convolution's output, the last one's and a 1x1 skip's by the residual sum's
kernel (:mod:`ivid_tpu_torch.ops.bias_residual`), which rounds the sum once.

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

An inference forward on the card replays a CUDA graph of itself
(:class:`InferenceGraphs`, :meth:`AdmUnet2d.graphable`): at batch 1 the
forward's ~1,500 eager launches take the host several times as long as the
device takes to run them.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.hooks

from ivid_tpu_torch import cuda_build
from ivid_tpu_torch.ops import attention as attn_ops
from ivid_tpu_torch.ops import bias_residual as res_ops
from ivid_tpu_torch.ops import group_norm as gn_ops
from ivid_tpu_torch.utils.profiling import span

#: CUDA graphs one UNet keeps, one per call signature: a sampler calls each
#: model with one signature; a signature past the bound runs eagerly.
MAX_GRAPHS = 4


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
    """GroupNorm with float32 statistics whatever the activation type, and
    the SiLU and scale-shift that follow it at the UNet's sites:
    ``norm(x, act, emb, dtype)`` is :func:`gn_ops.group_norm_act` with this
    module's groups, affine and eps (the kernel on the card in inference,
    else the composition)."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__(num_groups, num_channels, eps=1e-5)

    def forward(self, x, act: bool = False, emb: Optional[torch.Tensor] = None,
                dtype: Optional[torch.dtype] = None, in_bias: Optional[torch.Tensor] = None):
        return gn_ops.group_norm_act(x, self.weight, self.bias, self.num_groups, self.eps,
                                     act=act, emb=emb, dtype=dtype, in_bias=in_bias)


class Conv2d(nn.Conv2d):
    """Convolution in its input's type: f32 parameters cast per call;
    ``bias=False`` leaves the bias out, for the kernel that next reads the
    output to add."""

    def forward(self, x, bias: bool = True):
        b = None if self.bias is None or not bias else self.bias.to(x.dtype)
        return self._conv_forward(x, self.weight.to(x.dtype), b)


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

    def folds_biases(self, x, emb) -> bool:
        """Whether this call leaves its convolutions' biases to the kernels
        that next read their outputs: where every tensor of the block takes
        the kernels (:func:`cuda_build.kernel_applies`: on the card, autograd
        recording none of them) and its convolutions are plain
        :class:`Conv2d` (the layers of ``parallel/tensor.py`` add their own
        biases, a row-parallel one after its all-reduce)."""
        convs = (self.in_layers[2], self.out_layers[3], self.skip_connection)
        return (all(type(m) in (Conv2d, nn.Identity) for m in convs)
                and cuda_build.kernel_applies(x, emb, *self.parameters()))

    def forward(self, x, emb, deterministic: bool = True):
        with span("unet.resblock"):
            # In inference on the card the first convolution's bias goes to
            # the output norm and the last's and the skip's to the residual
            # sum, each added in f32 as the kernel reads the output; torch
            # would spend a broadcast pass over each output on it.
            fold = self.folds_biases(x, emb)
            h = self.in_layers[0](x, act=True)  # with in_layers[1], the SiLU
            if self.up:
                h, x = _up(h), _up(x)
            elif self.down:
                h, x = _down(h), _down(x)
            conv_in = self.in_layers[2]
            fold_in = fold and self.use_scale_shift_norm
            h = conv_in(h, bias=False) if fold_in else conv_in(h)
            emb_out = self.emb_layers(emb)
            norm, _, drop, conv = self.out_layers  # out_layers[1], the SiLU, fused in norm
            if self.use_scale_shift_norm:
                h = norm(h, act=True, emb=emb_out, in_bias=conv_in.bias if fold_in else None)
            else:
                h = norm(h + emb_out.to(h.dtype)[..., None, None], act=True)
            if not deterministic and drop.p > 0:
                # torch's global generator draws the mask (the JAX package's
                # ``dropout`` rng stream has no counterpart here).
                h = F.dropout(h, drop.p, training=True)
            if not fold:
                return self.skip_connection(x) + conv(h)
            skip = self.skip_connection
            if isinstance(skip, Conv2d):
                return res_ops.bias_residual(skip(x, bias=False), conv(h, bias=False),
                                             conv.bias, skip.bias)
            return res_ops.bias_residual(x, conv(h, bias=False), conv.bias)


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


class _Graph:
    """One captured forward: the graph, its static inputs and output, and
    the kernel launches its capture counted (``cuda_build.launches`` keys)."""

    def __init__(self, graph, inputs, out, launches):
        self.graph, self.inputs, self.out, self.launches = graph, inputs, out, launches

    def replay(self, *args) -> torch.Tensor:
        with span("unet.graph_replay"), torch.cuda.device(self.out.device):
            for static, a in zip(self.inputs, args):
                if static is not None:
                    static.copy_(a)
            self.graph.replay()
            cuda_build.launches.update(self.launches)
            return self.out.clone()


class InferenceGraphs:
    """CUDA graphs of one UNet's inference forward, one per call signature
    (:meth:`key`), at most ``limit``: the cache behind the graphed path of
    :meth:`AdmUnet2d.forward`.

    A signature's first call runs the forward eagerly on a side stream (the
    warm-up: cuDNN's and cuBLAS's lazy set-up and K1's first launch happen
    outside the capture) and returns that output; then it captures the
    forward with the inputs copied to static buffers. Every later call
    copies its inputs into those buffers, replays, and returns a clone of
    the static output, which the next call overwrites. The same kernels run
    in the same order on the same types as eagerly. The launch counter
    (``cuda_build.launches``) counts what ran on the device: the capture
    takes back what it counted, each replay adds it again.

    The graphs of one cache share a memory pool and the side stream: every
    graph's static output lives as long as the graph, so a capture reuses
    only other graphs' temporaries, and a module's calls run one after
    another on the caller's stream, as any graph's replays must.

    A graph holds the addresses of the tensors it read. Copying into the
    parameters in place (``load_state_dict`` without ``assign``,
    ``Tensor.copy_``, an optimizer's step) keeps every graph valid and
    their replays read the new values; whatever gives a parameter new
    storage has to :meth:`clear` the cache: :meth:`AdmUnet2d._apply`
    (``.to()``, ``.cuda()``, ``.float()``) and ``load_state_dict(...,
    assign=True)`` on the UNet do, and ``parallel.tensor.shard_unet`` does
    when it replaces layers. Setting ``.data`` does not. A module holding
    graphs cannot be deep-copied or pickled."""

    def __init__(self, limit: int = MAX_GRAPHS):
        self.limit = limit
        self.clear()

    def clear(self) -> None:
        self.entries = {}
        self.pool = self.stream = None
        #: ``(hook stamp, whether the layers allow a replay)``, see
        #: :meth:`AdmUnet2d.graphable`.
        self.layers_checked = None

    @staticmethod
    def key(x: torch.Tensor, t: torch.Tensor, classes: Optional[torch.Tensor]) -> tuple:
        """The signature a graph is captured for: the input's shape and
        type, the timesteps' shape, whether labels are given, and the TF32
        settings, which choose the convolution and matmul kernels a capture
        bakes in (callers switch TF32 off to compare with the CPU)."""
        return (tuple(x.shape), x.dtype, tuple(t.shape), classes is None,
                torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)

    def run(self, forward, x, t, classes) -> Optional[torch.Tensor]:
        """``forward(x, t, classes)`` through this cache: a replay, or a
        signature's first call (a warm-up and a capture); None for a new
        signature past the bound (the caller runs it eagerly)."""
        key = self.key(x, t, classes)
        entry = self.entries.get(key)
        if entry is not None:
            return entry.replay(x, t, classes)
        if len(self.entries) >= self.limit:
            return None
        out, self.entries[key] = self._capture(forward, x, t, classes)
        return out

    def _capture(self, forward, x, t, classes):
        with torch.cuda.device(x.device):
            caller = torch.cuda.current_stream()
            if self.stream is None:
                self.stream = torch.cuda.Stream()
            # The side stream waits for the caller's queued work, so what it
            # allocates (an earlier warm-up's output the caller has freed
            # among it) is no longer read; the caller waits for the warm-up.
            self.stream.wait_stream(caller)
            with torch.cuda.stream(self.stream):
                out = forward(x, t, classes)
            caller.wait_stream(self.stream)
            inputs = [None if a is None else a.clone() for a in (x, t, classes)]
            before = cuda_build.launches.copy()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                                  capture_error_mode="thread_local"):
                static_out = forward(*inputs)
        launches = cuda_build.launches - before
        cuda_build.launches -= launches
        if self.pool is None:
            self.pool = graph.pool()
        return out, _Graph(graph, inputs, static_out, launches)


class AdmUnet2d(nn.Module):
    """The ADM UNet. ``unet(x, t, classes)``: ``x`` [B,H,W,C] NHWC, ``t`` [B]
    integer timesteps, ``classes`` [B] labels or None (label -1 is the null
    class when ``has_null_class``). Returns float32 [B,H,W,out_channels].
    ``deterministic=False`` applies dropout (JAX's flag of the same name).
    A call that :meth:`graphable` admits replays a CUDA graph of the forward
    from ``graphs`` (:class:`InferenceGraphs`); every other call runs
    eagerly. Under torch.profiler a forward is the span ``unet.forward``
    around its blocks' ``unet.resblock`` and ``unet.attnblock`` spans, or,
    for a replay, around the span ``unet.graph_replay``.
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
        self.graphs = InferenceGraphs()
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

    def graphable(self, x: torch.Tensor, deterministic: bool = True) -> bool:
        """Whether a call replays a CUDA graph: ``x`` on the card, no
        gradient, eval mode, ``deterministic``, and nothing that a replay
        would bypass: no layer of ``parallel/tensor.py`` (they all-reduce
        inside the forward), no forward hook on a layer or on every module,
        and no dispatch mode (``FlopCounterMode`` counts the operations a
        replay does not call)."""
        return (x.device.type == "cuda" and deterministic and not self.training
                and not torch.is_grad_enabled() and not torch._C._len_torch_dispatch_stack()
                and self._layers_replayable())

    def _layers_replayable(self) -> bool:
        """No layer of tensor parallelism and no forward hook below the
        UNet. The walk over the layers is redone only after a hook has been
        registered anywhere (the handles' counter moved) or the graphs were
        dropped, since it costs more than a replay."""
        from ivid_tpu_torch.parallel import tensor as tp

        nn_module = torch.nn.modules.module
        stamp = torch.utils.hooks.RemovableHandle.next_id
        checked = self.graphs.layers_checked
        if checked is None or checked[0] != stamp:
            hooked = bool(nn_module._global_forward_hooks or nn_module._global_forward_pre_hooks)
            ok = not hooked and not any(
                isinstance(m, tp.LAYERS) or m._forward_hooks or m._forward_pre_hooks
                for m in self.modules() if m is not self)
            checked = self.graphs.layers_checked = (stamp, ok)
        return checked[1]

    def _apply(self, fn, *args, **kwargs):
        self.graphs.clear()  # the parameters may get new storage
        return super()._apply(fn, *args, **kwargs)

    def load_state_dict(self, state_dict, strict: bool = True, assign: bool = False):
        """``nn.Module.load_state_dict``; with ``assign`` the parameters
        become the given tensors, so the captured graphs are dropped."""
        if assign:
            self.graphs.clear()
        return super().load_state_dict(state_dict, strict=strict, assign=assign)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                classes: Optional[torch.Tensor] = None,
                deterministic: bool = True) -> torch.Tensor:
        assert x.shape[1] == x.shape[2] == self.image_size, (
            f"expected {self.image_size}^2 input, got {tuple(x.shape)}"
        )
        assert x.shape[-1] == self.in_channels
        with span("unet.forward"):
            if self.graphable(x, deterministic):
                out = self.graphs.run(self._forward, x, t, classes)
                if out is not None:
                    return out
            return self._forward(x, t, classes, deterministic)

    def _forward(self, x, t, classes=None, deterministic: bool = True) -> torch.Tensor:
        """The eager forward."""
        emb = self.time_embed(t)
        if self.num_classes is not None and classes is not None:
            valid = classes >= 0
            class_emb = self.label_emb(torch.where(valid, classes, torch.zeros_like(classes)))
            emb = emb + class_emb * valid[:, None].float()

        # Wherever a norm site may launch the GroupNorm kernel, the torso is
        # NCHW in memory, the one layout the kernel takes: the permuted NHWC
        # input would carry its channels-last strides into the
        # convolutions' outputs and the residual stream. Every site's input
        # comes out of the input layer, so where autograd records it (its
        # input or its parameters, as in training) every site records and
        # keeps the composition, and the torso keeps that layout, as on the
        # CPU.
        h = x.permute(0, 3, 1, 2)
        nchw = cuda_build.kernel_applies(h, *self.input_blocks[0].parameters())
        h = h.to(self.dtype, memory_format=torch.contiguous_format if nchw
                 else torch.preserve_format)
        hs = []
        for block in self.input_blocks:
            h = block(h, emb, deterministic)
            hs.append(h)
        h = self.middle_block(h, emb, deterministic)
        for block in self.output_blocks:
            h = block(torch.cat([h, hs.pop()], dim=1), emb, deterministic)
        h = self.out[0](h, act=True, dtype=torch.float32)  # with out[1], the SiLU
        h = self.out[2](h)
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
