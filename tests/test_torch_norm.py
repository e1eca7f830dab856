"""The UNet's GroupNorm sites (``ops/group_norm.py``) on the CPU.

- :func:`group_norm_act`'s plain version is, bit for bit, the composition the
  UNet computed before the kernel: at an input-layer site (GroupNorm, SiLU),
  an output-layer site (GroupNorm, scale-shift, SiLU), an attention norm and
  the output head (GroupNorm, SiLU, f32 out).
- The dispatch: a CPU tensor takes the plain version; with gradients enabled
  a residual block, an attention block and the head keep the composition
  under autograd even on the card (the device check is monkeypatched), with
  the composition's gradients; without them every one of a UNet's sites
  goes to the kernel's launch.
- The wrapper raises on a type, shape or layout the kernel does not take,
  before anything is built or launched.
- The convolutions' biases (``ops/bias_residual.py`` and the norm's input
  bias): the plain versions are ``skip + conv + b`` and ``GN(x + b)``; on the
  faked card every residual block of a forward folds (a biased norm and a
  residual launch each, 35 in every benchmarked configuration), a CUDA
  graph's replay counts what its capture counted, and on the CPU, with
  gradients and with the tensor-parallel layers a block is the parent's
  composition bit for bit.
"""

import collections
import contextlib
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ivid_tpu_torch import cuda_build
from ivid_tpu_torch.models import adm
from ivid_tpu_torch.ops import bias_residual as res
from ivid_tpu_torch.ops import group_norm as gn
from ivid_tpu_torch.parallel import tensor as tp

torch.set_num_threads(2)

TINY = dict(
    image_size=16, in_channels=4, out_channels=4, model_channels=32,
    num_res_blocks=1, channel_mult=[1, 2], attention_resolutions=[8],
    num_groups=8, num_heads=None, num_head_channels=16, num_classes=5,
    has_null_class=True, dropout=0.0, use_fp16=True,
)


def _tensor(shape, seed, dtype=torch.float32, offset=0.0):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) + offset
    return torch.from_numpy(x).to(dtype)


def _norm(channels=32, groups=8, seed=0):
    norm = adm.GroupNorm32(groups, channels)
    with torch.no_grad():
        norm.weight.copy_(1 + 0.1 * _tensor((channels,), seed))
        norm.bias.copy_(0.1 * _tensor((channels,), seed + 1))
    return norm


# The parent's compositions, as ``models/adm.py`` wrote them before the
# fused call: GroupNorm32.forward, then the SiLU and the scale-shift around it.
def _parent_norm(norm, x):
    return F.group_norm(x.float(), norm.num_groups, norm.weight, norm.bias, norm.eps).to(x.dtype)


def _parent_site(kind, norm, x, emb):
    if kind == "input":
        return torch.nn.SiLU()(_parent_norm(norm, x))
    if kind == "output":
        scale, shift = emb.to(x.dtype)[..., None, None].chunk(2, dim=1)
        return torch.nn.SiLU()(_parent_norm(norm, x) * (1 + scale) + shift)
    if kind == "attention":
        return _parent_norm(norm, x)
    return torch.nn.SiLU()(_parent_norm(norm, x.float()))  # the head: self.out(h.float())


def _site(kind, norm, x, emb):
    if kind == "input":
        return norm(x, act=True)
    if kind == "output":
        return norm(x, act=True, emb=emb)
    if kind == "attention":
        return norm(x)
    return norm(x, act=True, dtype=torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["input", "output", "attention", "head"])
def test_plain_version_is_the_composition(kind, dtype):
    norm = _norm()
    x = _tensor((2, 32, 8, 8), 3, dtype, offset=30.0)
    emb = _tensor((2, 64), 4)
    got = _site(kind, norm, x, emb)
    want = _parent_site(kind, norm, x, emb)
    assert got.dtype == want.dtype == (torch.float32 if kind == "head" else dtype)
    assert torch.equal(got, want)


class _Launches(list):
    """The norm kernel's launches; ``residual`` holds the residual kernel's."""

    def __init__(self):
        super().__init__()
        self.residual = []


@pytest.fixture
def faked_card(monkeypatch):
    """CPU tensors taken for tensors on the card, and every kernel launch
    counted as the real ones count (in a fresh ``cuda_build.launches``),
    recorded and computed by the plain version: the norm's as (mode, input
    type, output type, groups), the residual sum's in ``.residual`` as
    (type, shape, whether a skip bias)."""
    launched = _Launches()

    def fake_launch(x, weight, bias, groups, eps, act, emb, dtype, in_bias=None):
        gn._check(x, weight, bias, groups, act, emb, dtype, in_bias)
        mode = gn.SCALE_SHIFT_SILU if emb is not None else gn.SILU if act else gn.NORM
        launched.append((mode, x.dtype, dtype, groups))
        cuda_build.launches.update(("GN",) if in_bias is None else ("GN", "GN bias"))
        return gn.plain(x, weight, bias, groups, eps, act, emb, dtype, in_bias)

    def fake_residual(skip, conv, bias, bias2):
        res._check(skip, conv, bias, bias2)
        launched.residual.append((conv.dtype, tuple(conv.shape), bias2 is not None))
        cuda_build.launches.update(("RES",))
        return res.plain(skip, conv, bias, bias2)

    monkeypatch.setattr(cuda_build, "on_card", lambda x: True)
    monkeypatch.setattr(gn, "_launch", fake_launch)
    monkeypatch.setattr(res, "_launch", fake_residual)
    monkeypatch.setattr(cuda_build, "launches", collections.Counter())
    return launched


def _no_launch(*args, **kwargs):
    raise AssertionError("the kernel was launched")


def test_cpu_takes_the_plain_version(monkeypatch):
    monkeypatch.setattr(gn, "_launch", _no_launch)
    model = adm.randomize_parameters(adm.build_adm_unet(TINY), seed=0).eval()
    x, t, classes = _tensor((2, 16, 16, 4), 5), torch.tensor([3, 700]), torch.tensor([1, -1])
    with torch.no_grad():
        out = model(x, t, classes)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_inference_launches_at_every_site(faked_card):
    """87 sites in a full UNet; here each GroupNorm32 once: input and output
    layers of every residual block, every attention norm, the head."""
    model = adm.randomize_parameters(adm.build_adm_unet(TINY), seed=0).eval()
    res = [m for m in model.modules() if isinstance(m, adm.ResBlock)]
    attn = [m for m in model.modules() if isinstance(m, adm.AttentionBlock)]
    x, t, classes = _tensor((2, 16, 16, 4), 5), torch.tensor([3, 700]), torch.tensor([1, -1])
    with torch.no_grad():
        got = model(x, t, classes)
        faked_card.clear()
        got = model(x, t, classes)
    modes = [m for m, *_ in faked_card]
    assert len(faked_card) == sum(isinstance(m, adm.GroupNorm32) for m in model.modules())
    assert modes.count(gn.SCALE_SHIFT_SILU) == len(res)
    assert modes.count(gn.NORM) == len(attn)
    assert modes.count(gn.SILU) == len(res) + 1
    assert faked_card[-1] == (gn.SILU, torch.bfloat16, torch.float32, 8)  # the head
    assert all(d == torch.bfloat16 for _, _, d, _ in faked_card[:-1])
    # The kernels' stand-ins are the plain versions: a second model's call
    # gives the same output.
    gn_cpu = adm.randomize_parameters(adm.build_adm_unet(TINY), seed=0).eval()
    with torch.no_grad():
        want = gn_cpu._forward(x, t, classes)
    assert torch.equal(got, want)


def test_a_tensor_parallel_norm_launches_with_its_own_groups(faked_card):
    """``parallel/tensor.py`` replaces an output norm by a GroupNorm32 over
    its share of the groups and channels: the same call, its own groups."""
    norm = _norm(channels=16, groups=4)
    x, emb = _tensor((2, 16, 8, 8), 6, torch.bfloat16), _tensor((2, 32), 7)
    with torch.no_grad():
        got = norm(x, act=True, emb=emb)
    assert faked_card == [(gn.SCALE_SHIFT_SILU, torch.bfloat16, torch.bfloat16, 4)]
    assert torch.equal(got, _parent_site("output", norm, x, emb))


def _grads(out, leaves):
    g = torch.from_numpy(np.random.default_rng(9).standard_normal(out.shape).astype(np.float32))
    return torch.autograd.grad(out, leaves, g.to(out.dtype))


@pytest.mark.parametrize("kind", ["resblock", "attention", "head"])
def test_grad_keeps_the_composition(kind, monkeypatch, faked_card):
    """With gradients enabled on the card the blocks never reach the
    kernel, and their outputs and gradients are the parent composition's."""
    monkeypatch.setattr(gn, "_launch", _no_launch)
    torch.manual_seed(0)
    x = _tensor((2, 32, 8, 8), 8, torch.bfloat16).requires_grad_()
    if kind == "resblock":
        block = adm.ResBlock(32, 64, 48, num_groups=8)
        adm.randomize_parameters(block, seed=1)
        emb = _tensor((2, 64), 2).requires_grad_()
        got = block(x, emb)

        def parent():
            h = block.in_layers[1](_parent_norm(block.in_layers[0], x))
            h = block.in_layers[2](h)
            emb_out = block.emb_layers(emb).to(h.dtype)[..., None, None]
            norm, act, _, conv = block.out_layers
            scale, shift = emb_out.chunk(2, dim=1)
            h = act(_parent_norm(norm, h) * (1 + scale) + shift)
            return block.skip_connection(x) + conv(h)

        leaves = [x, emb] + list(block.parameters())
    elif kind == "attention":
        block = adm.AttentionBlock(32, num_groups=8, num_head_channels=16)
        adm.randomize_parameters(block, seed=1)
        got = block(x)

        def parent():
            b, c, hh, ww = x.shape
            tokens = x.reshape(b, c, -1).transpose(1, 2)
            normed = _parent_norm(block.norm, x).reshape(b, c, -1).transpose(1, 2)
            qkv = block.qkv(normed).contiguous()
            scale = float(1.0 / np.sqrt(np.sqrt(block.head_dim)))
            out = block.proj_out(adm.attn_ops.reference_attention(qkv, block.heads, scale))
            return (tokens + out).transpose(1, 2).reshape(b, c, hh, ww)

        leaves = [x] + list(block.parameters())
    else:
        block = torch.nn.Sequential(adm.GroupNorm32(8, 32), torch.nn.SiLU(),
                                    adm._conv(32, 4, 3))
        adm.randomize_parameters(block, seed=1)
        got = block[2](block[0](x, act=True, dtype=torch.float32))

        def parent():
            return block(x.float())  # self.out(h.float())

        leaves = [x] + list(block.parameters())
    want = parent()
    assert not faked_card
    assert torch.equal(got, want)
    for a, b in zip(_grads(got, leaves), _grads(want, leaves)):
        assert torch.equal(a, b)


def _case(name):
    bf = torch.bfloat16
    w, b = torch.ones(32), torch.zeros(32)
    x = torch.zeros((2, 32, 8, 8), dtype=bf)
    cases = {
        "f16 input": (dict(x=x.half()), TypeError),
        "f32 to bf16": (dict(x=x.float(), dtype=bf), TypeError),
        "three dims": (dict(x=x[0]), ValueError),
        "odd width": (dict(x=torch.zeros((2, 32, 3, 3), dtype=bf)), ValueError),
        "groups": (dict(groups=5), ValueError),
        "misaligned": (dict(x=torch.zeros(2 * 32 * 64 + 1, dtype=bf)[1:].view(2, 32, 8, 8)),
                       ValueError),
        "channels last": (dict(x=x.to(memory_format=torch.channels_last)), ValueError),
        "bf16 weight": (dict(weight=w.to(bf)), ValueError),
        "emb shape": (dict(emb=torch.zeros((2, 32)), act=True), ValueError),
        "emb without silu": (dict(emb=torch.zeros((2, 64))), ValueError),
        "input bias shape": (dict(in_bias=torch.zeros(16)), ValueError),
        "bf16 input bias": (dict(in_bias=torch.zeros(32, dtype=bf)), ValueError),
        "slab too large": (dict(x=torch.zeros((1, 1, 1024, 2048), dtype=bf), weight=w[:1],
                                bias=b[:1], groups=1), ValueError),
    }
    kw, err = cases[name]
    args = dict(x=x, weight=w, bias=b, groups=8, eps=1e-5, act=False, emb=None, dtype=None,
                in_bias=None)
    args.update(kw)
    return args, err


@pytest.mark.parametrize("name", ["f16 input", "f32 to bf16", "three dims", "odd width", "groups",
                                  "misaligned", "channels last", "bf16 weight", "emb shape",
                                  "emb without silu", "slab too large", "input bias shape",
                                  "bf16 input bias"])
def test_kernel_raises_on_what_it_does_not_take(name, monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("the kernel was built or launched")

    monkeypatch.setattr(cuda_build, "on_card", lambda x: True)
    monkeypatch.setattr(cuda_build, "function", no_build)
    args, err = _case(name)
    before = cuda_build.launches.copy()
    with torch.no_grad(), pytest.raises(err):
        gn.group_norm_act(**args)
    assert cuda_build.launches == before


def test_meta_tensors_take_the_plain_version(monkeypatch):
    """``utils/summary.py`` counts a forward's FLOPs on the meta device."""
    monkeypatch.setattr(gn, "_launch", _no_launch)
    with torch.device("meta"):
        model = adm.build_adm_unet(TINY)
        out = model(torch.empty(1, 16, 16, 4), torch.zeros(1, dtype=torch.long))
    assert out.shape == (1, 16, 16, 4) and out.device.type == "meta"


@pytest.mark.parametrize("case", ["no_grad", "grad", "frozen", "partly_frozen",
                                  "input_layer_trained"])
def test_the_torso_is_nchw_in_inference_on_the_card(case, faked_card, monkeypatch):
    """Wherever a site may take the kernel the torso's activations are NCHW
    in memory (the permuted NHWC input is copied once): without gradients,
    and with gradients enabled on a frozen model or one whose input blocks
    are frozen (their sites launch, the later ones record). Where autograd
    records the input layer, in training or with only that layer trained,
    every site records: the torso keeps the layout the permuted input
    gives, as on the CPU, and no site launches. Every launch passes the
    kernel's checks, its input's layout among them."""
    layouts = []
    model = adm.randomize_parameters(adm.build_adm_unet(TINY), seed=0).eval()
    if case == "frozen":
        model.requires_grad_(False)
    elif case == "partly_frozen":
        model.input_blocks.requires_grad_(False)
    elif case == "input_layer_trained":
        model.requires_grad_(False)
        model.input_blocks[0].requires_grad_(True)
    model.input_blocks[1][0].register_forward_pre_hook(
        lambda mod, args: layouts.append(args[0].is_contiguous()))
    x, t = _tensor((2, 16, 16, 4), 5), torch.tensor([3, 700])
    with torch.set_grad_enabled(case != "no_grad"):
        model(x, t)
    recorded = case in ("grad", "input_layer_trained")
    assert layouts == [not recorded]
    sites = sum(isinstance(m, adm.GroupNorm32) for m in model.modules())
    if case == "partly_frozen":
        assert 0 < len(faked_card) < sites
    else:
        assert len(faked_card) == (0 if recorded else sites)


@pytest.mark.parametrize("on_card", [False, True], ids=["cpu", "card"])
@pytest.mark.parametrize("case", ["no_grad", "grad_nothing_recorded", "grad_input",
                                  "grad_weight", "grad_emb"])
def test_kernel_applies_where_autograd_records_nothing(case, on_card, monkeypatch):
    """The one rule the sites and the UNet's layout both read: on the card,
    and no tensor of the call that autograd records."""
    monkeypatch.setattr(cuda_build, "on_card", lambda x: on_card)
    x, w, emb = torch.zeros((2, 32, 8, 8)), torch.ones(32), torch.zeros((2, 64))
    recorded = {"grad_input": x, "grad_weight": w, "grad_emb": emb}.get(case)
    if recorded is not None:
        recorded.requires_grad_()
    with torch.set_grad_enabled(case != "no_grad"):
        got = cuda_build.kernel_applies(x, w, None, emb)
    assert got == (on_card and recorded is None)


class _FakeStream:
    cuda_stream = 1234


def test_the_launch_passes_shapes_modes_and_an_nchw_input(monkeypatch):
    """The wrapper's C call, recorded instead of made: the shape, the types,
    the mode, the embedding's row stride, the input bias (its own count
    beside ``GN``) and the stream; a channels-last
    input raises before any call (the kernel reads NCHW slabs, and the
    wrapper copies nothing)."""
    calls = []

    def fake_fn(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(cuda_build, "on_card", lambda x: True)
    monkeypatch.setattr(cuda_build, "function", lambda *a, **k: fake_fn)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _FakeStream())
    norm = _norm(channels=32, groups=8)
    x = _tensor((2, 32, 8, 8), 3, torch.bfloat16)
    emb = _tensor((2, 64), 4)
    in_bias = _tensor((32,), 5)
    before = cuda_build.launches.copy()
    with torch.no_grad():
        with pytest.raises(ValueError, match="NCHW"):
            norm(x.to(memory_format=torch.channels_last), act=True, emb=emb)
        assert not calls and cuda_build.launches == before
        y = norm(x, act=True, emb=emb)
        norm(x, act=True, dtype=torch.float32)
        norm(x.float())
        norm(x, act=True, emb=emb, in_bias=in_bias)
    assert cuda_build.launches["GN"] == before["GN"] + 4
    assert cuda_build.launches["GN bias"] == before["GN bias"] + 1
    assert y.shape == x.shape and y.dtype == torch.bfloat16 and y.is_contiguous()
    assert calls[0][:2] == (x.data_ptr(), y.data_ptr())
    assert calls[0][4:] == (emb.data_ptr(), 64, 0, 2, 32, 8, 64, 1, 1, gn.SCALE_SHIFT_SILU,
                            pytest.approx(1e-5), 1234)
    assert calls[1][4:14] == (0, 0, 0, 2, 32, 8, 64, 1, 0, gn.SILU)
    assert calls[2][4:14] == (0, 0, 0, 2, 32, 8, 64, 0, 0, gn.NORM)
    assert calls[3][4:7] == (emb.data_ptr(), 64, in_bias.data_ptr())


# --- the convolutions' biases folded into the kernels that read their outputs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["input", "output", "attention", "head"])
def test_plain_version_with_an_input_bias_is_the_norm_of_the_biased_input(kind, dtype):
    """``in_bias`` is added to the input in f32 before anything else: the
    plain version of ``GN(x + b)`` is the plain version on the f32 sum, with
    the output in the input's type (f32 at the head)."""
    norm = _norm()
    x = _tensor((2, 32, 8, 8), 3, dtype, offset=30.0)
    emb, b = _tensor((2, 64), 4), _tensor((32,), 5)
    act = kind != "attention"
    emb = emb if kind == "output" else None
    out = torch.float32 if kind == "head" else dtype
    got = gn.plain(x, norm.weight, norm.bias, 8, norm.eps, act, emb, out, in_bias=b)
    want = gn.plain(x.float() + b[:, None, None], norm.weight, norm.bias, 8, norm.eps, act, emb,
                    out)
    assert got.dtype == out and torch.equal(got, want)
    unbiased = gn.plain(x, norm.weight, norm.bias, 8, norm.eps, act, emb, out)
    assert not torch.equal(got, unbiased)


def _configs():
    """The benchmark's models by cell name (``port_bench/configs``)."""
    root = Path(__file__).resolve().parent.parent / "port_bench" / "configs"
    models = {}
    for name in ("sc128", "in128", "in256sr"):
        for role, model in json.loads((root / f"{name}.json").read_text())["models"].items():
            models[f"{name}.{role}"] = model["backbone"]["args"]
    return models


@pytest.mark.parametrize("name", ["sc128.uncond", "sc128.cond", "in128.uncond", "in128.cond",
                                  "in256sr.sr"])
def test_a_forward_folds_at_every_residual_block(name, faked_card):
    """Each benchmarked model at its full width on the meta device, its
    kernels faked: every residual block leaves its three convolutions'
    biases to the kernels, so a forward makes 35 residual launches (18 with
    a 1x1 skip's bias) and 35 of its 87 norm launches carry an input bias,
    all in the torso's type."""
    args = _configs()[name]
    with torch.device("meta"):
        model = adm.build_adm_unet(args)
        s, c = args["image_size"], args["in_channels"]
        classes = torch.zeros(1, dtype=torch.long) if args.get("num_classes") else None
        with torch.no_grad():
            model(torch.empty(1, s, s, c), torch.zeros(1, dtype=torch.long), classes)
    blocks = [m for m in model.modules() if isinstance(m, adm.ResBlock)]
    skips = [m for m in blocks if isinstance(m.skip_connection, adm.Conv2d)]
    assert (len(blocks), len(skips)) == (35, 18)
    assert dict(cuda_build.launches) == {"GN": 87, "GN bias": 35, "RES": 35}
    assert sum(with_skip for _, _, with_skip in faked_card.residual) == 18
    assert {d for d, _, _ in faked_card.residual} == {model.dtype}


class _FakeCudaGraph:
    def replay(self):
        pass

    def pool(self):
        return "pool"


def test_a_replay_counts_what_its_capture_counted(faked_card, monkeypatch):
    """The graphed path of a small UNet, its CUDA calls stand-ins: the
    warm-up counts a forward's norm, biased norm and residual launches, the
    capture takes back what it counted, and each replay adds them again."""
    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: stream)
    monkeypatch.setattr(torch.cuda, "Stream", lambda: stream)
    monkeypatch.setattr(torch.cuda, "stream", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _FakeCudaGraph)
    monkeypatch.setattr(torch.cuda, "graph", lambda *a, **k: contextlib.nullcontext())
    model = adm.randomize_parameters(adm.build_adm_unet(TINY), seed=0).eval()
    blocks = sum(isinstance(m, adm.ResBlock) for m in model.modules())
    sites = sum(isinstance(m, adm.GroupNorm32) for m in model.modules())
    x, t, classes = _tensor((2, 16, 16, 4), 5), torch.tensor([3, 700]), torch.tensor([1, -1])
    with torch.no_grad():
        first = model.graphs.run(model._forward, x, t, classes)
        assert dict(cuda_build.launches) == {"GN": sites, "GN bias": blocks, "RES": blocks}
        for _ in range(2):
            replayed = model.graphs.run(model._forward, x, t, classes)
    assert dict(cuda_build.launches) == {"GN": 3 * sites, "GN bias": 3 * blocks,
                                         "RES": 3 * blocks}
    assert torch.equal(replayed, first)


def _parent_block(block, x, emb):
    """The parent's residual block: every convolution with its bias."""
    h = block.in_layers[1](_parent_norm(block.in_layers[0], x))
    h = block.in_layers[2](h)
    emb_out = block.emb_layers(emb).to(h.dtype)[..., None, None]
    norm, act, _, conv = block.out_layers
    scale, shift = emb_out.chunk(2, dim=1)
    h = act(_parent_norm(norm, h) * (1 + scale) + shift)
    return block.skip_connection(x) + conv(h)


@pytest.mark.parametrize("skip", ["identity", "conv1x1"])
@pytest.mark.parametrize("case", ["cpu", "grad", "tensor_parallel"])
def test_a_block_that_does_not_fold_is_the_parents(case, skip, monkeypatch, faked_card):
    """On the CPU, with gradients recorded on the card and with the
    tensor-parallel layers (here at a model group of one: the all-reduce
    is the identity), a residual block adds its biases as the parent did,
    and its output (and gradients) are the parent's bit for bit; no
    residual launch, no biased norm."""
    if case == "cpu":
        monkeypatch.setattr(cuda_build, "on_card", lambda x: False)
    block = adm.ResBlock(32, 64, 32 if skip == "identity" else 48, num_groups=8)
    adm.randomize_parameters(block, seed=1)
    if case == "tensor_parallel":
        monkeypatch.setattr(tp, "reduce_from_model", lambda x, group: x.clone())
        for seq, i, kind in ((block.in_layers, 2, tp.ColumnConv2d),
                             (block.out_layers, 3, tp.RowConv2d)):
            conv = seq[i]
            local = kind(conv.in_channels, conv.out_channels, 3, padding=1)
            local.load_state_dict(conv.state_dict())
            seq[i] = local
    x = _tensor((2, 32, 8, 8), 8, torch.bfloat16).requires_grad_(case == "grad")
    emb = _tensor((2, 64), 2).requires_grad_(case == "grad")
    with torch.set_grad_enabled(case == "grad"):
        got = block(x, emb)
        want = _parent_block(block, x, emb)
    assert torch.equal(got, want)
    if case == "grad":
        leaves = [x, emb] + list(block.parameters())
        for a, b in zip(_grads(got, leaves), _grads(want, leaves)):
            assert torch.equal(a, b)
    assert not faked_card.residual and "GN bias" not in cuda_build.launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("skip", ["identity", "conv1x1", "up", "down"])
def test_a_folding_block_is_its_convolutions_with_their_biases(skip, dtype, faked_card):
    """On the faked card a block leaves its biases out of its convolutions
    and hands them to the kernels: the output norm adds the first one's in
    f32, the residual sum the last one's and the skip's. The result is the
    parent's block with each bias added in f32 where it is read, and within
    the torso type's rounding of the parent's."""
    cout = 48 if skip == "conv1x1" else 32
    block = adm.ResBlock(32, 64, cout, num_groups=8, up=skip == "up", down=skip == "down")
    adm.randomize_parameters(block, seed=1)
    x, emb = _tensor((2, 32, 8, 8), 8, dtype), _tensor((2, 64), 2)
    with torch.no_grad():
        got = block(x, emb)
        launched, residual = dict(cuda_build.launches), list(faked_card.residual)
        parent = _parent_block(block, x, emb) if skip in ("identity", "conv1x1") else None
        h = block.in_layers[0](x, act=True)
        xs = x
        if skip == "up":
            h, xs = adm._up(h), adm._up(x)
        elif skip == "down":
            h, xs = adm._down(h), adm._down(x)
        conv_in, conv_out, sk = block.in_layers[2], block.out_layers[3], block.skip_connection
        h = gn.plain(conv_in(h, bias=False), block.out_layers[0].weight,
                     block.out_layers[0].bias, 8, 1e-5, True, block.emb_layers(emb), dtype,
                     in_bias=conv_in.bias)
        if isinstance(sk, adm.Conv2d):
            want = res.plain(sk(xs, bias=False), conv_out(h, bias=False), conv_out.bias, sk.bias)
        else:
            want = res.plain(xs, conv_out(h, bias=False), conv_out.bias)
    assert torch.equal(got, want)
    assert launched == {"GN": 2, "GN bias": 1, "RES": 1}
    assert len(residual) == 1 and residual[0][2] == (skip == "conv1x1")
    if parent is not None:
        tol = 2e-2 if dtype == torch.bfloat16 else 1e-5
        torch.testing.assert_close(got.float(), parent.float(), rtol=tol, atol=tol)
