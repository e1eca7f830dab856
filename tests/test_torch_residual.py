"""The residual sum with the convolutions' biases (``ops/bias_residual.py``).

- The plain version is ``skip + conv + (bias + bias2)`` in f32, rounded once
  to the tensors' type, in bf16 and f32, with and without a skip bias.
- A CUDA tensor whose computation autograd does not record goes to the
  kernel's launch, every other tensor to the plain version.
- The wrapper's C call passes the pointers, the shape, the type and the
  stream, and counts ``RES``; it raises on a type, shape or layout the kernel
  does not take before anything is built or launched.

The kernel itself is held to the plain version bit for bit on the card by
``chip_smoke.py``'s ``[residual]`` phase, at the benchmarked models'
residual shapes with an identity and a 1x1 skip.
"""

import numpy as np
import pytest
import torch

from ivid_tpu_torch import cuda_build
from ivid_tpu_torch.ops import bias_residual as res

torch.set_num_threads(2)


def _tensor(shape, seed, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("skip_bias", [False, True], ids=["identity", "conv1x1"])
def test_plain_version_is_the_sum_with_the_biases(skip_bias, dtype):
    """In f32 the two tensors, then the summed biases per channel; rounded
    once. Against the parent's composition (each bias added to its
    convolution's output in the torso's type, then the sum): within one
    rounding of the type at each of its three steps."""
    skip, conv = _tensor((2, 24, 8, 8), 1, dtype), _tensor((2, 24, 8, 8), 2, dtype)
    b, b2 = 0.1 * _tensor((24,), 3), (0.1 * _tensor((24,), 4) if skip_bias else None)
    got = res.plain(skip, conv, b, b2)
    total = b if b2 is None else b + b2
    want = torch.add(skip.float(), conv.float()).add_(total.view(1, -1, 1, 1)).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    parent = conv + b.to(dtype)[:, None, None]
    parent = (skip if b2 is None else skip + b2.to(dtype)[:, None, None]) + parent
    eps = torch.finfo(dtype).eps
    scale = skip.float().abs() + conv.float().abs() + total.abs()[:, None, None]
    assert ((got.float() - parent.float()).abs() <= 3 * eps * scale + 1e-30).all()


@pytest.mark.parametrize("on_card", [False, True], ids=["cpu", "card"])
@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_dispatch_follows_the_norm_kernels_rule(grad, on_card, monkeypatch):
    """The kernel where ``cuda_build.kernel_applies``: on the card, autograd
    recording none of the tensors; the plain version elsewhere."""
    launched = []

    def fake_launch(skip, conv, bias, bias2):
        launched.append(conv.shape)
        return res.plain(skip, conv, bias, bias2)

    monkeypatch.setattr(cuda_build, "on_card", lambda x: on_card)
    monkeypatch.setattr(res, "_launch", fake_launch)
    skip, conv = _tensor((1, 8, 4, 4), 1), _tensor((1, 8, 4, 4), 2)
    bias = _tensor((8,), 3).requires_grad_(grad)
    with torch.set_grad_enabled(grad):
        got = res.bias_residual(skip, conv, bias)
    assert len(launched) == (1 if on_card and not grad else 0)
    assert torch.equal(got, res.plain(skip, conv, bias))


class _FakeStream:
    cuda_stream = 1234


def test_the_launch_passes_pointers_shapes_and_the_stream(monkeypatch):
    """The wrapper's C call, recorded instead of made, and its count."""
    calls = []

    def fake_fn(*args):
        calls.append(args)
        return 0

    monkeypatch.setattr(cuda_build, "on_card", lambda x: True)
    monkeypatch.setattr(cuda_build, "function", lambda *a, **k: fake_fn)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _FakeStream())
    skip = _tensor((2, 16, 8, 8), 1, torch.bfloat16)
    conv = _tensor((2, 16, 8, 8), 2, torch.bfloat16)
    b, b2 = _tensor((16,), 3), _tensor((16,), 4)
    before = cuda_build.launches["RES"]
    with torch.no_grad():
        y = res.bias_residual(skip, conv, b, b2)
        res.bias_residual(skip.float(), conv.float(), b)
    assert cuda_build.launches["RES"] == before + 2
    assert y.shape == conv.shape and y.dtype == torch.bfloat16 and y.is_contiguous()
    assert calls[0] == (skip.data_ptr(), conv.data_ptr(), y.data_ptr(), b.data_ptr(),
                        b2.data_ptr(), 2, 16, 64, 1, 1234)
    assert calls[1][3:] == (b.data_ptr(), 0, 2, 16, 64, 0, 1234)


def _case(name):
    bf = torch.bfloat16
    x = torch.zeros((2, 16, 8, 8), dtype=bf)
    cases = {
        "f16": (dict(skip=x.half(), conv=x.half()), TypeError),
        "mixed types": (dict(skip=x.float()), TypeError),
        "three dims": (dict(skip=x[0], conv=x[0]), ValueError),
        "shapes differ": (dict(skip=torch.zeros((2, 16, 4, 4), dtype=bf)), ValueError),
        "odd width": (dict(skip=torch.zeros((2, 16, 3, 3), dtype=bf),
                           conv=torch.zeros((2, 16, 3, 3), dtype=bf)), ValueError),
        "skip channels last": (dict(skip=x.to(memory_format=torch.channels_last)), ValueError),
        "conv channels last": (dict(conv=x.to(memory_format=torch.channels_last)), ValueError),
        "misaligned": (dict(conv=torch.zeros(2 * 16 * 64 + 1, dtype=bf)[1:].view(2, 16, 8, 8)),
                       ValueError),
        "bias shape": (dict(bias=torch.zeros(8)), ValueError),
        "bf16 skip bias": (dict(bias2=torch.zeros(16, dtype=bf)), ValueError),
    }
    kw, err = cases[name]
    args = dict(skip=x, conv=x.clone(), bias=torch.zeros(16), bias2=None)
    args.update(kw)
    return args, err


@pytest.mark.parametrize("name", ["f16", "mixed types", "three dims", "shapes differ",
                                  "odd width", "skip channels last", "conv channels last",
                                  "misaligned", "bias shape", "bf16 skip bias"])
def test_kernel_raises_on_what_it_does_not_take(name, monkeypatch):
    def no_build(*args, **kwargs):
        raise AssertionError("the kernel was built or launched")

    monkeypatch.setattr(cuda_build, "on_card", lambda x: True)
    monkeypatch.setattr(cuda_build, "function", no_build)
    args, err = _case(name)
    before = cuda_build.launches.copy()
    with torch.no_grad(), pytest.raises(err):
        res.bias_residual(**args)
    assert cuda_build.launches == before
