"""A plain-torch model of the rounding of K1's f32 path (split-precision TF32
products on the tensor cores, ``ivid_tpu_torch/csrc/tf32.cuh``), held against
an f64 reference on the CPU before any card sees the kernel.

The model takes the kernel's steps in the kernel's order:
- TF32 round-to-nearest (ties away from zero, ``cvt.rna.tf32.f32``) by the
  integer view of the f32 bits;
- the split ``hi = tf32(x)``, ``lo = tf32(x - hi)``;
- each k8 step of a product as three tensor-core products lo*hi, hi*lo,
  hi*hi, ``lo*lo`` dropped: for S (which starts from zero in every 64-key
  tile) into the tensor cores' accumulator, for O (which runs over the whole
  walk) into a fresh accumulator that is then added to O in f32. Products
  of two TF32 values are exact; the model sums a step's 8 in f64 and rounds
  the accumulator toward zero, the tensor cores' way of rounding it;
- the online softmax over 64-key tiles with the base-2 fold and the deferred
  divide, P split in registers for the value product.

One step is not bit-exact: the kernel takes each exponent with
``ex2.approx.ftz.f32`` (``hopper::exp2_approx``), an approximation the CPU
cannot reproduce. The model takes it exactly (in f64, rounded to f32) and
flushes results below 2^-126 to zero as ``.ftz`` does; one case perturbs
every exponent by a seeded relative error of up to 2^-21 to show that the
margin does not rest on an exact exponent. The card's check against the
plain version covers the approximation itself.

Tolerances: 1e-5 absolute against f64 at unit inputs (the kernel's own
check against the plain version on the card is 1e-4). The model also shows
why O stays out of the tensor cores' accumulator: summed there, the
round-toward-zero drifts with the walk's length (5e-6 at T=1024 in the model
and on the H100, against 1.1e-6 with O in step sums). At inputs scaled x8
the logits reach ~200 and any f32 evaluation, the plain version's too, is
~1e-3 from f64 on outputs of up to ~40, so that case is held to 1e-4 of the
largest output, as ``chip_smoke.py`` holds the kernel.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivid_tpu.ops import attention as jattn
from ivid_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)

SCALE = 64 ** -0.25
UNIT_ABS = 1e-5
SCALED_REL = 1e-4


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32 (10 mantissa bits), to nearest, ties away from zero."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def round_toward_zero(x64: torch.Tensor) -> torch.Tensor:
    """f64 to f32, rounded toward zero."""
    y = x64.float()
    over = y.double().abs() > x64.abs()
    return torch.where(over, torch.nextafter(y, torch.zeros_like(y)), y)


def exp2_ftz(x: torch.Tensor, rel_err: float = 0.0, gen=None) -> torch.Tensor:
    """2^x in f32 with results below 2^-126 flushed to zero; with ``rel_err``,
    each result times (1 + u·rel_err), u uniform in [-1, 1] from ``gen``."""
    y = torch.exp2(x.double())
    if rel_err:
        y = y * (1 + rel_err * (2 * torch.rand(y.shape, generator=gen, dtype=torch.float64) - 1))
    y = y.float()
    return torch.where(y < 2.0 ** -126, torch.zeros_like(y), y)


def mma3(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor, step_sums=True) -> torch.Tensor:
    """acc + a @ b as the kernel takes it: per k8 step, lo*hi, hi*lo, hi*hi
    on the tensor cores into a fresh accumulator, which is then added to
    ``acc`` in f32. ``step_sums=False`` keeps the running sum in the tensor
    cores' accumulator instead (the first design, kept for the comparison)."""
    for k0 in range(0, a.shape[-1], 8):
        ah, al = split(a[..., k0:k0 + 8])
        bh, bl = split(b[..., k0:k0 + 8, :])
        t = torch.zeros_like(acc) if step_sums else acc
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            t = round_toward_zero(t.double() + x.double() @ y.double())
        acc = acc + t if step_sums else t
    return acc


def kernel_model(qkv: torch.Tensor, heads: int, scale: float, tile: int = 64,
                 step_sums: bool = True, exp_err: float = 0.0):
    """K1's f32 path on one sample [1, T, 3C]: (out [1, T, C], lse [1, H, T]).
    S is summed in the tensor cores' accumulator (one tile), O in step sums;
    ``step_sums=False`` sums O there too (the first design). ``exp_err``
    perturbs every exponent (:func:`exp2_ftz`)."""
    gen = torch.Generator().manual_seed(5)
    _, t, c3 = qkv.shape
    q, k, v = (x[0].transpose(0, 1) for x in tattn._split_heads(qkv, heads))  # [H, T, 64]
    qscale = torch.tensor(scale * scale * math.log2(math.e), dtype=torch.float32)
    o = torch.zeros_like(q)
    m = torch.full(q.shape[:2], -math.inf)
    l = torch.zeros(q.shape[:2])
    for k0 in range(0, t, tile):
        kt, vt = k[:, k0:k0 + tile], v[:, k0:k0 + tile]
        s = mma3(q, kt.transpose(1, 2), torch.zeros(q.shape[:2] + (kt.shape[1],)), False)
        mnew = torch.maximum(m, s.amax(-1) * qscale)
        alpha = exp2_ftz(m - mnew, exp_err, gen)
        p = exp2_ftz((s.double() * qscale.double() - mnew.double()[..., None]).float(),
                     exp_err, gen)
        l = l * alpha + p.sum(-1)
        o = mma3(p, vt, o * alpha[..., None], step_sums)
        m = mnew
    out = (o / l[..., None]).transpose(0, 1).reshape(1, t, c3 // 3)
    lse = (m + torch.log2(l)) * math.log(2)
    return out, lse[None]


def _qkv(t, heads, mult, seed=0):
    x = np.random.default_rng(seed).standard_normal((1, t, 3 * 64 * heads)) * mult
    return torch.from_numpy(x.astype(np.float32))


def test_tf32_rounding_by_the_integer_view():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(4096).astype(np.float32))
    x = torch.cat([x, -x, torch.tensor([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11), 0.0])])
    hi = tf32_rna(x)
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()  # 10 mantissa bits left
    err = (hi.double() - x.double()).abs()
    assert (err <= x.double().abs() * 2 ** -11).all()  # half an ulp of TF32
    # Ties go away from zero: 1 + 2^-11 is halfway between 1 and 1 + 2^-10.
    assert hi[-4].item() == 1 + 2 ** -10 and hi[-2].item() == -(1 + 2 ** -10)
    assert hi[-3].item() == 1 + 2 * 2 ** -10 and hi[-1].item() == 0.0
    # Where TF32 is exact, rounding changes nothing.
    assert torch.equal(tf32_rna(hi), hi)


def test_split_keeps_f32_accuracy_and_drops_only_lo_lo():
    rng = np.random.default_rng(2)
    a = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
    hi, lo = split(a)
    assert ((lo.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((hi.double() + lo.double() - a.double()).abs() <= a.double().abs() * 2 ** -21).all()
    exact = a.double() @ b.double()
    three = mma3(a, b, torch.zeros(64, 64))
    one = tf32_rna(a).double() @ tf32_rna(b).double()
    scale = (a.double().abs() @ b.double().abs()).max().item()
    # Three products reach near f32 accuracy; one TF32 product stays ~1e-3 off.
    assert (three.double() - exact).abs().max().item() < 1e-6 * scale
    assert (one - exact).abs().max().item() > 1e-4 * scale


@pytest.mark.parametrize("mult, exp_err", [
    pytest.param(1.0, 0.0, id="unit"), pytest.param(8.0, 0.0, id="x8"),
    pytest.param(1.0, 2.0 ** -21, id="unit-approx-exp")])
def test_kernel_model_holds_f64_at_1024_tokens(mult, exp_err):
    heads = 4
    qkv = _qkv(1024, heads, mult)
    got, lse = kernel_model(qkv, heads, SCALE, exp_err=exp_err)
    want = tattn.reference_attention(qkv.double(), heads, SCALE)
    want_lse = tattn.logsumexp_reference(qkv.double(), heads, SCALE)
    err = (got.double() - want).abs().max().item()
    lse_err = (lse.double() - want_lse).abs().max().item()
    if mult == 1.0:
        assert err <= UNIT_ABS, err
        assert lse_err <= UNIT_ABS, lse_err
    else:
        plain = tattn.reference_attention(qkv, heads, SCALE)
        plain_err = (plain.double() - want).abs().max().item()
        top = want.abs().max().item()
        assert err <= SCALED_REL * top, (err, top)
        # The plain version in f32 is as far from f64: the tolerance is f32's.
        assert plain_err > 0.1 * err, (plain_err, err)


def test_kernel_model_matches_the_jax_reference():
    """The modelled kernel against the JAX package's f32 reference attention
    on the same inputs (what the port's plain version is held to)."""
    heads = 4
    qkv = _qkv(1024, heads, 1.0, seed=3)
    got, _ = kernel_model(qkv, heads, SCALE)
    want = np.asarray(jattn.reference_attention(jnp.asarray(qkv.numpy()), heads, SCALE))
    assert np.abs(got.numpy() - want).max() <= 1e-4


def test_step_sums_hold_the_plain_versions_accuracy():
    """O summed in the tensor cores' accumulator (round toward zero at every
    step) drifts an order of magnitude further from f64 than the plain
    version in f32; the kernel's step sums bring it within a few times the
    plain version's error."""
    heads = 4
    qkv = _qkv(1024, heads, 1.0, seed=4)
    want = tattn.reference_attention(qkv.double(), heads, SCALE)
    err = {s: (kernel_model(qkv, heads, SCALE, step_sums=s)[0].double() - want).abs().max().item()
           for s in (True, False)}
    plain = (tattn.reference_attention(qkv, heads, SCALE).double() - want).abs().max().item()
    assert err[True] <= 3 * plain and 3 * err[True] < err[False], (err, plain)
