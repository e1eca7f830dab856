"""Port attention vs the JAX package: the plain version of the packed-attention
kernel (what the port's wrapper runs on a CPU tensor) against the Pallas kernel
interpreted on the CPU and against ``reference_attention``, and its gradient
(autograd of the plain version: the backward kernel's plain version) against
``jax.grad`` of the JAX ``reference_attention``.

Also the plain versions of the kernels' other outputs: K1's row
log-sum-exp against ``jax.nn.logsumexp`` of the JAX package's logits, and
K4's formula form (``dV = PᵀdO``, ``dS = P∘(dP − D)``, ``dQ = s²·dS K``,
``dK = s²·dSᵀ Q`` from ``qkv, out, dout, lse``) against ``jax.vjp`` of the
JAX ``reference_attention``, at T=1024 with 4 and 6 heads.

Tolerance: 1e-5 absolute in f32 (outputs and gradients are O(1) sums of
N(0,1) values; only summation order and the exp2 fold differ); for the
formula backward 1e-4 relative L2, because its f32 sums over 1024 keys run
in another order than autograd's."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivid_tpu.ops import attention as jattn
from ivid_tpu_torch import cuda_build
from ivid_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)
TOL = 1e-5
FORMULA_REL = 1e-4


def _qkv(b, t, heads, seed=0):
    return np.random.default_rng(seed).standard_normal((b, t, 3 * heads * 64)).astype(np.float32)


@pytest.mark.parametrize("heads", [2, 4])
def test_plain_matches_pallas_kernel_and_reference(heads):
    qkv = _qkv(1, 512, heads)
    scale = 64 ** -0.25
    got = tattn.packed_attention(torch.from_numpy(qkv), heads, scale).numpy()
    kernel = np.asarray(jattn._packed_attention_fwd_kernel(jnp.asarray(qkv), heads, scale,
                                                           interpret=True))
    ref = np.asarray(jattn.reference_attention(jnp.asarray(qkv), heads, scale))
    np.testing.assert_allclose(got, kernel, atol=TOL, rtol=0)
    np.testing.assert_allclose(got, ref, atol=TOL, rtol=0)


@pytest.mark.parametrize("t", [64, 512])
def test_plain_gradient_matches_jax_grad(t):
    heads, scale = 2, 64 ** -0.25
    qkv = _qkv(2, t, heads, seed=4)
    g = np.random.default_rng(5).standard_normal((2, t, heads * 64)).astype(np.float32)
    want = jax.grad(lambda x: jnp.sum(jattn.reference_attention(x, heads, scale) * g))(
        jnp.asarray(qkv))
    x = torch.from_numpy(qkv).requires_grad_()
    before = cuda_build.launches.copy()
    (got,) = torch.autograd.grad(tattn.packed_attention(x, heads, scale), x, torch.from_numpy(g))
    assert cuda_build.launches == before
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_cpu_wrapper_uses_plain_version_and_counts_no_launch():
    qkv = torch.from_numpy(_qkv(2, 64, 3, seed=1))
    before = cuda_build.launches.copy()
    out = tattn.packed_attention(qkv, 3, 0.5)
    assert cuda_build.launches == before
    torch.testing.assert_close(out, tattn.reference_attention(qkv, 3, 0.5), rtol=0, atol=0)
    assert out.shape == (2, 64, 192)


def test_non_cuda_accelerator_raises():
    qkv = torch.zeros((1, 8, 192), device="meta")
    with pytest.raises(ValueError):
        tattn.packed_attention(qkv, 1, 0.5)


def test_launch_on_the_current_device_switches_no_context():
    # A device without an index is the current one: the wrappers launch
    # without entering torch.cuda.device (host time on every launch).
    assert isinstance(cuda_build._on_device(torch.device("cuda")), contextlib.nullcontext)


@pytest.mark.parametrize("bad, match", [
    (dict(dtype=torch.float16), "float32 or bfloat16"),
    (dict(width=3 * 2 * 32), "64-wide heads"),
    (dict(strided=True), "contiguous"),
])
def test_wrapper_checks_refuse_what_the_kernels_do_not_take(bad, match):
    width = bad.get("width", 3 * 2 * 64)
    qkv = torch.zeros((1, 8, 2 * width) if bad.get("strided") else (1, 8, width),
                      dtype=bad.get("dtype", torch.float32))
    if bad.get("strided"):
        qkv = qkv[..., ::2]
    with pytest.raises((TypeError, ValueError), match=match):
        tattn._check(qkv, 2)


@pytest.mark.parametrize("heads", [4, 6])
def test_logsumexp_reference_matches_jax_logits(heads):
    qkv = _qkv(1, 1024, heads, seed=6)
    scale = 64 ** -0.25
    # The JAX package's logits (ivid_tpu/ops/attention.py reference_attention).
    q, k, _ = jnp.split(jnp.asarray(qkv).reshape(1, 1024, heads, 192), 3, axis=-1)
    logits = jnp.einsum("bthd,bshd->bhts", q * scale, k * scale)
    want = np.asarray(jax.nn.logsumexp(logits.astype(jnp.float32), axis=-1))
    got = tattn.logsumexp_reference(torch.from_numpy(qkv), heads, scale)
    assert got.shape == (1, heads, 1024) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


@pytest.mark.parametrize("heads", [4, 6])
def test_formula_backward_matches_jax_vjp(heads):
    qkv = _qkv(1, 1024, heads, seed=7)
    g = np.random.default_rng(8).standard_normal((1, 1024, heads * 64)).astype(np.float32)
    scale = 64 ** -0.25
    _, pull = jax.vjp(lambda x: jattn.reference_attention(x, heads, scale), jnp.asarray(qkv))
    want = np.asarray(pull(jnp.asarray(g))[0])
    x = torch.from_numpy(qkv)
    out = tattn.reference_attention(x, heads, scale)
    lse = tattn.logsumexp_reference(x, heads, scale)
    got = tattn.attention_backward_reference(x, out, torch.from_numpy(g), lse, heads, scale)
    assert got.shape == x.shape and got.dtype == x.dtype
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel <= FORMULA_REL, rel
