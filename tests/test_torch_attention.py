"""Port attention vs the JAX package: the plain version of the packed-attention
kernel (what the port's wrapper runs on a CPU tensor) against the Pallas kernel
interpreted on the CPU and against ``reference_attention``, and its gradient
(autograd of the plain version: the backward kernel's plain version) against
``jax.grad`` of the JAX ``reference_attention``.

Tolerance: 1e-5 absolute in f32 (outputs and gradients are O(1) sums of
N(0,1) values; only summation order and the exp2 fold differ)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ivid_tpu.ops import attention as jattn
from ivid_tpu_torch.ops import attention as tattn

torch.set_num_threads(2)
TOL = 1e-5


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
    before = tattn.launches, tattn.bwd_launches
    (got,) = torch.autograd.grad(tattn.packed_attention(x, heads, scale), x, torch.from_numpy(g))
    assert (tattn.launches, tattn.bwd_launches) == before
    assert np.abs(np.asarray(want)).max() > 0.1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=0)


def test_cpu_wrapper_uses_plain_version_and_counts_no_launch():
    qkv = torch.from_numpy(_qkv(2, 64, 3, seed=1))
    before = tattn.launches
    out = tattn.packed_attention(qkv, 3, 0.5)
    assert tattn.launches == before
    torch.testing.assert_close(out, tattn.reference_attention(qkv, 3, 0.5), rtol=0, atol=0)
    assert out.shape == (2, 64, 192)


def test_non_cuda_accelerator_raises():
    qkv = torch.zeros((1, 8, 192), device="meta")
    with pytest.raises(ValueError):
        tattn.packed_attention(qkv, 1, 0.5)
