"""Port attention vs the JAX package: the plain version of the packed-attention
kernel (what the port's wrapper runs on a CPU tensor) against the Pallas kernel
interpreted on the CPU and against ``reference_attention``.

Tolerance: 1e-5 absolute in f32 (outputs are O(1) averages of N(0,1) values;
only summation order and the exp2 fold differ)."""

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
