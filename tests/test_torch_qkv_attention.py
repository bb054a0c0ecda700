"""The port's plain attention against the JAX Pallas kernels (interpret mode).

Inputs are made with numpy from a seed and given to both frameworks.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.ops.qkv_attention import fused_qkv_attention as jax_attention
from ssl4polyp_tpu.ops.qkv_attention import fused_qkv_bias_attention as jax_bias_attention
from ssl4polyp_tpu_torch.ops.qkv_attention import (
    fused_qkv_attention,
    fused_qkv_attention_reference,
)

# fp32 on both sides, same algorithm: only summation order differs.
F32_TOL = 2e-5
# bf16 on both sides: both round the scale fold, the scores (softmax_f32
# False), the weights and the output to bf16 at the same points; a rounding
# that flips on an fp32 order difference moves an output by one bf16 ulp,
# 2^-7 relative at |out| < 2.
BF16_TOL = 1.6e-2


def _inputs(seed, B, N, H, hd, with_bias, dtype=np.float32):
    rng = np.random.default_rng(seed)
    qkv = rng.standard_normal((B, N, 3 * H * hd)).astype(dtype)
    bias = (0.5 * rng.standard_normal(3 * H * hd)).astype(dtype) if with_bias else None
    return qkv, bias


def _jax(qkv, bias, H, softmax_f32, valid_len, dtype):
    q = jnp.asarray(qkv, dtype)
    if bias is None:
        out = jax_attention(q, H, True, softmax_f32, valid_len)
    else:
        out = jax_bias_attention(q, jnp.asarray(bias, dtype), H, True, softmax_f32, valid_len)
    return np.asarray(out.astype(jnp.float32))


def _torch(qkv, bias, H, softmax_f32, valid_len, dtype):
    t_bias = None if bias is None else torch.from_numpy(bias).to(dtype)
    out = fused_qkv_attention_reference(torch.from_numpy(qkv).to(dtype), H, softmax_f32,
                                        valid_len, t_bias)
    return out.float().numpy()


@pytest.mark.parametrize(
    "B, N, H, hd, valid_len, with_bias",
    [
        (2, 37, 4, 16, None, False),
        (2, 37, 4, 16, 30, True),
        (2, 21, 2, 64, None, True),
        (1, 24, 2, 64, 19, False),
    ],
)
def test_reference_matches_jax_kernel_fp32(B, N, H, hd, valid_len, with_bias):
    qkv, bias = _inputs(0, B, N, H, hd, with_bias)
    for softmax_f32 in (True, False):
        ours = _torch(qkv, bias, H, softmax_f32, valid_len, torch.float32)
        ref = _jax(qkv, bias, H, softmax_f32, valid_len, jnp.float32)
        np.testing.assert_allclose(ours, ref, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("softmax_f32", [True, False])
def test_reference_matches_jax_kernel_bf16(softmax_f32):
    # hd 32: the folded scale 1/sqrt(32) is not a power of two, so folding
    # it into q in bf16 rounds, and both sides must round alike.
    qkv, bias = _inputs(1, 2, 29, 2, 32, True)
    ours = _torch(qkv, bias, 2, softmax_f32, 25, torch.bfloat16)
    ref = _jax(qkv, bias, 2, softmax_f32, 25, jnp.bfloat16)
    np.testing.assert_allclose(ours, ref, rtol=BF16_TOL, atol=BF16_TOL)


def test_valid_len_over_padding_equals_unpadded():
    # The JAX factory pads 197 tokens to 200 and masks with valid_len=197;
    # the port runs 197 as they are.  Both must agree on the valid rows.
    # Masked keys add exact zeros, so only summation order differs (fp32).
    qkv, bias = _inputs(2, 2, 197, 2, 16, True)
    padded = np.concatenate([qkv, np.ones((2, 3, qkv.shape[2]), np.float32)], axis=1)
    b = torch.from_numpy(bias)
    ours = fused_qkv_attention(torch.from_numpy(padded), 2, True, 197, b)[:, :197]
    plain = fused_qkv_attention(torch.from_numpy(qkv), 2, True, None, b)
    np.testing.assert_allclose(ours.numpy(), plain.numpy(), rtol=1e-6, atol=1e-6)


def test_cpu_wrapper_is_the_reference_and_launches_nothing():
    from ssl4polyp_tpu_torch import ops

    ops.reset_launch_counts()
    qkv, bias = _inputs(3, 1, 9, 2, 16, True)
    t, b = torch.from_numpy(qkv), torch.from_numpy(bias)
    torch.testing.assert_close(
        fused_qkv_attention(t, 2, True, 7, b),
        fused_qkv_attention_reference(t, 2, True, 7, b), rtol=0, atol=0,
    )
    assert ops.launch_counts() == {"fused_qkv_attention": 0, "fc1_gelu": 0}
