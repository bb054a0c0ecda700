"""The port's plain attention against the JAX Pallas kernels (interpret mode).

Inputs are made with numpy from a seed and given to both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.ops.qkv_attention import fused_qkv_attention as jax_attention
from ssl4polyp_tpu.ops.qkv_attention import fused_qkv_bias_attention as jax_bias_attention
from ssl4polyp_tpu_torch.ops.qkv_attention import (
    fused_qkv_attention,
    fused_qkv_attention_backward_reference,
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
    assert set(ops.launch_counts().values()) == {0}


# The backward: dqkv (and dbias) against jax.vjp of the interpret-mode
# kernels.  fp32: the same algorithm, summation order only.  bf16: both
# round W, dS and dqkv at the same points, so outputs differ by flipped
# roundings of one bf16 ulp (2^-8 relative) and what they carry through
# the dQ and dK sums; dbias is the fp32 sum of those over every row.
BWD_F32_TOL = 1e-4
BWD_BF16_TOL = 2e-2


def _jax_vjp(qkv, bias, dout, H, softmax_f32, valid_len, dtype):
    q, d = jnp.asarray(qkv, dtype), jnp.asarray(dout, dtype)
    if bias is None:
        _, vjp = jax.vjp(lambda a: jax_attention(a, H, True, softmax_f32, valid_len), q)
        return np.asarray(vjp(d)[0].astype(jnp.float32)), None
    _, vjp = jax.vjp(lambda a, b: jax_bias_attention(a, b, H, True, softmax_f32, valid_len),
                     q, jnp.asarray(bias, dtype))
    dqkv, dbias = vjp(d)
    return np.asarray(dqkv.astype(jnp.float32)), np.asarray(dbias.astype(jnp.float32))


def _torch_vjp(qkv, bias, dout, H, softmax_f32, valid_len, dtype):
    t_bias = None if bias is None else torch.from_numpy(bias).to(dtype)
    dqkv, dbias = fused_qkv_attention_backward_reference(
        torch.from_numpy(qkv).to(dtype), torch.from_numpy(dout).to(dtype), H, softmax_f32,
        valid_len, t_bias)
    return dqkv.float().numpy(), None if dbias is None else dbias.float().numpy()


def _assert_grads_close(ours, ref, tol):
    for name, a, b in zip(("dqkv", "dbias"), ours, ref):
        if b is None:
            assert a is None
            continue
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize(
    "B, N, H, hd, valid_len, with_bias",
    [
        (2, 37, 4, 16, None, True),
        (2, 29, 2, 32, 25, True),
        (2, 29, 2, 32, None, False),
        (1, 24, 2, 64, 19, True),
        (2, 21, 2, 64, None, False),
        # The paths' lengths (the MAE encoder's 50, the classifier's and the
        # decoder's 197), the edges of a 16-row tile, and one valid key.
        (1, 50, 2, 64, None, True),
        (1, 50, 2, 32, 1, False),
        (1, 197, 2, 64, None, True),
        (1, 197, 2, 32, 150, False),
        (1, 16, 2, 64, None, False),
        (1, 17, 2, 32, 1, True),
        (1, 17, 2, 16, 16, True),
    ],
)
def test_backward_reference_matches_jax_kernel_fp32(B, N, H, hd, valid_len, with_bias):
    qkv, bias = _inputs(4, B, N, H, hd, with_bias)
    dout = np.random.default_rng(5).standard_normal((B, N, H * hd)).astype(np.float32)
    for softmax_f32 in (True, False):
        ours = _torch_vjp(qkv, bias, dout, H, softmax_f32, valid_len, torch.float32)
        ref = _jax_vjp(qkv, bias, dout, H, softmax_f32, valid_len, jnp.float32)
        _assert_grads_close(ours, ref, BWD_F32_TOL)


@pytest.mark.parametrize("hd, valid_len", [(32, 25), (64, None)])
def test_backward_reference_matches_jax_kernel_bf16(hd, valid_len):
    # The pretrain recipe: bf16 with the scores rounded before the softmax.
    qkv, bias = _inputs(6, 2, 29, 2, hd, True)
    dout = np.random.default_rng(7).standard_normal((2, 29, 2 * hd)).astype(np.float32)
    ours = _torch_vjp(qkv, bias, dout, 2, False, valid_len, torch.bfloat16)
    ref = _jax_vjp(qkv, bias, dout, 2, False, valid_len, jnp.bfloat16)
    _assert_grads_close(ours, ref, BWD_BF16_TOL)


@pytest.mark.parametrize(
    "N, hd, valid_len", [(197, 64, None), (197, 32, None), (50, 64, None), (17, 32, 1)]
)
def test_backward_reference_matches_jax_kernel_bf16_fp32_scores(N, hd, valid_len):
    # The fine-tune recipe: bf16 with fp32 scores, at the paths' lengths and
    # one valid key.  The same roundings as the bf16-score case, so the same
    # tolerance: a flipped rounding of dS moves dQ or dK by |k| or |q| times
    # one bf16 ulp of dS, far inside 2e-2 of max|dqkv|.
    qkv, bias = _inputs(12, 1, N, 2, hd, True)
    dout = np.random.default_rng(13).standard_normal((1, N, 2 * hd)).astype(np.float32)
    ours = _torch_vjp(qkv, bias, dout, 2, True, valid_len, torch.bfloat16)
    ref = _jax_vjp(qkv, bias, dout, 2, True, valid_len, jnp.bfloat16)
    _assert_grads_close(ours, ref, BWD_BF16_TOL)


@pytest.mark.parametrize("softmax_f32", [True, False])
def test_backward_reference_is_autograd_of_the_forward_in_fp32(softmax_f32):
    # In fp32 every rounding is the identity, so the JAX kernel's backward
    # steps are the exact gradient of the plain forward.
    qkv, bias = _inputs(8, 2, 23, 2, 32, True)
    dout = torch.from_numpy(np.random.default_rng(9).standard_normal((2, 23, 64)).astype(np.float32))
    q = torch.from_numpy(qkv).requires_grad_()
    b = torch.from_numpy(bias).requires_grad_()
    fused_qkv_attention_reference(q, 2, softmax_f32, 20, b).backward(dout)
    dqkv, dbias = fused_qkv_attention_backward_reference(q.detach(), dout, 2, softmax_f32, 20,
                                                         b.detach())
    torch.testing.assert_close(dqkv, q.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(dbias, b.grad, rtol=1e-5, atol=1e-5)


def test_cpu_wrapper_backward_is_the_reference():
    qkv, bias = _inputs(10, 2, 17, 2, 16, True)
    q = torch.from_numpy(qkv).to(torch.bfloat16).requires_grad_()
    b = torch.from_numpy(bias).to(torch.bfloat16).requires_grad_()
    dout = torch.from_numpy(np.random.default_rng(11).standard_normal((2, 17, 32))).to(torch.bfloat16)
    fused_qkv_attention(q, 2, False, 15, b).backward(dout)
    dqkv, dbias = fused_qkv_attention_backward_reference(q.detach(), dout, 2, False, 15,
                                                         b.detach())
    torch.testing.assert_close(q.grad, dqkv, rtol=0, atol=0)
    torch.testing.assert_close(b.grad, dbias, rtol=0, atol=0)


def test_backward_kernel_wrapper_refuses_a_dout_the_kernel_cannot_copy():
    # The kernel copies dout in 16-byte pieces: a strided or misaligned dout
    # must be refused before any launch (it would fault on the card).
    from ssl4polyp_tpu_torch.ops.qkv_attention import _backward_kernel

    qkv = torch.zeros((1, 8, 96), dtype=torch.bfloat16)
    wide = torch.zeros((1, 8, 64), dtype=torch.bfloat16)
    flat = torch.zeros(8 * 32 + 1, dtype=torch.bfloat16)
    for dout in (wide[:, :, ::2], flat[1:].view(1, 8, 32)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            _backward_kernel(qkv, dout, 2, True, None, None)
