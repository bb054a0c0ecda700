"""The port's plain projection + attention against the JAX Pallas kernel
(interpret mode): output, dx, dw and db.

Inputs are made with numpy from a seed and given to both frameworks; ``w``
is (Din, 3D) on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.ops.attention_block import fused_qkvproj_attention as jax_qkvproj_attention
from ssl4polyp_tpu_torch import ops
from ssl4polyp_tpu_torch.ops.attention_block import (
    fused_qkvproj_attention,
    fused_qkvproj_attention_backward_reference,
    fused_qkvproj_attention_plain,
    fused_qkvproj_attention_reference,
)
from ssl4polyp_tpu_torch.ops.qkv_attention import fused_qkv_attention_plain

# fp32 on both sides, same algorithm: only summation order differs.  dw and
# db sum over every row of the batch and dx over 3D columns, so their
# tolerance is relative to the largest entry.
F32_TOL = 2e-5
BWD_F32_TOL = 1e-4
# bf16 on both sides: both round the projection twice (product, bias add),
# the scale fold, the scores (softmax_f32 False), the weights, dS (with the
# scale inside), dqkv and dx at the same points; a rounding that flips on an
# fp32 order difference moves a value by one bf16 ulp (2^-7 relative at
# |x| < 2), and the sums over rows carry such flips with random signs.
BF16_TOL = 2e-2
BWD_BF16_TOL = 3e-2


def _inputs(seed, B, N, Din, H, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    D = H * hd
    x = rng.standard_normal((B, N, Din)).astype(dtype)
    w = (rng.standard_normal((Din, 3 * D)) * Din ** -0.5).astype(dtype)
    b = (0.5 * rng.standard_normal(3 * D)).astype(dtype)
    dout = rng.standard_normal((B, N, D)).astype(dtype)
    return x, w, b, dout


def _jax_all(x, w, b, dout, H, softmax_f32, valid_len, dtype):
    args = tuple(jnp.asarray(a, dtype) for a in (x, w, b))
    out, vjp = jax.vjp(
        lambda a, c, d: jax_qkvproj_attention(a, c, d, H, True, softmax_f32, valid_len), *args)
    grads = vjp(jnp.asarray(dout, dtype))
    return tuple(np.asarray(a.astype(jnp.float32)) for a in (out, *grads))


def _torch_all(x, w, b, dout, H, softmax_f32, valid_len, dtype, fn=fused_qkvproj_attention_plain):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (x, w, b)]
    out = fn(*leaves, H, softmax_f32, valid_len)
    out.backward(torch.from_numpy(dout).to(dtype))
    return tuple(t.detach().float().numpy() for t in (out, *[a.grad for a in leaves]))


def _assert_all_close(ours, ref, tol, bwd_tol, rows=slice(None)):
    np.testing.assert_allclose(ours[0][:, rows], ref[0][:, rows], rtol=tol, atol=tol,
                               err_msg="out")
    for name, a, b in zip(("dx", "dw", "db"), ours[1:], ref[1:]):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=bwd_tol, atol=bwd_tol * scale, err_msg=name)


@pytest.mark.parametrize("softmax_f32", [True, False])
@pytest.mark.parametrize(
    "B, N, Din, H, hd, valid_len",
    [(4, 24, 16, 4, 8, None), (2, 37, 48, 4, 16, None), (2, 29, 64, 2, 32, 25),
     (1, 24, 32, 2, 64, 19)],
)
def test_plain_matches_jax_kernel_fp32(B, N, Din, H, hd, valid_len, softmax_f32):
    x, w, b, dout = _inputs(0, B, N, Din, H, hd)
    if valid_len is not None:
        dout[:, valid_len:] = 0  # the pad rows' upstream gradient is zero
    ours = _torch_all(x, w, b, dout, H, softmax_f32, valid_len, torch.float32)
    ref = _jax_all(x, w, b, dout, H, softmax_f32, valid_len, jnp.float32)
    rows = slice(None) if valid_len is None else slice(0, valid_len)
    _assert_all_close(ours, ref, F32_TOL, BWD_F32_TOL, rows)


@pytest.mark.parametrize("softmax_f32", [True, False])
@pytest.mark.parametrize("hd, valid_len", [(32, 25), (64, None)])
def test_plain_matches_jax_kernel_bf16(hd, valid_len, softmax_f32):
    # hd 32: the folded scale 1/sqrt(32) is not a power of two, so the fold
    # into q and the scale inside dS's rounding both round, and both sides
    # must round alike.
    x, w, b, dout = _inputs(1, 2, 29, 64, 2, hd)
    if valid_len is not None:
        dout[:, valid_len:] = 0
    ours = _torch_all(x, w, b, dout, 2, softmax_f32, valid_len, torch.bfloat16)
    ref = _jax_all(x, w, b, dout, 2, softmax_f32, valid_len, jnp.bfloat16)
    rows = slice(None) if valid_len is None else slice(0, valid_len)
    _assert_all_close(ours, ref, BF16_TOL, BWD_BF16_TOL, rows)


def test_equals_the_bare_projection_followed_by_the_attention_kernel_in_fp32():
    # As the JAX package's own test holds its kernel: dot + bias, then the
    # QKV attention, for the output and all three gradients.
    x, w, b, dout = _inputs(2, 4, 24, 16, 4, 8)
    ours = _torch_all(x, w, b, dout, 4, True, None, torch.float32)

    def unfused(x, w, b, H, softmax_f32, valid_len):
        return fused_qkv_attention_plain(x @ w + b, H, softmax_f32, valid_len)

    ref = _torch_all(x, w, b, dout, 4, True, None, torch.float32, fn=unfused)
    _assert_all_close(ours, ref, 1e-5, 2e-4)


def test_valid_len_over_padding_equals_truncated():
    x, w, b, dout = _inputs(3, 3, 24, 16, 4, 8)
    vl = 17
    dout[:, vl:] = 0
    padded = _torch_all(x, w, b, dout, 4, True, vl, torch.float32)
    truncated = _torch_all(x[:, :vl].copy(), w, b, dout[:, :vl].copy(), 4, True, None,
                           torch.float32)
    np.testing.assert_allclose(padded[0][:, :vl], truncated[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(padded[1][:, :vl], truncated[1], rtol=1e-5, atol=1e-5)
    # A pad row's k and v are masked and its dout is zero: its dqkv, hence
    # its dx, is zero, and dw and db see nothing of it.
    assert not padded[1][:, vl:].any()
    for a, c in zip(padded[2:], truncated[2:]):
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("softmax_f32", [True, False])
def test_backward_reference_is_autograd_of_the_forward_in_fp32(softmax_f32):
    x, w, b, dout = (torch.from_numpy(a) for a in _inputs(4, 2, 23, 32, 2, 32))
    leaves = [a.clone().requires_grad_() for a in (x, w, b)]
    fused_qkvproj_attention_reference(*leaves, 2, softmax_f32, 20).backward(dout)
    grads = fused_qkvproj_attention_backward_reference(x, w, b, dout, 2, softmax_f32, 20)
    for got, leaf in zip(grads, leaves):
        scale = max(1.0, leaf.grad.abs().max().item())
        torch.testing.assert_close(got, leaf.grad, rtol=1e-5, atol=1e-5 * scale)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    inputs = _inputs(5, 1, 9, 16, 2, 16)
    ops.reset_launch_counts()
    through_wrapper = _torch_all(*inputs, 2, True, None, torch.float32, fn=fused_qkvproj_attention)
    plain = _torch_all(*inputs, 2, True, None, torch.float32)
    for a, c in zip(through_wrapper, plain):
        np.testing.assert_array_equal(a, c)
    assert not any(ops.launch_counts().values())
    assert {"fused_qkvproj_attention", "fused_qkvproj_attention_backward"} <= set(
        ops.launch_counts())
