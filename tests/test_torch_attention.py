"""The port's plain attention over separate q, k, v against the JAX Pallas
kernel (interpret mode), forward and all three gradients.

Inputs are made with numpy from a seed and given to both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.ops.attention import fused_attention as jax_fused_attention
from ssl4polyp_tpu_torch import ops
from ssl4polyp_tpu_torch.ops.attention import (
    fused_attention,
    fused_attention_backward_reference,
    fused_attention_plain,
    fused_attention_reference,
)

# fp32 on both sides, same algorithm: only summation order differs (the JAX
# kernel also sums over its zero padding to 128).
F32_TOL = 2e-5
BWD_F32_TOL = 1e-4
# bf16 on both sides: the forward rounds the weights and the output at the
# same points, the backward keeps everything in fp32 until each gradient is
# rounded once; a rounding that flips on an fp32 order difference is one
# bf16 ulp (2^-7 relative at |x| < 2; the gradients reach 4).
BF16_TOL = 2e-2
BWD_BF16_TOL = 3e-2


def _inputs(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(dtype) for _ in range(4))


def _jax_all(q, k, v, dout, dtype):
    args = tuple(jnp.asarray(a, dtype) for a in (q, k, v))
    out, vjp = jax.vjp(lambda a, b, c: jax_fused_attention(a, b, c, True), *args)
    grads = vjp(jnp.asarray(dout, dtype))
    return tuple(np.asarray(a.astype(jnp.float32)) for a in (out, *grads))


def _torch_all(q, k, v, dout, dtype, fn=fused_attention_plain):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (q, k, v)]
    out = fn(*leaves)
    out.backward(torch.from_numpy(dout).to(dtype))
    return tuple(t.detach().float().numpy() for t in (out, *[a.grad for a in leaves]))


@pytest.mark.parametrize("shape", [(2, 3, 197, 64), (1, 1, 130, 8), (1, 2, 37, 16)])
def test_plain_matches_jax_kernel_fp32(shape):
    inputs = _inputs(0, shape)
    ours = _torch_all(*inputs, torch.float32)
    ref = _jax_all(*inputs, jnp.float32)
    np.testing.assert_allclose(ours[0], ref[0], rtol=F32_TOL, atol=F32_TOL, err_msg="out")
    for name, a, b in zip(("dq", "dk", "dv"), ours[1:], ref[1:]):
        np.testing.assert_allclose(a, b, rtol=BWD_F32_TOL, atol=BWD_F32_TOL, err_msg=name)


def test_plain_matches_jax_kernel_bf16():
    # hd 32: 1/sqrt(32) is not a power of two; it multiplies the fp32 scores
    # on both sides and is never folded into q in bf16.
    inputs = _inputs(1, (2, 2, 29, 32))
    ours = _torch_all(*inputs, torch.bfloat16)
    ref = _jax_all(*inputs, jnp.bfloat16)
    np.testing.assert_allclose(ours[0], ref[0], rtol=BF16_TOL, atol=BF16_TOL, err_msg="out")
    for name, a, b in zip(("dq", "dk", "dv"), ours[1:], ref[1:]):
        np.testing.assert_allclose(a, b, rtol=BWD_BF16_TOL, atol=BWD_BF16_TOL, err_msg=name)


def test_backward_reference_is_autograd_of_the_forward_in_fp32():
    # In fp32 every rounding is the identity, so the JAX kernel's backward
    # steps are the exact gradient of the plain forward.
    q, k, v, dout = (torch.from_numpy(a) for a in _inputs(2, (2, 2, 23, 16)))
    leaves = [a.clone().requires_grad_() for a in (q, k, v)]
    fused_attention_reference(*leaves).backward(dout)
    for got, leaf in zip(fused_attention_backward_reference(q, k, v, dout), leaves):
        torch.testing.assert_close(got, leaf.grad, rtol=1e-5, atol=1e-5)


def test_the_scale_multiplies_the_scores_and_is_not_folded_into_q():
    # What tells this kernel from the QKV kernels in bf16: with q = 1 and
    # hd 32 the fold would round 1/sqrt(32) to bf16 and move every score by
    # 2^-9 relative.
    q = torch.ones(1, 1, 4, 32, dtype=torch.bfloat16)
    k = torch.arange(4 * 32, dtype=torch.float32).reshape(1, 1, 4, 32).bfloat16() / 64
    v = torch.eye(4, 32, dtype=torch.bfloat16).reshape(1, 1, 4, 32)
    scores = (q.float() @ k.float().transpose(-1, -2)) / np.sqrt(32.0)
    want = torch.softmax(scores, dim=-1).bfloat16()[..., :4]
    torch.testing.assert_close(fused_attention_reference(q, k, v)[..., :4], want, rtol=0, atol=0)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    inputs = _inputs(3, (1, 2, 9, 16))
    ops.reset_launch_counts()
    through_wrapper = _torch_all(*inputs, torch.float32, fn=fused_attention)
    plain = _torch_all(*inputs, torch.float32)
    for a, b in zip(through_wrapper, plain):
        np.testing.assert_array_equal(a, b)
    assert not any(ops.launch_counts().values())
    assert {"fused_attention", "fused_attention_backward"} <= set(ops.launch_counts())
