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
from ssl4polyp_tpu_torch.ops import attention
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


# The CUDA forward's tiling edges (64-row query tiles; key widths of 64, 128,
# 208 and 256), at each head dim it takes, with B and H at 1 or 2.
_EDGES = [(1 + n % 2, 2 - n % 2, n, hd) for n in (1, 63, 64, 65, 129, 193, 256)
          for hd in (16, 32, 64)]
# Past 256 tokens, where the card takes the key tiles in bf16 (64-key tiles:
# one key past four of them, a ragged last tile, a ViT-B/16 at 384 px) and
# the fp32 kernels, at each head dim.
_LONG = [(1, 2, 257, 64), (2, 1, 300, 32), (1, 1, 577, 16), (1, 2, 577, 64)]


@pytest.mark.parametrize("shape", [(2, 3, 197, 64), (1, 1, 130, 8), (1, 2, 37, 16)] + _EDGES
                         + _LONG)
def test_plain_matches_jax_kernel_fp32(shape):
    inputs = _inputs(0, shape)
    ours = _torch_all(*inputs, torch.float32)
    ref = _jax_all(*inputs, jnp.float32)
    np.testing.assert_allclose(ours[0], ref[0], rtol=F32_TOL, atol=F32_TOL, err_msg="out")
    for name, a, b in zip(("dq", "dk", "dv"), ours[1:], ref[1:]):
        np.testing.assert_allclose(a, b, rtol=BWD_F32_TOL, atol=BWD_F32_TOL, err_msg=name)


@pytest.mark.parametrize("shape", [(2, 2, 29, 32)] + _EDGES + _LONG)
def test_plain_matches_jax_kernel_bf16(shape):
    # hd 32: 1/sqrt(32) is not a power of two; it multiplies the fp32 scores
    # on both sides and is never folded into q in bf16.
    inputs = _inputs(1, shape)
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


def _split(x):
    """An fp32 operand as the card's kernel feeds it to the tensor cores: its
    bf16 rounding and the bf16 rounding of what that dropped."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _chunked_split_product(a, b, chunk=64):
    """sum over 64-wide chunks c of a[..., c] @ b[..., c, :], a's chunk as
    hi + lo (two products), each product summed in fp32."""
    total = 0.0
    for c in range(0, a.shape[-1], chunk):
        hi, lo = _split(a[..., c:c + chunk])
        total = total + hi @ b[..., c:c + chunk, :] + lo @ b[..., c:c + chunk, :]
    return total


def _emulated_backward(q, k, v, dout):
    """The card kernel's arithmetic in plain torch (fp32 from bf16 inputs).
    Phase A, a query row at a time: the softmax from exp2 with the scale
    folded into its argument, each row's scaled max and 1/sum kept; tmp =
    rowsum(dW * W) summed over 64-key chunks; dQ from dS = W (dW - tmp)
    scale as hi + lo, a chunk of keys at a time.  Phase B, a key row at a
    time: W^T and dS^T rebuilt from the kept statistics and S^T = K Q^T,
    dW^T = V dO^T; dV and dK from their hi + lo, a chunk of queries at a
    time.  Each gradient is rounded once."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    scale = torch.tensor(1.0 / np.sqrt(q.shape[-1]), dtype=torch.float32)
    scale_log2 = scale * torch.tensor(np.log2(np.e), dtype=torch.float32)
    s = qf @ kf.transpose(-1, -2)
    m = s.amax(dim=-1, keepdim=True) * scale_log2
    e = torch.exp2(s * scale_log2 - m)
    inv = 1.0 / e.sum(dim=-1, keepdim=True)
    w = e * inv
    dw = dof @ vf.transpose(-1, -2)
    tmp = sum((dw[..., c:c + 64] * w[..., c:c + 64]).sum(dim=-1, keepdim=True)
              for c in range(0, w.shape[-1], 64))
    dq = _chunked_split_product(w * (dw - tmp) * scale, kf)
    st = kf @ qf.transpose(-1, -2)
    wt = torch.exp2(st * scale_log2 - m.transpose(-1, -2)) * inv.transpose(-1, -2)
    dst = wt * (vf @ dof.transpose(-1, -2) - tmp.transpose(-1, -2)) * scale
    dv = _chunked_split_product(wt, dof)
    dk = _chunked_split_product(dst, qf)
    return tuple(g.to(q.dtype) for g in (dq, dk, dv))


@pytest.mark.parametrize("shape", [(2, 3, 197, 64)] + _EDGES + _LONG)
def test_the_cards_two_phase_backward_matches_the_jax_kernel_bf16(shape):
    # The card kernel's order of work and its split operands, emulated,
    # against the JAX kernel's backward in interpret mode: the two phases,
    # the statistics kept between them, the chunked sums and the hi + lo
    # split stay within the bf16 tolerance of the plain backward.  Past 256
    # tokens the key tiles' two passes do the same arithmetic: each row's
    # statistics first, then dQ summed over 64-key tiles and dK, dV over
    # 64-query tiles, W and dS as hi + lo.
    q, k, v, dout = _inputs(4, shape)
    ref = _jax_all(q, k, v, dout, jnp.bfloat16)[1:]
    ours = _emulated_backward(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, dout)))
    for name, a, b in zip(("dq", "dk", "dv"), ours, ref):
        np.testing.assert_allclose(a.float().numpy(), b, rtol=BWD_BF16_TOL, atol=BWD_BF16_TOL,
                                   err_msg=name)


def test_backward_kernel_refuses_unknown_probe_bits_before_any_build(monkeypatch):
    from ssl4polyp_tpu_torch.ops import _build

    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(_build, "library", no_build)
    q, k, v, dout = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(5, (1, 2, 9, 16)))
    bits = (attention.BACKWARD_PROBE_NO_PHASE_B, attention.BACKWARD_PROBE_SOFTMAX_ONLY,
            attention.BACKWARD_PROBE_NO_PREFETCH, attention.BACKWARD_PROBE_FIRST_DESIGN,
            attention.BACKWARD_PROBE_ONE_TERM)
    assert sum(bits) == attention._BACKWARD_PROBE_BITS and len(set(bits)) == len(bits)
    for probe in (32, attention._BACKWARD_PROBE_BITS + 1, -1):
        with pytest.raises(ValueError, match="probe"):
            attention._backward_kernel(q, k, v, dout, probe=probe)
