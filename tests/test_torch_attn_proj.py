"""The port's plain attention+projection against the JAX Pallas kernel
(interpret mode), forward and all three gradients.

Inputs are made with numpy from a seed and given to both frameworks.  The
JAX kernel takes ``w`` as (in, out); the port as torch's (out, in).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.ops.attn_proj import fused_attention_proj as jax_attention_proj
from ssl4polyp_tpu_torch import ops
from ssl4polyp_tpu_torch.ops.attn_proj import (
    attn_proj_fold_enabled,
    fused_attention_proj,
    fused_attention_proj_backward_reference,
    fused_attention_proj_plain,
    fused_attention_proj_reference,
)

# fp32 on both sides, same algorithm: only summation order differs.  The
# gradients sum over every row of the batch, so their tolerance is relative
# to the largest entry.
F32_TOL = 2e-5
BWD_F32_TOL = 1e-4
# bf16 on both sides: both round the scale fold, the scores (softmax_f32
# False), the weights, the core output, the product with w and the sum with
# b at the same points; a rounding that flips on an fp32 order difference
# moves an output by one bf16 ulp (2^-7 relative at |y| < 2), and a flipped
# core output by an ulp times a row of w.  The backward adds the roundings of
# dO, dS and dqkv.
BF16_TOL = 2e-2
BWD_BF16_TOL = 3e-2


def _inputs(seed, B, N, H, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    D = H * hd
    qkv = rng.standard_normal((B, N, 3 * D)).astype(dtype)
    w = (rng.standard_normal((D, D)) * D ** -0.5).astype(dtype)  # (out, in)
    b = (0.5 * rng.standard_normal(D)).astype(dtype)
    dy = rng.standard_normal((B, N, D)).astype(dtype)
    return qkv, w, b, dy


def _jax_all(qkv, w, b, dy, H, softmax_f32, valid_len, dtype):
    args = (jnp.asarray(qkv, dtype), jnp.asarray(w.T, dtype), jnp.asarray(b, dtype))
    out, vjp = jax.vjp(
        lambda q, k, c: jax_attention_proj(q, k, c, H, True, softmax_f32, valid_len), *args)
    dqkv, dw, db = vjp(jnp.asarray(dy, dtype))
    as_np = lambda a: np.asarray(a.astype(jnp.float32))  # noqa: E731
    return as_np(out), as_np(dqkv), as_np(dw).T, as_np(db)


def _torch_all(qkv, w, b, dy, H, softmax_f32, valid_len, dtype):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_() for a in (qkv, w, b)]
    out = fused_attention_proj_plain(*leaves, H, softmax_f32, valid_len)
    out.backward(torch.from_numpy(dy).to(dtype))
    return tuple(t.detach().float().numpy() for t in (out, *[a.grad for a in leaves]))


def _assert_all_close(ours, ref, tol, bwd_tol, rows=slice(None)):
    np.testing.assert_allclose(ours[0][:, rows], ref[0][:, rows], rtol=tol, atol=tol,
                               err_msg="out")
    for name, a, b in zip(("dqkv", "dw", "db"), ours[1:], ref[1:]):
        scale = max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=bwd_tol, atol=bwd_tol * scale, err_msg=name)


@pytest.mark.parametrize("softmax_f32", [True, False])
@pytest.mark.parametrize(
    "B, N, H, hd, valid_len",
    [(2, 37, 4, 16, None), (2, 29, 2, 32, 25), (1, 24, 2, 64, 19), (4, 24, 4, 8, None),
     # what only the fp32 kernels take: an odd head count (D 160, not a
     # multiple of 128), and 300 tokens, past the bf16 kernels' 256
     (3, 61, 5, 32, None), (1, 300, 2, 32, 280)],
)
def test_plain_matches_jax_kernel_fp32(B, N, H, hd, valid_len, softmax_f32):
    qkv, w, b, dy = _inputs(0, B, N, H, hd)
    if valid_len is not None:
        dy[:, valid_len:] = 0  # the pad rows' upstream gradient is zero
    ours = _torch_all(qkv, w, b, dy, H, softmax_f32, valid_len, torch.float32)
    ref = _jax_all(qkv, w, b, dy, H, softmax_f32, valid_len, jnp.float32)
    rows = slice(None) if valid_len is None else slice(0, valid_len)
    _assert_all_close(ours, ref, F32_TOL, BWD_F32_TOL, rows)


@pytest.mark.parametrize("softmax_f32", [True, False])
@pytest.mark.parametrize("hd, valid_len", [(32, 25), (64, None)])
def test_plain_matches_jax_kernel_bf16(hd, valid_len, softmax_f32):
    # hd 32: the folded scale 1/sqrt(32) is not a power of two, so folding it
    # into q in bf16 rounds, and both sides must round alike.
    qkv, w, b, dy = _inputs(1, 2, 29, 2, hd)
    if valid_len is not None:
        dy[:, valid_len:] = 0
    ours = _torch_all(qkv, w, b, dy, 2, softmax_f32, valid_len, torch.bfloat16)
    ref = _jax_all(qkv, w, b, dy, 2, softmax_f32, valid_len, jnp.bfloat16)
    rows = slice(None) if valid_len is None else slice(0, valid_len)
    _assert_all_close(ours, ref, BF16_TOL, BWD_BF16_TOL, rows)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("softmax_f32", [True, False])
def test_plain_matches_jax_kernel_at_a_ragged_token_count(softmax_f32, dtype):
    # 37 tokens are two whole query tiles of 16 and one of 5 rows, and the
    # last two keys are masked: the edges at which the card's kernel splits an
    # image's rows into unequal blocks, here for the plain version that judges
    # it.  hd 32: the scale fold rounds in bf16.
    qkv, w, b, dy = _inputs(5, 2, 37, 4, 32)
    dy[:, 35:] = 0
    if dtype == "fp32":
        torch_dtype, jax_dtype, tol, bwd_tol = torch.float32, jnp.float32, F32_TOL, BWD_F32_TOL
    else:
        torch_dtype, jax_dtype, tol, bwd_tol = torch.bfloat16, jnp.bfloat16, BF16_TOL, BWD_BF16_TOL
    ours = _torch_all(qkv, w, b, dy, 4, softmax_f32, 35, torch_dtype)
    ref = _jax_all(qkv, w, b, dy, 4, softmax_f32, 35, jax_dtype)
    _assert_all_close(ours, ref, tol, bwd_tol, slice(0, 35))


def test_valid_len_over_padding_equals_truncated():
    # Padded keys are masked: the valid rows match the truncated call after
    # the projection too, and dw and db see exact zeros from the pad rows
    # (their upstream gradient is zero), as the JAX test checks of its kernel.
    qkv, w, b, dy = _inputs(2, 3, 24, 4, 8)
    vl = 17
    dy[:, vl:] = 0
    padded = _torch_all(qkv, w, b, dy, 4, True, vl, torch.float32)
    truncated = _torch_all(qkv[:, :vl].copy(), w, b, dy[:, :vl].copy(), 4, True, None,
                           torch.float32)
    np.testing.assert_allclose(padded[0][:, :vl], truncated[0], rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(padded[1][:, :vl], truncated[1], rtol=1e-5, atol=1e-5)
    assert not padded[1][:, vl:, :32].any()  # no gradient reaches a pad row's q
    for a, c in zip(padded[2:], truncated[2:]):
        np.testing.assert_allclose(a, c, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("softmax_f32", [True, False])
def test_backward_reference_is_autograd_of_the_forward_in_fp32(softmax_f32):
    # In fp32 every rounding is the identity, so the JAX kernel's backward
    # steps are the exact gradient of the plain forward.
    qkv, w, b, dy = (torch.from_numpy(a) for a in _inputs(3, 2, 23, 2, 32))
    leaves = [a.clone().requires_grad_() for a in (qkv, w, b)]
    fused_attention_proj_reference(*leaves, 2, softmax_f32, 20).backward(dy)
    grads = fused_attention_proj_backward_reference(qkv, w, b, dy, 2, softmax_f32, 20)
    for got, leaf in zip(grads, leaves):
        scale = max(1.0, leaf.grad.abs().max().item())
        torch.testing.assert_close(got, leaf.grad, rtol=1e-5, atol=1e-5 * scale)


def test_cpu_wrapper_is_the_plain_version_and_launches_nothing():
    ops.reset_launch_counts()
    qkv, w, b, dy = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(4, 2, 17, 2, 16))
    leaves = [a.clone().requires_grad_() for a in (qkv, w, b)]
    out = fused_attention_proj(*leaves, 2, False, 15)
    out.backward(dy)
    torch.testing.assert_close(out, fused_attention_proj_reference(qkv, w, b, 2, False, 15),
                               rtol=0, atol=0)
    ref = fused_attention_proj_backward_reference(qkv, w, b, dy, 2, False, 15)
    for got, want, leaf in zip([a.grad for a in leaves], ref, leaves):
        assert got.dtype == leaf.dtype
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert set(ops.launch_counts().values()) == {0}


def test_the_knob_is_the_jax_package_s(monkeypatch):
    from ssl4polyp_tpu.ops.attn_proj import attn_proj_fold_enabled as jax_enabled

    for value in ("1", "0", "true", None):
        if value is None:
            monkeypatch.delenv("BENCH_ATTN_PROJ", raising=False)
        else:
            monkeypatch.setenv("BENCH_ATTN_PROJ", value)
        assert attn_proj_fold_enabled() == jax_enabled() == (value == "1")
