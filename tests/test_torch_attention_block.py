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

from ssl4polyp_tpu.ops.attention_block import _project as jax_project
from ssl4polyp_tpu.ops.attention_block import fused_qkvproj_attention as jax_qkvproj_attention
from ssl4polyp_tpu_torch import ops
from ssl4polyp_tpu_torch.ops import attention_block
from ssl4polyp_tpu_torch.ops.attention_block import (
    fused_qkvproj_attention,
    fused_qkvproj_attention_backward_reference,
    fused_qkvproj_attention_plain,
    fused_qkvproj_attention_reference,
)
from ssl4polyp_tpu_torch.ops.qkv_attention import (
    fused_qkv_attention_backward_reference,
    fused_qkv_attention_plain,
)

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
     (1, 24, 32, 2, 64, 19),
     # what only the fp32 kernels take: 300 tokens, past the bf16 kernels' 256
     (1, 300, 64, 2, 32, 280)],
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_equals_the_jax_projection_bit_for_bit_on_small_integers(dtype):
    # The card test of the forward's projection alone holds the kernel to the
    # port's _project on small integers, where every product sum is exact in
    # fp32.  On such inputs the port's _project equals the JAX kernel's own
    # (both roundings included) bit for bit: the card test's reference is the
    # JAX package's projection.
    rng = np.random.default_rng(6)
    x = rng.integers(-2, 3, (2, 29, 768)).astype(np.float32)
    w = rng.integers(-2, 3, (768, 192)).astype(np.float32)
    b = rng.integers(-8, 9, 192).astype(np.float32)
    ours = attention_block._project(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                      for a in (x, w, b)))
    ref = jax_project(jnp.asarray(x, dtype), jnp.asarray(w, dtype),
                      jnp.asarray(b, dtype).reshape(1, -1))
    assert ours.dtype == getattr(torch, dtype) and ref.dtype == jnp.dtype(dtype)
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)))


def test_forward_kernel_refuses_unknown_probe_bits_before_any_build(monkeypatch):
    from ssl4polyp_tpu_torch.ops import _build

    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(_build, "library", no_build)
    x, w, b, _ = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(7, 1, 8, 64, 2, 32))
    bits = (attention_block.PROBE_NO_SOFTMAX, attention_block.PROBE_NO_PROJECTION,
            attention_block.PROBE_NO_PREFETCH, attention_block.PROBE_FIRST_DESIGN,
            attention_block.PROBE_PROJECTION_ONLY)
    assert sum(bits) == attention_block._PROBE_BITS and len(set(bits)) == len(bits)
    for probe in (32, attention_block._PROBE_BITS + 1, -1):
        with pytest.raises(ValueError, match="probe"):
            attention_block._forward_kernel(x, w, b, 2, True, None, probe=probe)


def _backward_chain(x, w, b, dout, H, softmax_f32, valid_len):
    """The card's backward sequence in plain torch: the projection without
    its bias, rounded; the attention backward in the QKV projection's mode
    with b as its bias (which rounds qkv + b and sums db); dx; dw."""
    B, N, d_in = x.shape
    qkv = torch.matmul(x.float(), w.float()).to(x.dtype)
    dqkv, db = fused_qkv_attention_backward_reference(qkv, dout, H, softmax_f32, valid_len, b,
                                                      scaled_ds=True)
    dqkv2 = dqkv.reshape(B * N, -1).float()
    dx = torch.matmul(dqkv2, w.float().t()).to(x.dtype).reshape(x.shape)
    dw = torch.matmul(x.reshape(B * N, d_in).float().t(), dqkv2)
    return dx, dw.to(w.dtype), db


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("softmax_f32", [True, False])
@pytest.mark.parametrize("B, N, Din, H, hd, valid_len",
                         [(2, 29, 64, 2, 32, None), (2, 29, 64, 2, 32, 25), (1, 24, 128, 2, 64, 19),
                          (2, 50, 64, 3, 32, 40), (1, 17, 64, 1, 64, None)])
def test_backward_chain_equals_the_backward_reference_bit_for_bit(B, N, Din, H, hd, valid_len,
                                                                  softmax_f32, dtype):
    # The reference is held against the JAX kernel above; the chain of steps
    # the card runs makes the same roundings in the same order.
    x, w, b, dout = (torch.from_numpy(a).to(getattr(torch, dtype))
                     for a in _inputs(8, B, N, Din, H, hd))
    if valid_len is not None:
        dout[:, valid_len:] = 0
    chain = _backward_chain(x, w, b, dout, H, softmax_f32, valid_len)
    ref = fused_qkvproj_attention_backward_reference(x, w, b, dout, H, softmax_f32, valid_len)
    for name, got, want in zip(("dx", "dw", "db"), chain, ref):
        assert got.dtype == want.dtype, name
        assert torch.equal(got, want), name


@pytest.mark.parametrize("dtype, tol", [("float32", BWD_F32_TOL), ("bfloat16", BWD_BF16_TOL)])
@pytest.mark.parametrize("softmax_f32", [True, False])
@pytest.mark.parametrize("H, hd, valid_len", [(2, 32, 25), (1, 64, None)])
def test_attention_backward_reference_in_the_projection_mode_matches_the_jax_vjp(
        H, hd, valid_len, softmax_f32, dtype, tol):
    # With W = I (Din = 3D) the JAX kernel's qkv is x + b and its dx is dqkv
    # itself (a product with one nonzero term, then rounded: exact), so its
    # VJP shows the dqkv and db that the attention backward's second mode
    # must give on qkv = x with b as its bias.  In bf16 both round at the
    # same points: a rounding may flip on an fp32 summation order, rarely;
    # the first mode's scale outside dS's rounding flips about a third of
    # dqkv at hd 32 (1/sqrt(32) is no power of two).
    B, N, three_d = 2, 29, 3 * H * hd
    x, _, b, dout = _inputs(9, B, N, three_d, H, hd)
    w = np.eye(three_d, dtype=np.float32)
    if valid_len is not None:
        dout[:, valid_len:] = 0
    ref = _jax_all(x, w, b, dout, H, softmax_f32, valid_len, getattr(jnp, dtype))
    dqkv, db = fused_qkv_attention_backward_reference(
        *(torch.from_numpy(a).to(getattr(torch, dtype)) for a in (x, dout)), H, softmax_f32,
        valid_len, torch.from_numpy(b).to(getattr(torch, dtype)), scaled_ds=True)
    for name, got, want in (("dqkv", dqkv, ref[1]), ("db", db, ref[3])):
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol * scale,
                                   err_msg=name)
    if dtype == "bfloat16":
        assert (dqkv.float().numpy() != ref[1]).mean() <= 0.01


def test_backward_kernel_refuses_unknown_probe_bits_before_any_build(monkeypatch):
    from ssl4polyp_tpu_torch.ops import _build

    def no_build():
        raise AssertionError("the library was asked for")

    monkeypatch.setattr(_build, "library", no_build)
    x, w, b, dout = (torch.from_numpy(a).to(torch.bfloat16) for a in _inputs(10, 1, 8, 64, 2, 32))
    bits = (attention_block.BACKWARD_PROBE_FIRST_DESIGN, *attention_block.BACKWARD_STEPS.values())
    assert sum(bits) == attention_block._BACKWARD_PROBE_BITS and len(set(bits)) == len(bits)
    for probe in (256, attention_block._BACKWARD_PROBE_BITS + 1, -1):
        with pytest.raises(ValueError, match="probe"):
            attention_block._backward_kernel(x, w, b, dout, 2, True, None, probe=probe)
