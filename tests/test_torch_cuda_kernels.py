"""The CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  Run them on
the card with ``python -m pytest tests/test_torch_cuda_kernels.py -q``.
"""

import pytest
import torch

from ssl4polyp_tpu_torch import ops
from ssl4polyp_tpu_torch.ops import attn_proj, mlp
from ssl4polyp_tpu_torch.ops.layernorm import layernorm, layernorm_reference
from ssl4polyp_tpu_torch.ops.ln_linear import ln_linear, ln_linear_plain, ln_linear_reference
from ssl4polyp_tpu_torch.ops.mlp import fc1_gelu, fc1_gelu_plain, fc1_gelu_reference
from ssl4polyp_tpu_torch.ops.qkv_attention import (
    fused_qkv_attention,
    fused_qkv_attention_backward_reference,
    fused_qkv_attention_reference,
)

pytestmark = pytest.mark.cuda

# bf16 outputs; the plain versions round at the same points except the plain
# fc1, which rounds h twice: 1-2 bf16 ulps.  The reasons for each tolerance
# are stated beside chip_smoke.py's.
ATTENTION_TOL = dict(atol=1e-2, rtol=1e-2)
ATTENTION_BWD_TOL = dict(atol=2e-2, rtol=2e-2)
FC1_TOL = dict(atol=1e-2, rtol=1.6e-2)
LN_TOL = dict(atol=1e-2, rtol=1e-2)
LN_PARAM_TOL = dict(atol=5e-3, rtol=1e-4)
# The fused kernels' plain versions make the same roundings (m, h, g, the
# output), so only fp32 summation order differs: one bf16 ulp (2^-8 to 2^-7
# relative) where a rounding flips.
FUSED_TOL = dict(atol=1e-2, rtol=1e-2)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


@pytest.mark.parametrize(
    "B, N, H, hd, softmax_f32, valid_len, with_bias",
    [
        (3, 197, 12, 64, True, None, True),
        (2, 37, 4, 16, True, 30, True),
        (2, 50, 12, 64, True, None, True),     # the MAE encoder's 50 tokens
        (2, 197, 16, 32, False, None, False),  # the MAE decoder's heads
        (1, 129, 2, 32, False, 100, True),
        (1, 256, 2, 64, True, 255, False),
        (1, 1, 1, 16, True, None, False),
    ],
)
@torch.inference_mode()
def test_attention_kernel_matches_plain(gen, B, N, H, hd, softmax_f32, valid_len, with_bias):
    qkv = _randn(gen, B, N, 3 * H * hd)
    bias = _randn(gen, 3 * H * hd, scale=0.5) if with_bias else None
    ops.reset_launch_counts()
    out = fused_qkv_attention(qkv, H, softmax_f32, valid_len, bias)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_qkv_attention"] == 1
    ref = fused_qkv_attention_reference(qkv, H, softmax_f32, valid_len, bias)
    torch.testing.assert_close(out, ref, **ATTENTION_TOL)


@torch.inference_mode()
def test_attention_kernel_padded_equals_unpadded(gen):
    qkv = _randn(gen, 4, 197, 3 * 768)
    bias = _randn(gen, 3 * 768, scale=0.5)
    padded = torch.cat([qkv, _randn(gen, 4, 3, 3 * 768)], dim=1)
    out = fused_qkv_attention(padded, 12, True, 197, bias)[:, :197]
    torch.testing.assert_close(out, fused_qkv_attention(qkv, 12, True, None, bias),
                               atol=0, rtol=0)


@pytest.mark.parametrize("M, K, NF", [(12608, 768, 3072), (100, 64, 256), (37, 32, 24), (1, 8, 8)])
@torch.inference_mode()
def test_fc1_gelu_kernel_matches_plain(gen, M, K, NF):
    x, w, b = _randn(gen, M, K), _randn(gen, NF, K, scale=K ** -0.5), _randn(gen, NF, scale=0.5)
    ops.reset_launch_counts()
    y = fc1_gelu(x, w, b)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fc1_gelu"] == 1
    torch.testing.assert_close(y, fc1_gelu_reference(x, w, b), **FC1_TOL)


def test_wrappers_refuse_what_the_kernels_do_not_take(gen):
    qkv = _randn(gen, 1, 8, 96)
    x, w, b = _randn(gen, 4, 16), _randn(gen, 8, 16), _randn(gen, 8)
    with torch.inference_mode():
        with pytest.raises(TypeError):
            fused_qkv_attention(qkv.float(), 2)
        with pytest.raises(ValueError):
            fused_qkv_attention(_randn(gen, 1, 8, 3 * 128), 1)  # head dim 128
        with pytest.raises(ValueError):
            fused_qkv_attention(_randn(gen, 1, 300, 96), 2)  # > 256 tokens
        with pytest.raises(ValueError):
            fc1_gelu(x[:, ::2], w[:, ::2].contiguous(), b)  # x not contiguous
        with pytest.raises(TypeError):
            fc1_gelu(x.float(), w.float(), b.float())
        with pytest.raises(TypeError):
            layernorm(x.float(), torch.ones(16, device="cuda"), torch.zeros(16, device="cuda"))
        with pytest.raises(ValueError):  # bf16 affine parameters
            layernorm(x, torch.ones(16, device="cuda").bfloat16(), torch.zeros(16, device="cuda"))


@pytest.mark.parametrize(
    "B, N, H, hd, softmax_f32, valid_len, with_bias",
    [
        (4, 50, 12, 64, False, None, True),    # the MAE encoder's call
        (4, 197, 16, 32, False, None, True),   # the MAE decoder's call
        (2, 197, 12, 64, False, 150, True),
        (2, 37, 4, 16, True, 30, False),
        (1, 256, 2, 64, True, 255, True),
        (1, 1, 1, 16, True, None, True),
        (64, 197, 12, 64, True, None, True),   # the fine-tune step's call
    ],
)
def test_attention_backward_kernel_matches_plain(gen, B, N, H, hd, softmax_f32, valid_len,
                                                 with_bias):
    qkv = _randn(gen, B, N, 3 * H * hd).requires_grad_()
    bias = _randn(gen, 3 * H * hd, scale=0.5).requires_grad_() if with_bias else None
    dout = _randn(gen, B, N, H * hd)
    ops.reset_launch_counts()
    fused_qkv_attention(qkv, H, softmax_f32, valid_len, bias).backward(dout)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_qkv_attention_backward"] == 1
    ref_dqkv, ref_dbias = fused_qkv_attention_backward_reference(
        qkv.detach(), dout, H, softmax_f32, valid_len, None if bias is None else bias.detach())
    torch.testing.assert_close(qkv.grad, ref_dqkv, **ATTENTION_BWD_TOL)
    if with_bias:
        scale = ref_dbias.float().abs().max().item()
        torch.testing.assert_close(bias.grad.float(), ref_dbias.float(), atol=2e-3 * scale,
                                   rtol=2e-2)


@pytest.mark.parametrize("shape", [(4, 50, 768), (2, 197, 512), (37, 64), (5, 2048)])
def test_layernorm_kernels_match_plain(gen, shape):
    D = shape[-1]
    x, dy = _randn(gen, *shape), _randn(gen, *shape)
    w = (1 + 0.1 * torch.randn(D, generator=gen, device="cuda")).requires_grad_()
    b = (0.1 * torch.randn(D, generator=gen, device="cuda")).requires_grad_()
    xk = x.clone().requires_grad_()
    ops.reset_launch_counts()
    y = layernorm(xk, w, b)
    y.backward(dy)
    torch.cuda.synchronize()
    assert ops.launch_counts()["layernorm"] == 1
    assert ops.launch_counts()["layernorm_backward"] == 1
    grads = xk.grad, w.grad.clone(), b.grad.clone()
    w.grad = b.grad = None
    xr = x.clone().requires_grad_()
    yr = layernorm_reference(xr, w, b)
    yr.backward(dy)
    torch.testing.assert_close(y, yr, **LN_TOL)
    torch.testing.assert_close(grads[0], xr.grad, **LN_TOL)
    torch.testing.assert_close(grads[1], w.grad, **LN_PARAM_TOL)
    torch.testing.assert_close(grads[2], b.grad, **LN_PARAM_TOL)


@pytest.mark.parametrize("M, K, NF", [(3200, 768, 3072), (12608, 512, 2048), (37, 32, 24)])
def test_fc1_gelu_gradients_match_plain(gen, M, K, NF):
    x, w, b = _randn(gen, M, K), _randn(gen, NF, K, scale=K ** -0.5), _randn(gen, NF, scale=0.5)
    dy = _randn(gen, M, NF)
    grads = []
    for fn in (fc1_gelu, fc1_gelu_plain):
        leaves = [t.clone().requires_grad_() for t in (x, w, b)]
        ops.reset_launch_counts()
        fn(*leaves).backward(dy)
        torch.cuda.synchronize()
        assert ops.launch_counts()["fc1_gelu"] == (1 if fn is fc1_gelu else 0)
        grads.append([t.grad.float() for t in leaves])
    # dh comes from the kernel's h (one rounding) against the plain h (two):
    # a bf16 ulp of dh, summed over M rows for dw and db.
    for name, got, want in zip(("dx", "dw", "db"), *grads):
        scale = max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, atol=2e-2 * scale, rtol=2e-2, msg=name)


@pytest.mark.parametrize("M, K, N", [(12608, 768, 2304), (12608, 512, 1536), (37, 64, 24),
                                     (1, 128, 8)])
def test_ln_linear_kernel_matches_plain(gen, M, K, N):
    x, dy = _randn(gen, M, K), _randn(gen, M, N)
    s = 1 + 0.1 * torch.randn(K, generator=gen, device="cuda")
    t = 0.1 * torch.randn(K, generator=gen, device="cuda")
    w, b = _randn(gen, N, K, scale=K ** -0.5), _randn(gen, N, scale=0.5)
    grads = []
    for fn in (ln_linear, ln_linear_plain):
        leaves = [a.clone().requires_grad_() for a in (x, s, t, w, b)]
        ops.reset_launch_counts()
        out = fn(*leaves)
        out.backward(dy)
        torch.cuda.synchronize()
        kernel = fn is ln_linear
        assert ops.launch_counts()["ln_linear"] == int(kernel)
        assert ops.launch_counts()["layernorm"] == ops.launch_counts()["layernorm_backward"] == int(kernel)
        grads.append([a.grad.float() for a in leaves])
        if fn is ln_linear:
            torch.testing.assert_close(out, ln_linear_reference(x, s, t, w, b), **FUSED_TOL)
    # The kernel path's backward runs its LayerNorm steps on the LayerNorm
    # kernels: m and dx may differ by a bf16 ulp where a rounding flips, and
    # the fp32 parameter sums by their summation order.
    for name, got, want in zip(("dx", "ds", "dt", "dw", "db"), *grads):
        scale = max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, atol=2e-2 * scale, rtol=2e-2, msg=name)


@pytest.mark.parametrize("with_ln", [False, True], ids=["mlp_fused", "mlp_ln_fused"])
@pytest.mark.parametrize("M, K, NF", [(12608, 768, 3072), (12608, 512, 2048), (37, 512, 64),
                                      (1, 768, 32)])
def test_fused_mlp_kernels_match_plain(gen, with_ln, M, K, NF):
    x, dy = _randn(gen, M, K), _randn(gen, M, K)
    s = 1 + 0.1 * torch.randn(K, generator=gen, device="cuda") if with_ln else None
    t = 0.1 * torch.randn(K, generator=gen, device="cuda") if with_ln else None
    w1, b1 = _randn(gen, NF, K, scale=K ** -0.5), _randn(gen, NF, scale=0.5)
    w2, b2 = _randn(gen, K, NF, scale=NF ** -0.5), _randn(gen, K, scale=0.5)
    h, out = mlp._fused_kernel(x, s, t, w1, b1, w2, b2, 1e-6, write_h=True)
    h_again, out_again = mlp._fused_kernel(x, s, t, w1, b1, w2, b2, 1e-6, write_h=True)
    torch.cuda.synchronize()
    assert torch.equal(h, h_again) and torch.equal(out, out_again)  # no atomics
    ref_h, ref_out = mlp._mlp_forward_plain(x, s, t, w1, b1, w2, b2, 1e-6)
    torch.testing.assert_close(h, ref_h, **FUSED_TOL)
    torch.testing.assert_close(out, ref_out, **FUSED_TOL)
    # Through the autograd wrappers: one launch, and gradients from the
    # kernel's h against the plain h (a bf16 ulp where a rounding of h flips).
    args = (x, w1, b1, w2, b2) if not with_ln else (x, s, t, w1, b1, w2, b2)
    kernel, plain = ((mlp.mlp_fused, mlp.mlp_fused_plain) if not with_ln
                     else (mlp.mlp_ln_fused, mlp.mlp_ln_fused_plain))
    name = "mlp_ln_fused" if with_ln else "mlp_fused"
    grads = []
    for fn in (kernel, plain):
        leaves = [a.clone().requires_grad_() for a in args]
        ops.reset_launch_counts()
        fn(*leaves).backward(dy)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        assert counts[name] == int(fn is kernel) and counts["fc1_gelu"] == 0
        # The LN variant's backward recomputes m and takes its LayerNorm
        # backward on the LayerNorm kernels.
        assert counts["layernorm"] == counts["layernorm_backward"] == int(fn is kernel and with_ln)
        grads.append([a.grad.float() for a in leaves])
    for got, want in zip(*grads):
        scale = max(1.0, want.abs().max().item())
        torch.testing.assert_close(got, want, atol=2e-2 * scale, rtol=2e-2)


def test_fused_wrappers_refuse_what_the_kernels_do_not_take(gen):
    x, w1, b1 = _randn(gen, 4, 512), _randn(gen, 64, 512), _randn(gen, 64)
    w2, b2 = _randn(gen, 512, 64), _randn(gen, 512)
    s, t = torch.ones(512, device="cuda"), torch.zeros(512, device="cuda")
    with torch.inference_mode():
        with pytest.raises(ValueError):  # K 128 has no instantiation
            mlp.mlp_fused(_randn(gen, 4, 128), _randn(gen, 64, 128), b1, _randn(gen, 128, 64),
                          _randn(gen, 128))
        with pytest.raises(TypeError):  # bf16 LayerNorm affine
            mlp.mlp_ln_fused(x, s.bfloat16(), t, w1, b1, w2, b2)
        with pytest.raises(TypeError):
            ln_linear(x.float(), s, t, w1.float(), b1.float())
        with pytest.raises(ValueError):  # K 1024: the rows do not fit in shared memory
            ln_linear(_randn(gen, 4, 1024), torch.ones(1024, device="cuda"),
                      torch.zeros(1024, device="cuda"), _randn(gen, 8, 1024), _randn(gen, 8))
        with pytest.raises(ValueError):  # K not a multiple of 64
            ln_linear(_randn(gen, 4, 96), torch.ones(96, device="cuda"),
                      torch.zeros(96, device="cuda"), _randn(gen, 8, 96), _randn(gen, 8))


# dw and db are fp32 sums over every row of the batch, taken in another order
# than the plain version's (and dw over each side's own bf16-rounded O): the
# tolerance is relative to the largest entry, as for the other parameter sums.
ATTN_PROJ_PARAM_TOL = dict(atol_scale=5e-3, rtol=2e-2)


@pytest.mark.parametrize(
    "B, N, H, hd, softmax_f32, valid_len",
    [
        (64, 197, 12, 64, True, None),    # the classifier's call
        (8, 197, 16, 32, False, None),    # the MAE decoder's call
        (3, 197, 12, 64, True, 150),
        (2, 50, 4, 32, False, 40),        # one row tile, width 128
        (1, 256, 2, 64, True, 255),
        (2, 129, 8, 32, True, None),
    ],
)
def test_attn_proj_kernels_match_plain(gen, B, N, H, hd, softmax_f32, valid_len):
    D = H * hd
    qkv, dy = _randn(gen, B, N, 3 * D), _randn(gen, B, N, D)
    if valid_len is not None:
        dy[:, valid_len:] = 0  # the pad rows' upstream gradient is zero
    w, b = _randn(gen, D, D, scale=D ** -0.5), _randn(gen, D, scale=0.5)
    results = []
    for fn in (attn_proj.fused_attention_proj, attn_proj.fused_attention_proj_plain):
        leaves = [a.clone().requires_grad_() for a in (qkv, w, b)]
        ops.reset_launch_counts()
        out = fn(*leaves, H, softmax_f32, valid_len)
        out.backward(dy)
        torch.cuda.synchronize()
        kernel = fn is attn_proj.fused_attention_proj
        counts = ops.launch_counts()
        assert counts["attn_proj"] == counts["attn_proj_backward"] == int(kernel)
        assert counts["fused_qkv_attention"] == counts["fused_qkv_attention_backward"] == 0
        results.append((out.detach(), *[a.grad for a in leaves]))
    (out, dqkv, dw, db), (ref_out, ref_dqkv, ref_dw, ref_db) = results
    rows = slice(None) if valid_len is None else slice(0, valid_len)
    torch.testing.assert_close(out[:, rows], ref_out[:, rows], **ATTENTION_TOL)
    torch.testing.assert_close(dqkv, ref_dqkv, **ATTENTION_BWD_TOL)
    for name, got, want in (("dw", dw, ref_dw), ("db", db, ref_db)):
        scale = want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=ATTN_PROJ_PARAM_TOL["atol_scale"] * scale,
                                   rtol=ATTN_PROJ_PARAM_TOL["rtol"], msg=name)
    # No atomics: a second backward gives the same bits.
    again = attn_proj._backward_kernel(qkv, w, b, dy, H, softmax_f32, valid_len)
    assert all(torch.equal(a, g) for a, g in zip(again, (dqkv, dw, db)))


def test_attn_proj_padded_equals_unpadded(gen):
    qkv = _randn(gen, 4, 197, 3 * 768)
    w, b = _randn(gen, 768, 768, scale=768 ** -0.5), _randn(gen, 768, scale=0.5)
    padded = torch.cat([qkv, _randn(gen, 4, 3, 3 * 768)], dim=1)
    with torch.inference_mode():
        out = attn_proj.fused_attention_proj(padded, w, b, 12, True, 197)[:, :197]
        torch.testing.assert_close(out, attn_proj.fused_attention_proj(qkv, w, b, 12, True),
                                   atol=0, rtol=0)


def test_attn_proj_wrapper_refuses_what_the_kernel_does_not_take(gen):
    w, b = _randn(gen, 128, 128), _randn(gen, 128)
    with torch.inference_mode():
        with pytest.raises(TypeError):
            attn_proj.fused_attention_proj(_randn(gen, 1, 8, 384).float(), w.float(), b.float(), 4)
        with pytest.raises(ValueError):  # head dim 16
            attn_proj.fused_attention_proj(_randn(gen, 1, 8, 384), w, b, 8)
        with pytest.raises(ValueError):  # width 64 is not a multiple of 128
            attn_proj.fused_attention_proj(_randn(gen, 1, 8, 192), _randn(gen, 64, 64),
                                           _randn(gen, 64), 2)
        with pytest.raises(ValueError):  # > 256 tokens
            attn_proj.fused_attention_proj(_randn(gen, 1, 300, 384), w, b, 4)


def _adamw_case(gen, shapes, grad_dtype=torch.float32):
    """Parameters, copies (bf16 for matrices, the master itself for
    vectors), moments and per-tensor scales with a frozen tensor."""
    params = [torch.randn(*s, generator=gen, device="cuda") for s in shapes]
    copies = [p.to(torch.bfloat16) if p.dim() >= 2 else p for p in params]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    lr_scales = [0.0 if i == 1 else (0.5 if i % 3 == 0 else 1.0) for i in range(len(shapes))]
    wd_scales = [1.0 if p.dim() >= 2 else 0.0 for p in params]
    grads = [[(0.1 * torch.randn(*s, generator=gen, device="cuda")).to(grad_dtype) for s in shapes]
             for _ in range(3)]
    return params, copies, mu, nu, lr_scales, wd_scales, grads


@pytest.mark.parametrize("grad_dtype", [torch.float32, torch.bfloat16])
def test_adamw_kernel_equals_plain_bit_for_bit(gen, grad_dtype):
    from ssl4polyp_tpu_torch.ops import adamw

    # 70 tensors (two launches): matrices, vectors, sizes that are not a
    # multiple of 4 or of a block's 8,192 elements, a scalar.
    shapes = [(768, 768), (3, 5), (2304,), (1, 197, 768), (8193,), (7,), (1,), (64, 129)]
    shapes += [(i + 1, 33) for i in range(62)]
    kernel = _adamw_case(gen, shapes, grad_dtype)
    plain = [[t.clone() for t in group] if isinstance(group[0], torch.Tensor) else group
             for group in kernel[:6]]
    plain[1] = [c if c.dtype == torch.bfloat16 else p for c, p in zip(plain[1], plain[0])]
    grads = kernel[6]
    frozen = kernel[0][1].clone(), kernel[1][1].clone()
    for step in range(3):
        bc = dict(bc1=1 - 0.9 ** (step + 1), bc2=1 - 0.95 ** (step + 1))
        bc = {k: float(torch.tensor(v, dtype=torch.float32)) for k, v in bc.items()}
        kwargs = dict(lr=1e-3, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.05, **bc)
        ops.reset_launch_counts()
        adamw.adamw_multi_tensor(kernel[0], kernel[1], grads[step], kernel[2], kernel[3],
                                 kernel[4], kernel[5], **kwargs)
        torch.cuda.synchronize()
        assert ops.launch_counts()["adamw"] == 2
        adamw.adamw_multi_tensor_plain(plain[0], plain[1], grads[step], plain[2], plain[3],
                                       plain[4], plain[5], **kwargs)
        for group, (got, want) in enumerate(zip(kernel[:4], plain[:4])):
            for i, (a, b) in enumerate(zip(got, want)):
                assert torch.equal(a, b), (step, group, i, (a.float() - b.float()).abs().max())
    assert torch.equal(kernel[0][1], frozen[0]) and torch.equal(kernel[1][1], frozen[1])
    assert kernel[2][1].abs().sum() > 0  # the frozen tensor's moments moved
    # A vector's copy is the master itself: it moved with it.
    assert kernel[1][2].data_ptr() == kernel[0][2].data_ptr()


def test_adamw_wrapper_refuses_what_the_kernel_does_not_take(gen):
    from ssl4polyp_tpu_torch.ops import adamw

    p = torch.randn(8, 8, generator=gen, device="cuda")
    zeros = lambda: torch.zeros_like(p)  # noqa: E731
    kwargs = dict(lr=1e-3, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, bc1=0.1, bc2=0.001)
    with pytest.raises(TypeError):  # fp16 copy
        adamw.adamw_multi_tensor([p], [p.half()], [zeros()], [zeros()], [zeros()], [1.0], [1.0],
                                 **kwargs)
    with pytest.raises(TypeError):  # fp64 gradient
        adamw.adamw_multi_tensor([p], None, [zeros().double()], [zeros()], [zeros()], [1.0],
                                 [1.0], **kwargs)
    with pytest.raises(ValueError):  # a gradient on another device
        adamw.adamw_multi_tensor([p], None, [zeros().cpu()], [zeros()], [zeros()], [1.0], [1.0],
                                 **kwargs)
    with pytest.raises(ValueError):  # not contiguous
        adamw.adamw_multi_tensor([p.t()], None, [zeros()], [zeros()], [zeros()], [1.0], [1.0],
                                 **kwargs)


# Attention over separate q, k, v: the plain forward rounds at the kernel's
# points (one flipped bf16 ulp).  The plain backward keeps W and dS in fp32
# where the kernel carries them as two bf16 terms (16 bits of mantissa): an
# error of 2^-17 relative per term, far inside one bf16 ulp of the outputs.
@pytest.mark.parametrize(
    "B, H, N, hd",
    [(64, 12, 197, 64), (4, 16, 197, 32), (2, 3, 37, 16), (1, 2, 256, 64), (1, 1, 1, 16),
     (2, 4, 130, 32)],
)
def test_separate_attention_kernels_match_plain(gen, B, H, N, hd):
    from ssl4polyp_tpu_torch.ops import attention

    q, k, v, dout = (_randn(gen, B, H, N, hd) for _ in range(4))
    results = []
    for fn in (attention.fused_attention, attention.fused_attention_plain):
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]
        ops.reset_launch_counts()
        out = fn(*leaves)
        out.backward(dout)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        kernel = fn is attention.fused_attention
        assert counts["fused_attention"] == counts["fused_attention_backward"] == int(kernel)
        assert sum(counts.values()) == 2 * int(kernel)
        results.append((out.detach(), *[a.grad for a in leaves]))
    torch.testing.assert_close(results[0][0], results[1][0], **ATTENTION_TOL)
    for got, want in zip(results[0][1:], results[1][1:]):
        torch.testing.assert_close(got, want, **ATTENTION_BWD_TOL)
    again = attention._backward_kernel(q, k, v, dout)
    assert all(torch.equal(a, g) for a, g in zip(again, results[0][1:]))  # no atomics


def test_separate_attention_wrapper_refuses_what_the_kernel_does_not_take(gen):
    from ssl4polyp_tpu_torch.ops.attention import fused_attention

    q = _randn(gen, 1, 2, 8, 16)
    with torch.inference_mode():
        with pytest.raises(TypeError):
            fused_attention(q.float(), q.float(), q.float())
        with pytest.raises(ValueError):  # head dim 8
            fused_attention(*(_randn(gen, 1, 2, 8, 8) for _ in range(3)))
        with pytest.raises(ValueError):  # > 256 tokens
            fused_attention(*(_randn(gen, 1, 1, 300, 16) for _ in range(3)))
        with pytest.raises(ValueError):  # not contiguous
            fused_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
        with pytest.raises(ValueError):  # shapes differ
            fused_attention(q, q[:, :1], q)


@pytest.mark.parametrize(
    "B, N, Din, H, hd, softmax_f32, valid_len",
    [
        (64, 197, 768, 12, 64, True, None),   # the classifier's block
        (8, 197, 512, 16, 32, False, None),   # the MAE decoder's block
        (3, 197, 768, 12, 64, True, 150),
        (2, 50, 64, 4, 32, False, 40),
        (1, 256, 128, 2, 64, True, 255),
        (2, 129, 192, 8, 32, False, None),
    ],
)
def test_qkvproj_attention_kernels_match_plain(gen, B, N, Din, H, hd, softmax_f32, valid_len):
    from ssl4polyp_tpu_torch.ops import attention_block as ab

    D = H * hd
    x, dout = _randn(gen, B, N, Din), _randn(gen, B, N, D)
    if valid_len is not None:
        dout[:, valid_len:] = 0  # the pad rows' upstream gradient is zero
    w, b = _randn(gen, Din, 3 * D, scale=Din ** -0.5), _randn(gen, 3 * D, scale=0.5)
    results = []
    for fn in (ab.fused_qkvproj_attention, ab.fused_qkvproj_attention_plain):
        leaves = [a.clone().requires_grad_() for a in (x, w, b)]
        ops.reset_launch_counts()
        out = fn(*leaves, H, softmax_f32, valid_len)
        out.backward(dout)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        kernel = fn is ab.fused_qkvproj_attention
        assert counts["fused_qkvproj_attention"] == int(kernel)
        assert counts["fused_qkvproj_attention_backward"] == int(kernel)
        assert sum(counts.values()) == 2 * int(kernel)
        results.append((out.detach(), *[a.grad for a in leaves]))
    (out, dx, dw, db), (ref_out, ref_dx, ref_dw, ref_db) = results
    rows = slice(None) if valid_len is None else slice(0, valid_len)
    # qkv carries one flipped bf16 ulp (fp32 summation order of the
    # projection) into the core, on both sides' own roundings.
    torch.testing.assert_close(out[:, rows], ref_out[:, rows], atol=2e-2, rtol=2e-2)
    # dx, dw and db are sums of each side's own rounded dqkv (over 3D columns,
    # or over every row of the batch): relative to the largest entry.
    for name, got, want in (("dx", dx, ref_dx), ("dw", dw, ref_dw), ("db", db, ref_db)):
        scale = want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2 * scale, rtol=2e-2,
                                   msg=name)
    again = ab._backward_kernel(x, w, b, dout, H, softmax_f32, valid_len)
    assert all(torch.equal(a, g) for a, g in zip(again, (dx, dw, db)))  # no atomics


def test_qkvproj_attention_wrapper_refuses_what_the_kernel_does_not_take(gen):
    from ssl4polyp_tpu_torch.ops.attention_block import fused_qkvproj_attention

    x, w, b = _randn(gen, 1, 8, 64), _randn(gen, 64, 384), _randn(gen, 384)
    with torch.inference_mode():
        with pytest.raises(TypeError):
            fused_qkvproj_attention(x.float(), w.float(), b.float(), 4)
        with pytest.raises(ValueError):  # head dim 16
            fused_qkvproj_attention(x, w, b, 8)
        with pytest.raises(ValueError):  # Din 32 is not a multiple of 64
            fused_qkvproj_attention(_randn(gen, 1, 8, 32), _randn(gen, 32, 384), b, 4)
        with pytest.raises(ValueError):  # > 256 tokens
            fused_qkvproj_attention(_randn(gen, 1, 300, 64), w, b, 4)
        with pytest.raises(ValueError):  # valid_len outside 1..N
            fused_qkvproj_attention(x, w, b, 4, True, 9)
