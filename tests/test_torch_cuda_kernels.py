"""The CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  Run them on
the card with ``python -m pytest tests/test_torch_cuda_kernels.py -q``.
"""

import math

import pytest
import torch

from ssl4polyp_tpu_torch import ops
from ssl4polyp_tpu_torch.ops import attn_proj, mlp
from ssl4polyp_tpu_torch.ops import layernorm as layernorm_ops
from ssl4polyp_tpu_torch.ops import ln_linear as ln_linear_ops
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
        # Past 256 tokens, the key tiles (csrc/qkv_attention_tiles.cu): one
        # key past the last tile of 64, a ragged tile, a ViT-B/16 at 384 px
        # (with keys cut below N and a wholly masked last tile), its MAE
        # decoder's heads, and 1,025 tokens.
        (2, 257, 4, 64, True, None, True),
        (2, 271, 3, 16, False, 200, True),
        (2, 300, 5, 32, True, 299, False),
        (2, 577, 12, 64, True, None, True),
        (2, 577, 12, 64, True, 500, True),
        (2, 577, 16, 32, False, None, True),
        (1, 577, 2, 16, True, 64, False),
        (1, 1025, 4, 64, False, None, True),
    ],
)
@torch.inference_mode()
def test_attention_kernel_matches_plain(gen, B, N, H, hd, softmax_f32, valid_len, with_bias):
    qkv = _randn(gen, B, N, 3 * H * hd)
    bias = _randn(gen, 3 * H * hd, scale=0.5) if with_bias else None
    ops.reset_launch_counts()
    out = fused_qkv_attention(qkv, H, softmax_f32, valid_len, bias)
    torch.cuda.synchronize()
    counter = "fused_qkv_attention_tiles" if N > 256 else "fused_qkv_attention"
    assert ops.launch_counts()[counter] == 1
    assert sum(ops.launch_counts().values()) == 1
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
    # fp32 has kernels of its own (test_torch_cuda_fp32_kernels.py): fp16 is
    # a dtype no kernel takes.
    qkv = _randn(gen, 1, 8, 96)
    x, w, b = _randn(gen, 4, 16), _randn(gen, 8, 16), _randn(gen, 8)
    with torch.inference_mode():
        with pytest.raises(TypeError):
            fused_qkv_attention(qkv.half(), 2)
        with pytest.raises(ValueError):
            fused_qkv_attention(_randn(gen, 1, 8, 3 * 128), 1)  # head dim 128
        # More than 256 tokens in bf16: every attention kernel takes them,
        # attention over separate q, k, v the last (ROADMAP.md §2a, item 2b:
        # the key tiles in its layout); a head dim no kernel takes refuses,
        # naming its item.
        q = _randn(gen, 1, 2, 300, 64)
        ops.reset_launch_counts()
        out = ops.attention.fused_attention(q, q.clone(), q.clone())
        torch.cuda.synchronize()
        assert ops.launch_counts()["fused_attention_tiles"] == 1
        torch.testing.assert_close(out, ops.attention.fused_attention_reference(q, q, q),
                                   **ATTENTION_TOL)
        q = _randn(gen, 1, 2, 300, 80)
        with pytest.raises(ValueError, match="ROADMAP.md §2a, item 4"):
            ops.attention.fused_attention(q, q.clone(), q.clone())
        with pytest.raises(ValueError):
            fc1_gelu(x[:, ::2], w[:, ::2].contiguous(), b)  # x not contiguous
        with pytest.raises(TypeError):
            fc1_gelu(x.half(), w.half(), b.half())
        with pytest.raises(TypeError):  # mixed dtypes
            fc1_gelu(x.float(), w, b)
        with pytest.raises(TypeError):
            layernorm(x.half(), torch.ones(16, device="cuda"), torch.zeros(16, device="cuda"))
        with pytest.raises(ValueError):  # bf16 affine parameters
            layernorm(x, torch.ones(16, device="cuda").bfloat16(), torch.zeros(16, device="cuda"))


# Token counts at each edge of the backward's paths (csrc/qkv_attention.cu):
# one token, one tile and one past it, the encoder's 50, the last token of each
# key-tile class (64, 128, 208) and the first of the next (65, 129, 209), the
# classifier's 197 and 256 (the first design past 208); then the key tiles
# (csrc/qkv_attention_tiles.cu): one token past 256, a ragged tile, a
# ViT-B/16 at 384 px and 1,025 tokens.  Each count runs at every head dim;
# the softmax type, the bias and valid_len (all tokens, one, or three fewer)
# turn over from case to case.
_BWD_TOKENS = (1, 16, 17, 50, 64, 65, 128, 129, 197, 208, 209, 256, 257, 271, 300, 577, 1025)


def _backward_edge_cases():
    cases = []
    for i, (N, hd) in enumerate((N, hd) for N in _BWD_TOKENS for hd in (16, 32, 64)):
        valid_len = (None, 1, N - 3 if N > 3 else None)[i % 3]
        cases.append((1, N, 2, hd, i % 2 == 0, valid_len, (i // 2) % 2 == 0))
    return cases


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
        *_backward_edge_cases(),
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
    tiles = "_tiles" if N > 256 else ""
    assert ops.launch_counts()[f"fused_qkv_attention{tiles}_backward"] == 1
    assert ops.launch_counts()[f"fused_qkv_attention{tiles}"] == 1
    ref_dqkv, ref_dbias = fused_qkv_attention_backward_reference(
        qkv.detach(), dout, H, softmax_f32, valid_len, None if bias is None else bias.detach())
    torch.testing.assert_close(qkv.grad, ref_dqkv, **ATTENTION_BWD_TOL)
    if with_bias:
        scale = ref_dbias.float().abs().max().item()
        torch.testing.assert_close(bias.grad.float(), ref_dbias.float(), atol=2e-3 * scale,
                                   rtol=2e-2)


@pytest.mark.parametrize("N, H, hd", [(50, 12, 64), (197, 16, 32), (197, 12, 64), (256, 2, 64),
                                      (577, 12, 64), (577, 16, 32)])
@pytest.mark.parametrize("softmax_f32", [True, False])
def test_attention_backward_kernel_reruns_bit_identical(gen, N, H, hd, softmax_f32):
    from ssl4polyp_tpu_torch.ops.qkv_attention import _backward_kernel

    qkv, dout = _randn(gen, 4, N, 3 * H * hd), _randn(gen, 4, N, H * hd)
    bias = _randn(gen, 3 * H * hd, scale=0.5)
    first = _backward_kernel(qkv, dout, H, softmax_f32, None, bias)
    again = _backward_kernel(qkv, dout, H, softmax_f32, None, bias)
    assert torch.equal(first[0], again[0]) and torch.equal(first[1], again[1])


@pytest.mark.parametrize("N, H, hd", [(197, 12, 64), (197, 16, 32), (50, 12, 64), (577, 12, 64),
                                      (577, 16, 32)])
def test_attention_backward_kernel_padded_equals_unpadded(gen, N, H, hd):
    # Padded keys are masked and padded rows get a zero upstream gradient, so
    # they add exact zeros: the valid rows' gradients and dbias keep their bits.
    from ssl4polyp_tpu_torch.ops.qkv_attention import _backward_kernel

    qkv, dout = _randn(gen, 2, N, 3 * H * hd), _randn(gen, 2, N, H * hd)
    bias = _randn(gen, 3 * H * hd, scale=0.5)
    padded = torch.cat([qkv, _randn(gen, 2, 3, 3 * H * hd)], dim=1)
    padded_dout = torch.cat([dout, torch.zeros_like(dout[:, :3])], dim=1)
    dqkv, dbias = _backward_kernel(qkv, dout, H, True, None, bias)
    dqkv_p, dbias_p = _backward_kernel(padded, padded_dout, H, True, N, bias)
    assert torch.equal(dqkv_p[:, :N], dqkv)
    assert torch.equal(dbias_p, dbias)


# The second mode (the QKV projection + attention backward's: the scale inside
# dS's rounding, dQ and dK unscaled) on every path: the stored-dS kernel up to
# 208 tokens, its first design to 256, the key tiles past them.
@pytest.mark.parametrize(
    "B, N, H, hd, softmax_f32, valid_len",
    [(4, 197, 12, 64, True, None), (4, 197, 16, 32, False, None), (2, 50, 3, 32, False, 40),
     (2, 208, 4, 32, True, 200), (2, 209, 4, 32, False, None), (1, 256, 2, 64, True, 255),
     (2, 17, 2, 64, True, None), (2, 300, 4, 32, True, 290), (1, 300, 2, 64, False, None)],
)
def test_attention_backward_kernel_in_the_projection_mode_matches_plain(
        gen, B, N, H, hd, softmax_f32, valid_len):
    from ssl4polyp_tpu_torch.ops.qkv_attention import _backward_kernel

    qkv, dout = _randn(gen, B, N, 3 * H * hd), _randn(gen, B, N, H * hd)
    bias = _randn(gen, 3 * H * hd, scale=0.5)
    dqkv, dbias = _backward_kernel(qkv, dout, H, softmax_f32, valid_len, bias, scaled_ds=True)
    again = _backward_kernel(qkv, dout, H, softmax_f32, valid_len, bias, scaled_ds=True)
    torch.cuda.synchronize()
    ref_dqkv, ref_dbias = fused_qkv_attention_backward_reference(
        qkv, dout, H, softmax_f32, valid_len, bias, scaled_ds=True)
    torch.testing.assert_close(dqkv, ref_dqkv, **ATTENTION_BWD_TOL)
    scale = ref_dbias.float().abs().max().item()
    torch.testing.assert_close(dbias.float(), ref_dbias.float(), atol=2e-3 * scale, rtol=2e-2)
    assert torch.equal(dqkv, again[0]) and torch.equal(dbias, again[1])


def test_attention_backward_entry_point_routes_past_256_tokens(gen):
    # ssl4polyp_qkv_attention_bwd_mode, the entry point the C callers use,
    # sends N > 256 to the key tiles with their scratch from the stream's
    # memory pool: the wrapper's bits (its scratch from torch), in both
    # modes; a probe bit, a measurement aid of the shorter paths, is refused.
    from ssl4polyp_tpu_torch.ops import _build
    from ssl4polyp_tpu_torch.ops.qkv_attention import _backward_kernel, _scale

    B, N, H, hd, valid_len = 2, 300, 4, 32, 290
    qkv, dout = _randn(gen, B, N, 3 * H * hd), _randn(gen, B, N, H * hd)
    bias = _randn(gen, 3 * H * hd, scale=0.5)
    dqkv = torch.empty_like(qkv)
    part = torch.empty(B, 3 * H * hd, device="cuda")
    dbias = torch.empty(3 * H * hd, device="cuda")

    def entry(mode, probe=0):
        return _build.library().ssl4polyp_qkv_attention_bwd_mode(
            qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), part.data_ptr(),
            dbias.data_ptr(), B, N, H, hd, valid_len, _scale(hd, torch.bfloat16), hd ** -0.5, 1,
            mode, probe, torch.cuda.current_stream().cuda_stream)

    for mode in (0, 1):
        want = _backward_kernel(qkv, dout, H, True, valid_len, bias, scaled_ds=bool(mode))
        assert entry(mode) == 0
        torch.cuda.synchronize()
        assert torch.equal(dqkv, want[0]) and torch.equal(dbias.to(torch.bfloat16), want[1])
    assert entry(0, probe=1) != 0


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


# Rows around the backward's persistent grid: one, a ragged block, just past
# a block, fewer rows than the grid's warps, and one more than a whole turn of
# every warp of the widest grid ("turn": asked of the library in the test).
@pytest.mark.parametrize("with_dres", [False, True], ids=["plain", "dres"])
@pytest.mark.parametrize("D", [64, 512, 768, 2048])
@pytest.mark.parametrize("M", [1, 15, 17, 100, "turn", 3200, 12608])
def test_layernorm_backward_rows_match_plain_and_rerun_equal(gen, M, D, with_dres):
    if M == "turn":
        from ssl4polyp_tpu_torch.ops._build import library
        M = 8 * library().ssl4polyp_layernorm_bwd_blocks(1 << 20, D) + 1
    x, dm = _randn(gen, M, D), _randn(gen, M, D)
    dres = _randn(gen, M, D) if with_dres else None
    s = 1 + 0.1 * torch.randn(D, generator=gen, device="cuda")
    ops.reset_launch_counts()
    got = ln_linear_ops.layernorm_backward(x, s, dm, 1e-6, False, dres)
    again = ln_linear_ops.layernorm_backward(x, s, dm, 1e-6, False, dres)
    torch.cuda.synchronize()
    assert ops.launch_counts()["layernorm_backward"] == 2
    want = ln_linear_ops.layernorm_backward(x, s, dm, 1e-6, True, dres)
    torch.testing.assert_close(got[0], want[0], **LN_TOL)
    torch.testing.assert_close(got[1], want[1], **LN_PARAM_TOL)
    torch.testing.assert_close(got[2], want[2], **LN_PARAM_TOL)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_layernorm_backward_parts_add_up(gen):
    """The row kernel and the sum of its partials, launched apart, give the
    whole backward's bits."""
    x, dy = _randn(gen, 1000, 768), _randn(gen, 1000, 768)
    w = 1 + 0.1 * torch.randn(768, generator=gen, device="cuda")
    whole = layernorm_ops._backward_kernel(x, dy, w, 1e-6)
    run, results = layernorm_ops._backward_plan(x, dy, w, 1e-6)
    run(layernorm_ops.BACKWARD_PARTS["rows"])
    run(layernorm_ops.BACKWARD_PARTS["sum"])
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(whole, results()))


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


def _ln_linear_args(gen, M, K, N):
    x = _randn(gen, M, K)
    s = 1 + 0.1 * torch.randn(K, generator=gen, device="cuda")
    t = 0.1 * torch.randn(K, generator=gen, device="cuda")
    w, b = _randn(gen, N, K, scale=K ** -0.5), _randn(gen, N, scale=0.5)
    return x, s, t, w, b


# The kernel's tiling: 128-row tiles (M 127, 128, 129: one tile, ragged or
# whole, or two; 1 and 37 a ragged first tile; 12,608 the paths' 99), N in
# tiles of 128 or 256 columns (8 and 24 ragged, 128 and 256 whole, 1,536 and
# 2,304 the paths'), K in stages of 64 (one stage, the decoder's, ViT-B's).
_LN_LINEAR_EDGES = [(m, k, n) for m in (1, 37, 127, 128, 129, 12608) for k in (64, 512, 768)
                    for n in (8, 24, 128, 256, 1536, 2304)]


@pytest.mark.parametrize("M, K, N", _LN_LINEAR_EDGES)
@torch.inference_mode()
def test_ln_linear_tiles_match_plain_and_rerun_equal(gen, M, K, N):
    args = _ln_linear_args(gen, M, K, N)
    out = ln_linear_ops._kernel(*args, 1e-6)
    again = ln_linear_ops._kernel(*args, 1e-6)
    other = ln_linear_ops._kernel(*args, 1e-6, probe=ln_linear_ops.PROBE_OTHER_WIDTH)
    first = ln_linear_ops._kernel(*args, 1e-6, probe=ln_linear_ops.PROBE_FIRST_DESIGN)
    torch.cuda.synchronize()
    assert torch.equal(out, again)  # no atomics
    want = ln_linear_reference(*args)
    for got in (out, other, first):
        torch.testing.assert_close(got, want, **FUSED_TOL)


@pytest.mark.parametrize("K", [64, 512, 768])
@pytest.mark.parametrize("M", [1, 129, 12608])
@torch.inference_mode()
def test_ln_linear_keeps_the_first_designs_normalised_row(gen, M, K):
    # With W = I and b = 0 the output is m itself (one product of 1 a column,
    # exact in fp32): the same bits as the first design's show that the
    # statistics, the formula and its rounding are unchanged.
    x = _randn(gen, M, K, scale=3.0) + 1.0
    s = 1 + 0.1 * torch.randn(K, generator=gen, device="cuda")
    t = 0.1 * torch.randn(K, generator=gen, device="cuda")
    w = torch.eye(K, dtype=torch.bfloat16, device="cuda")
    b = torch.zeros(K, dtype=torch.bfloat16, device="cuda")
    new = ln_linear_ops._kernel(x, s, t, w, b, 1e-6)
    first = ln_linear_ops._kernel(x, s, t, w, b, 1e-6, probe=ln_linear_ops.PROBE_FIRST_DESIGN)
    torch.cuda.synchronize()
    assert torch.equal(new, first)
    torch.testing.assert_close(new, ln_linear_ops.normalised_row(x, s, t, 1e-6), **FUSED_TOL)


@pytest.mark.parametrize("M, K, N", [(12608, 768, 2304), (12608, 512, 1536), (37, 64, 24)])
@torch.inference_mode()
def test_ln_linear_fwd_entry_point_equals_the_wrapper(gen, M, K, N):
    # ssl4polyp_ln_linear_fwd takes its scratch from the stream's pool.
    from ssl4polyp_tpu_torch.ops._build import library

    args = _ln_linear_args(gen, M, K, N)
    want = ln_linear_ops._kernel(*args, 1e-6)
    got = torch.empty_like(want)
    x, s, t, w, b = args
    err = library().ssl4polyp_ln_linear_fwd(
        x.data_ptr(), s.data_ptr(), t.data_ptr(), w.data_ptr(), b.data_ptr(), got.data_ptr(),
        M, K, N, 1e-6, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0 and torch.equal(got, want)


# The fused kernel's tiling: 64-row tiles in clusters of two (M 63, 64, 65:
# one tile, ragged or whole, or two; 129 and 197: a cluster that is not
# full; 12,608 the paths' 197 tiles), NF in chunks of 64 (32 and 96: a
# ragged last chunk), both widths.
_FUSED_EDGES = [(m, k, nf) for k, full in ((512, 2048), (768, 3072))
                for m in (1, 63, 64, 65, 129, 197, 12608) for nf in (32, 96, full)]


def _fused_args(gen, M, K, NF, with_ln):
    x = _randn(gen, M, K)
    s = 1 + 0.1 * torch.randn(K, generator=gen, device="cuda") if with_ln else None
    t = 0.1 * torch.randn(K, generator=gen, device="cuda") if with_ln else None
    w1, b1 = _randn(gen, NF, K, scale=K ** -0.5), _randn(gen, NF, scale=0.5)
    w2, b2 = _randn(gen, K, NF, scale=NF ** -0.5), _randn(gen, K, scale=0.5)
    return x, s, t, w1, b1, w2, b2


@pytest.mark.parametrize("with_ln", [False, True], ids=["mlp_fused", "mlp_ln_fused"])
@pytest.mark.parametrize("M, K, NF", _FUSED_EDGES + [(37, 512, 64)])
def test_fused_mlp_kernels_match_plain(gen, with_ln, M, K, NF):
    x, s, t, w1, b1, w2, b2 = args = _fused_args(gen, M, K, NF, with_ln)
    dy = _randn(gen, M, K)
    h, out = mlp._fused_kernel(*args, 1e-6, write_h=True)
    h_again, out_again = mlp._fused_kernel(*args, 1e-6, write_h=True)
    no_h, out_alone = mlp._fused_kernel(*args, 1e-6, write_h=False)
    first_h, first_out = mlp._fused_kernel(*args, 1e-6, write_h=True,
                                           probe=mlp.FUSED_PROBE_FIRST_DESIGN)
    torch.cuda.synchronize()
    assert torch.equal(h, h_again) and torch.equal(out, out_again)  # no atomics
    assert no_h is None and torch.equal(out, out_alone)
    ref_h, ref_out = mlp._mlp_forward_plain(x, s, t, w1, b1, w2, b2, 1e-6)
    for got_h, got_out in ((h, out), (first_h, first_out)):
        torch.testing.assert_close(got_h, ref_h, **FUSED_TOL)
        torch.testing.assert_close(got_out, ref_out, **FUSED_TOL)
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


@pytest.mark.parametrize("with_ln", [False, True], ids=["mlp_fused", "mlp_ln_fused"])
@pytest.mark.parametrize("M, K, NF", [(197, 768, 96), (12608, 512, 2048)])
def test_fused_mlp_cluster_sizes_give_the_same_bits(gen, with_ln, M, K, NF):
    # Clusters of 4 or 1 block change where W tiles come from, not the order
    # of any sum: the same bits as the paths' clusters of 2.
    args = _fused_args(gen, M, K, NF, with_ln)
    want = mlp._fused_kernel(*args, 1e-6, write_h=True)
    for probe in (mlp.FUSED_PROBE_CLUSTER_4, mlp.FUSED_PROBE_CLUSTER_1):
        got = mlp._fused_kernel(*args, 1e-6, write_h=True, probe=probe)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), probe


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
        with pytest.raises(TypeError):  # fp32 x under bf16 weights: a kernel a dtype
            ln_linear(x.float(), s, t, w1, b1)
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
    _check_attn_proj(gen, B, N, H, hd, softmax_f32, valid_len)


def _check_attn_proj(gen, B, N, H, hd, softmax_f32, valid_len):
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
        names = (("fused_attention_proj_tiles", "fused_attention_proj_tiles_backward")
                 if N > 256 else ("attn_proj", "attn_proj_backward"))
        assert counts[names[0]] == counts[names[1]] == int(kernel)
        # No attention launch of its own; past 256 tokens the backward's
        # statistics pass.
        statistics = int(kernel and N > 256)
        assert counts["qkv_attention_tiles_statistics"] == statistics
        assert sum(counts.values()) == 2 * int(kernel) + statistics
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
    # No atomics: a second forward and a second backward give the same bits.
    with torch.inference_mode():
        assert torch.equal(attn_proj.fused_attention_proj(qkv, w, b, H, softmax_f32, valid_len),
                           out)
    again = attn_proj._backward_kernel(qkv, w, b, dy, H, softmax_f32, valid_len)
    assert all(torch.equal(a, g) for a, g in zip(again, (dqkv, dw, db)))


# One image at every edge of the block plan: a single row, one ragged tile, a
# whole block, one row into a second tile or block, the classifier's tokens,
# the widest 13-tile and 16-tile sequences; width 256 (two column tiles of
# the projection, eight W tiles through a ring of three).
@pytest.mark.parametrize("masked", [False, True], ids=["whole", "valid_len"])
@pytest.mark.parametrize("softmax_f32", [True, False])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("N", [1, 5, 64, 65, 197, 208, 256])
def test_attn_proj_tiles_match_plain_and_rerun_equal(gen, N, hd, softmax_f32, masked):
    valid_len = max(1, N - 3) if masked else None
    _check_attn_proj(gen, 1, N, 256 // hd, hd, softmax_f32, valid_len)


# Past 256 tokens (the compositions on the key tiles): one key past the last
# tile of 64, a ragged tile, a ViT-B/16 at 384 px (the classifier's heads
# and the MAE decoder's), each at hd 32 and 64, with keys cut below N.
_LONG_FOLD_CASES = [
    (2, 257, 2, 64, True, None), (2, 257, 4, 32, False, 250),
    (2, 300, 4, 32, True, 299), (2, 300, 2, 64, False, None),
    (2, 577, 12, 64, True, None), (2, 577, 12, 64, True, 500),
    (2, 577, 16, 32, False, None), (1, 577, 4, 32, True, 64),
]


@pytest.mark.parametrize("B, N, H, hd, softmax_f32, valid_len", _LONG_FOLD_CASES)
def test_attn_proj_past_256_tokens_matches_plain_and_reruns_equal(gen, B, N, H, hd, softmax_f32,
                                                                 valid_len):
    _check_attn_proj(gen, B, N, H, hd, softmax_f32, valid_len)


@pytest.mark.parametrize("N", [197, 577])
def test_attn_proj_backward_phases_add_up(gen, N):
    """The four phases launched apart give the whole backward's bits."""
    qkv, dy = _randn(gen, 2, N, 3 * 256), _randn(gen, 2, N, 256)
    w, b = _randn(gen, 256, 256, scale=1 / 16), _randn(gen, 256, scale=0.5)
    whole = attn_proj._backward_kernel(qkv, w, b, dy, 4, True, None)
    run, results = attn_proj._backward_plan(qkv, w, b, dy, 4, True, None)
    for phase in ("prep", "dw", "db", "attention"):
        run(attn_proj.BACKWARD_PHASES[phase])
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(whole, results()))


def test_attn_proj_dw_first_design_agrees_with_the_dw_product(gen):
    """The dw phase on its first design (mma.sync), a timing aid, against the
    wgmma product: fp32 sums of the same bf16 operands in another order."""
    qkv, dy = _randn(gen, 4, 197, 3 * 768), _randn(gen, 4, 197, 768)
    w, b = _randn(gen, 768, 768, scale=768 ** -0.5), _randn(gen, 768, scale=0.5)
    run, results = attn_proj._backward_plan(qkv, w, b, dy, 12, True, None)
    run(attn_proj.BACKWARD_PHASES["prep"] | attn_proj.BACKWARD_PHASES["dw"])
    torch.cuda.synchronize()
    dw = results()[1].clone()
    run(attn_proj.DW_FIRST_DESIGN_PHASE)
    torch.cuda.synchronize()
    scale = dw.float().abs().max().item()
    torch.testing.assert_close(results()[1].float(), dw.float(), atol=1e-2 * scale, rtol=2e-2)


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
        with pytest.raises(TypeError):  # fp32 qkv under bf16 weights: a kernel a dtype
            attn_proj.fused_attention_proj(_randn(gen, 1, 8, 384).float(), w, b, 4)
        with pytest.raises(ValueError):  # head dim 16
            attn_proj.fused_attention_proj(_randn(gen, 1, 8, 384), w, b, 8)
        with pytest.raises(ValueError):  # width 64 is not a multiple of 128
            attn_proj.fused_attention_proj(_randn(gen, 1, 8, 192), _randn(gen, 64, 64),
                                           _randn(gen, 64), 2)
        with pytest.raises(ValueError):  # no tokens
            attn_proj.fused_attention_proj(_randn(gen, 1, 0, 384), w, b, 4)
        with pytest.raises(ValueError):  # no ablate bits past 256 tokens
            attn_proj._forward_kernel(_randn(gen, 1, 300, 384), w, b, 4, True, None, 1)


def test_attn_proj_entry_points_route_past_256_tokens(gen):
    # The library's entry points send N > 256 to the compositions, with the
    # caller's scratch: the wrapper's bits.  Without that scratch, or with
    # ablate bits, they refuse (cudaErrorInvalidValue, 1).
    from ssl4polyp_tpu_torch.ops._build import library
    from ssl4polyp_tpu_torch.ops.qkv_attention import tiles_backward_scratch

    B, N, H, hd = 2, 577, 12, 64
    D = H * hd
    qkv, dy = _randn(gen, B, N, 3 * D), _randn(gen, B, N, D)
    dy[:, 500:] = 0
    w, b = _randn(gen, D, D, scale=D ** -0.5), _randn(gen, D, scale=0.5)
    with torch.inference_mode():
        want = attn_proj.fused_attention_proj(qkv, w, b, H, True, 500)
    out, core = torch.empty_like(want), torch.empty_like(want)
    lib, stream = library(), torch.cuda.current_stream().cuda_stream
    for o, ablate, code in ((core, 0, 0), (core, 1, 1), (None, 0, 1)):
        err = lib.ssl4polyp_attn_proj_fwd(
            qkv.data_ptr(), w.data_ptr(), b.data_ptr(), None if o is None else o.data_ptr(),
            out.data_ptr(), B, N, H, hd, 500, attn_proj._scale(hd, torch.bfloat16), 1, ablate,
            stream)
        torch.cuda.synchronize()
        assert err == code
        if not code:
            assert torch.equal(out, want)
    grads = attn_proj._backward_kernel(qkv, w, b, dy, H, True, 500)
    slices = lib.ssl4polyp_dw_product_slices(B * N, D, D)
    scratch = [torch.empty(t.shape, dtype=t.dtype, device="cuda")
               for t in (w, want, want, qkv)]  # w_t, o, d_o, dqkv
    dw_part = torch.empty((max(slices, 4), D, D), device="cuda")
    dw, db = torch.empty((D, D), device="cuda"), torch.empty(D, device="cuda")
    db_part = torch.empty((-(-B * N // 64), D), device="cuda")
    tiles_scratch = tiles_backward_scratch(B, H, N, hd, "cuda")
    for stats, code in ((tiles_scratch, 0), ((None, None), 1)):
        err = lib.ssl4polyp_attn_proj_bwd(
            qkv.data_ptr(), w.data_ptr(), dy.data_ptr(), *[t.data_ptr() for t in scratch],
            dw_part.data_ptr(), dw.data_ptr(), db_part.data_ptr(), db.data_ptr(),
            *[None if t is None else t.data_ptr() for t in stats], B, N, H, hd, 500,
            attn_proj._scale(hd, torch.bfloat16), 1.0 / math.sqrt(hd), 1, slices, 15, stream)
        torch.cuda.synchronize()
        assert err == code
        if not code:
            assert all(torch.equal(a, g) for a, g in zip(grads, (scratch[3], dw.bfloat16(),
                                                                 db.bfloat16())))


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


# The backward's tiling: 64-row query tiles (phase A) and key tiles (phase
# B), the last of them reading the 64 rows that end at the key width (at N
# 197: rows 144 .. 207, of which it owns 192 ..); chunks of 64 keys or
# queries, the last 16 wide at the key width 208; one buffer at hd 64 past
# 208 tokens, two elsewhere.  Every length at those edges at each head dim,
# the two timed shapes, and B * H past one round of the persistent grid
# (with one buffer: hd 64, N 256).
_SEPARATE_BWD_EDGES = [(1 + n % 2, 2 - n % 2, n, hd)
                       for n in (1, 63, 64, 65, 129, 193, 197, 208, 209, 256)
                       for hd in (16, 32, 64)]
_SEPARATE_BWD_HEADS = [(64, 16, 197, 32), (3, 100, 256, 64), (70, 10, 65, 16)]


# Attention over separate q, k, v: the plain forward rounds at the kernel's
# points (one flipped bf16 ulp).  The plain backward keeps W and dS in fp32
# where the kernel carries them as two bf16 terms (16 bits of mantissa): an
# error of 2^-17 relative per term, far inside one bf16 ulp of the outputs.
@pytest.mark.parametrize(
    "B, H, N, hd",
    [(64, 12, 197, 64), (4, 16, 197, 32), (2, 3, 37, 16), (1, 2, 256, 64), (1, 1, 1, 16),
     (2, 4, 130, 32)] + _SEPARATE_BWD_EDGES + _SEPARATE_BWD_HEADS,
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
            fused_attention(q.half(), q.half(), q.half())
        with pytest.raises(TypeError):  # mixed dtypes
            fused_attention(q.float(), q, q)
        with pytest.raises(ValueError, match="item 4"):  # head dim 16 in fp32
            fused_attention(q.float(), q.float(), q.float())
        with pytest.raises(ValueError):  # head dim 8
            fused_attention(*(_randn(gen, 1, 2, 8, 8) for _ in range(3)))
        with pytest.raises(ValueError):  # no token
            fused_attention(*(_randn(gen, 1, 1, 0, 16) for _ in range(3)))
        with pytest.raises(ValueError):  # not contiguous
            fused_attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
        with pytest.raises(ValueError):  # shapes differ
            fused_attention(q, q[:, :1], q)


# The forward's tiling: 64-row query tiles taken in turn by two warpgroups,
# keys in widths of 64, 128, 208 and 256, rows of 32, 64 and 128 bytes
# (every length at the edges of a query tile or a key width, at each head
# dim); then B * H below one wave of 132 SMs, between one and two, and past
# five rounds of the persistent grid.
_SEPARATE_FWD_EDGES = [(2, 3, n, hd) for n in (1, 8, 63, 64, 65, 127, 128, 129, 192, 193, 197,
                                                208, 209, 255, 256) for hd in (16, 32, 64)]
_SEPARATE_FWD_HEADS = [(10, 10, 197, 64), (20, 10, 197, 32), (64, 12, 197, 64), (70, 10, 65, 16)]


@pytest.mark.parametrize("B, H, N, hd", _SEPARATE_FWD_EDGES + _SEPARATE_FWD_HEADS)
@torch.inference_mode()
def test_separate_attention_forward_matches_plain_and_reruns_equal(gen, B, H, N, hd):
    from ssl4polyp_tpu_torch.ops import attention

    q, k, v = (_randn(gen, B, H, N, hd) for _ in range(3))
    ops.reset_launch_counts()
    out, again = attention.fused_attention(q, k, v), attention.fused_attention(q, k, v)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_attention"] == 2
    torch.testing.assert_close(out, attention.fused_attention_reference(q, k, v), **ATTENTION_TOL)
    assert torch.equal(out, again)


@pytest.mark.parametrize("B, H, N, hd", [(2, 3, 197, 64), (2, 3, 197, 32), (2, 3, 65, 16),
                                         (1, 2, 256, 64), (3, 1, 1, 32)])
@torch.inference_mode()
def test_separate_attention_first_design_agrees_with_the_kernel(gen, B, H, N, hd):
    from ssl4polyp_tpu_torch.ops import attention

    q, k, v = (_randn(gen, B, H, N, hd) for _ in range(3))
    out = attention._forward_kernel(q, k, v)
    first = attention._forward_kernel(q, k, v, attention.PROBE_FIRST_DESIGN)
    torch.cuda.synchronize()
    ref = attention.fused_attention_reference(q, k, v)
    torch.testing.assert_close(first, ref, **ATTENTION_TOL)
    torch.testing.assert_close(out, first, **ATTENTION_TOL)


@pytest.mark.parametrize("N, hd", [(197, 64), (1, 16), (65, 32), (256, 64), (130, 16)])
@torch.inference_mode()
def test_separate_attention_forward_writes_nothing_past_the_last_row(gen, N, hd):
    # The C entry point on views inside sentinel-filled buffers: nothing
    # before the output or past the last head's row N - 1 changes.  NaN past
    # the inputs' last row would reach the output if a load read past it.
    from ssl4polyp_tpu_torch.ops import attention
    from ssl4polyp_tpu_torch.ops._build import library

    B, H, pad = 2, 3, 4096
    size = B * H * N * hd

    def inside(fill, body=None):
        buffer = torch.full((pad + size + pad,), fill, dtype=torch.bfloat16, device="cuda")
        if body is not None:
            buffer[pad:pad + size] = body.reshape(-1)
        return buffer, buffer[pad:pad + size].view(B, H, N, hd)

    q, k, v = (_randn(gen, B, H, N, hd) for _ in range(3))
    views = [inside(float("nan"), t)[1] for t in (q, k, v)]
    buffer, out = inside(-1234.0)
    err = library().ssl4polyp_attention_fwd(*(t.data_ptr() for t in views), out.data_ptr(), B * H,
                                            N, hd, hd ** -0.5,
                                            torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert (buffer[:pad] == -1234.0).all() and (buffer[pad + size:] == -1234.0).all()
    torch.testing.assert_close(out, attention.fused_attention_reference(q, k, v), **ATTENTION_TOL)


@pytest.mark.parametrize("probe", ["no_softmax", "no_softmax_no_values"])
@pytest.mark.parametrize("N, hd", [(197, 64), (197, 32), (65, 16), (256, 64), (8, 32)])
@torch.inference_mode()
def test_separate_attention_forward_products_alone_are_exact(gen, N, hd, probe):
    # The two products apart from the softmax, through the probe: without the
    # softmax the weights are the scores rounded; without the product with v
    # too, the output is the scores of keys 0 .. hd - 1.  Integer multiples
    # of 1/8 in q and k and small integers in v make every score and every
    # sum exact in fp32 and the scores exact in bf16, so any fault of the
    # operands' layouts (K-major Q and K, MN-major V) shows bit for bit.
    from ssl4polyp_tpu_torch.ops import attention

    B, H = 2, 3

    def ints(low, high, scale):
        values = torch.randint(low, high, (B, H, N, hd), generator=gen, device="cuda")
        return (values.float() * scale).to(torch.bfloat16)

    q, k, v = ints(-2, 3, 0.125), ints(-2, 3, 0.125), ints(-3, 4, 1.0)
    bits = attention.PROBE_NO_SOFTMAX
    keys = torch.zeros(B, H, max(N, hd), hd, dtype=torch.float32, device="cuda")
    keys[:, :, :N] = k.float()
    scores = (q.float() @ keys.transpose(-1, -2)).to(torch.bfloat16)
    if probe == "no_softmax":
        want = (scores[..., :N].float() @ v.float()).to(torch.bfloat16)
    else:
        bits |= attention.PROBE_NO_VALUES
        want = scores[..., :hd]
    got = attention._forward_kernel(q, k, v, bits)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


@pytest.mark.parametrize("B, H, N, hd", [(2, 3, 197, 64), (2, 3, 197, 32), (2, 3, 65, 16),
                                         (1, 2, 256, 64), (3, 1, 1, 32), (2, 70, 208, 64)])
@torch.inference_mode()
def test_separate_attention_backward_first_design_agrees_with_the_kernel(gen, B, H, N, hd):
    # The first design through the probe against the plain version and the
    # kernel; the kernel with one buffer (no prefetch) gives the kernel's
    # bits, since only where a head waits changes.
    from ssl4polyp_tpu_torch.ops import attention

    q, k, v, dout = (_randn(gen, B, H, N, hd) for _ in range(4))
    grads = attention._backward_kernel(q, k, v, dout)
    first = attention._backward_kernel(q, k, v, dout, attention.BACKWARD_PROBE_FIRST_DESIGN)
    one_buffer = attention._backward_kernel(q, k, v, dout, attention.BACKWARD_PROBE_NO_PREFETCH)
    torch.cuda.synchronize()
    ref = attention.fused_attention_backward_reference(q, k, v, dout)
    for name, got, old, want in zip(("dq", "dk", "dv"), grads, first, ref):
        torch.testing.assert_close(old, want, **ATTENTION_BWD_TOL, msg=name)
        torch.testing.assert_close(got, old, **ATTENTION_BWD_TOL, msg=name)
    assert all(torch.equal(a, g) for a, g in zip(one_buffer, grads))


# The share of the elements of dQ, dK and dV that differ from the fp64
# backward rounded once to bf16.  The kernel carries W and dS as hi + lo bf16
# terms (16 bits of mantissa) and sums in fp32, so its gradient before the
# output rounding lies far inside one bf16 ulp of the fp64 one and rounds to
# the same bf16 value but where the exact value lies close to a rounding
# boundary.  With one term (the probe's BACKWARD_PROBE_ONE_TERM) W and dS
# carry an error of about 2^-9 relative, as large as the output rounding
# itself, and a large share of the elements round the other way.  The max
# error cannot tell them apart: each gradient's own rounding to bf16 sets it.
# The bound lies between the two variants' readings on the card (PERF.md §6,
# row 11b).
TWO_TERM_MISMATCH_SHARE = 0.05


def _mismatch_share(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got != want).float().mean().item()


@pytest.mark.parametrize("B, H, N, hd", [(64, 12, 197, 64), (64, 16, 197, 32)])
@torch.inference_mode()
def test_separate_attention_backward_keeps_w_and_ds_in_two_terms(gen, B, H, N, hd):
    # The classifier's shape and the MAE decoder's: the kernel against the
    # plain backward in fp64 on the same bf16 inputs, then the one-term
    # variant, which must fail the same bound.
    from ssl4polyp_tpu_torch.ops import attention

    q, k, v, dout = (_randn(gen, B, H, N, hd) for _ in range(4))
    want = attention.fused_attention_backward_reference(q, k, v, dout, torch.float64)
    grads = attention._backward_kernel(q, k, v, dout)
    one_term = attention._backward_kernel(q, k, v, dout, attention.BACKWARD_PROBE_ONE_TERM)
    torch.cuda.synchronize()
    readings = {}
    for name, got, loose, ref in zip(("dq", "dk", "dv"), grads, one_term, want):
        exact = ref.double()
        readings[name] = tuple(
            (_mismatch_share(t, ref),
             ((t.double() - exact).norm() / exact.norm()).item()) for t in (got, loose))
    print(f"\n({B}, {H}, {N}, {hd}) share off the rounded fp64 result and relative "
          "Frobenius error, two terms | one term: " + "; ".join(
              f"{name} {two[0]:.4f} {two[1]:.3e} | {one[0]:.4f} {one[1]:.3e}"
              for name, (two, one) in readings.items()))
    for name, (two, one) in readings.items():
        assert two[0] < TWO_TERM_MISMATCH_SHARE, (name, two)
        assert one[0] > TWO_TERM_MISMATCH_SHARE, (name, one)


@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("N, poison_N", [(1, 64), (65, 128), (129, 208), (209, 256)])
@torch.inference_mode()
def test_separate_attention_backward_ignores_what_shared_memory_held(gen, N, hd, poison_N):
    # A run at the same key width whose every score is -inf leaves NaN and
    # -inf statistics in the kernel's shared memory on every SM (300 heads:
    # both sets of each block).  At N 1, 65, 129 and 209 the last query tile
    # has warps without a row below N; phase B reads their rows' statistics,
    # which must be the zeros phase A wrote, not what the last kernel left.
    from ssl4polyp_tpu_torch.ops import attention

    big = torch.full((3, 100, poison_N, hd), 1e30, dtype=torch.bfloat16, device="cuda")
    attention._backward_kernel(big, -big, big, big)
    q, k, v, dout = (_randn(gen, 2, 3, N, hd) for _ in range(4))
    grads = attention._backward_kernel(q, k, v, dout)
    torch.cuda.synchronize()
    for name, got, want in zip(("dq", "dk", "dv"), grads,
                               attention.fused_attention_backward_reference(q, k, v, dout)):
        torch.testing.assert_close(got, want, **ATTENTION_BWD_TOL, msg=name)


@pytest.mark.parametrize("N, hd", [(197, 64), (1, 16), (65, 32), (256, 64), (130, 16), (208, 32)])
@torch.inference_mode()
def test_separate_attention_backward_writes_nothing_past_the_last_row(gen, N, hd):
    # The C entry point on views inside sentinel-filled buffers: nothing
    # before dq, dk, dv or past the last head's row N - 1 changes.  NaN past
    # the inputs' last row would reach the gradients if a load read past it.
    from ssl4polyp_tpu_torch.ops import attention
    from ssl4polyp_tpu_torch.ops._build import library

    B, H, pad = 2, 3, 4096
    size = B * H * N * hd

    def inside(fill, body=None):
        buffer = torch.full((pad + size + pad,), fill, dtype=torch.bfloat16, device="cuda")
        if body is not None:
            buffer[pad:pad + size] = body.reshape(-1)
        return buffer, buffer[pad:pad + size].view(B, H, N, hd)

    q, k, v, dout = (_randn(gen, B, H, N, hd) for _ in range(4))
    views = [inside(float("nan"), t)[1] for t in (q, k, v, dout)]
    outputs = [inside(-1234.0) for _ in range(3)]
    err = library().ssl4polyp_attention_bwd(*(t.data_ptr() for t in views),
                                            *(out.data_ptr() for _, out in outputs), B * H, N, hd,
                                            hd ** -0.5, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    ref = attention.fused_attention_backward_reference(q, k, v, dout)
    for name, (buffer, out), want in zip(("dq", "dk", "dv"), outputs, ref):
        assert (buffer[:pad] == -1234.0).all() and (buffer[pad + size:] == -1234.0).all(), name
        torch.testing.assert_close(out, want, **ATTENTION_BWD_TOL, msg=name)


# Attention over separate q, k, v past 256 tokens in bf16: the key tiles in
# its layout and with its roundings (csrc/qkv_attention_tiles.cu, kBwdExact).
# One key past four 64-key tiles, a ragged last tile, a ViT-B/16 at 384 px,
# 1,025 tokens, at each head dim; the classifier's and the MAE decoder's
# heads at 577.
_SEPARATE_TILES = ([(2, 3, n, hd) for n in (257, 300, 577, 1025) for hd in (16, 32, 64)]
                   + [(4, 12, 577, 64), (4, 16, 577, 32)])


@pytest.mark.parametrize("B, H, N, hd", _SEPARATE_TILES)
def test_separate_attention_key_tiles_match_plain(gen, B, H, N, hd):
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
        assert counts["fused_attention_tiles"] == counts["fused_attention_tiles_backward"] == int(
            kernel)
        assert counts["qkv_attention_tiles_statistics"] == int(kernel)
        assert sum(counts.values()) == 3 * int(kernel)
        results.append((out.detach(), *[a.grad for a in leaves]))
    torch.testing.assert_close(results[0][0], results[1][0], **ATTENTION_TOL)
    for name, got, want in zip(("dq", "dk", "dv"), results[0][1:], results[1][1:]):
        torch.testing.assert_close(got, want, **ATTENTION_BWD_TOL, msg=name)
    with torch.inference_mode():
        again = attention._forward_kernel(q, k, v)
        grads = attention._backward_kernel(q, k, v, dout)
    assert torch.equal(again, results[0][0])
    assert all(torch.equal(a, g) for a, g in zip(grads, results[0][1:]))  # no atomics


@pytest.mark.parametrize("N, hd", [(257, 64), (300, 16), (577, 32), (1025, 64)])
@torch.inference_mode()
def test_separate_attention_key_tiles_write_nothing_past_the_last_row(gen, N, hd):
    # The C entry points on views inside sentinel-filled buffers: nothing
    # before the outputs or past the last head's row N - 1 changes, and NaN
    # past the inputs' last row does not reach them.
    from ssl4polyp_tpu_torch.ops import attention
    from ssl4polyp_tpu_torch.ops._build import library

    B, H, pad = 2, 3, 4096
    size = B * H * N * hd

    def inside(fill, body=None):
        buffer = torch.full((pad + size + pad,), fill, dtype=torch.bfloat16, device="cuda")
        if body is not None:
            buffer[pad:pad + size] = body.reshape(-1)
        return buffer, buffer[pad:pad + size].view(B, H, N, hd)

    q, k, v, dout = (_randn(gen, B, H, N, hd) for _ in range(4))
    views = [inside(float("nan"), t)[1] for t in (q, k, v, dout)]
    outputs = [inside(-1234.0) for _ in range(4)]
    stream = torch.cuda.current_stream().cuda_stream
    scale = 1.0 / math.sqrt(hd)
    stats = torch.full((B, H, N, 4), float("nan"), device="cuda")
    dq_acc = torch.full((B, H, N, hd), float("nan"), device="cuda")
    assert library().ssl4polyp_attention_tiles_fwd(
        *(t.data_ptr() for t in views[:3]), outputs[0][1].data_ptr(), B, H, N, hd, scale,
        stream) == 0
    assert library().ssl4polyp_attention_tiles_bwd(
        *(t.data_ptr() for t in views), *(out.data_ptr() for _, out in outputs[1:]),
        stats.data_ptr(), dq_acc.data_ptr(), B, H, N, hd, scale, stream) == 0
    torch.cuda.synchronize()
    refs = (attention.fused_attention_reference(q, k, v),
            *attention.fused_attention_backward_reference(q, k, v, dout))
    for name, (buffer, out), want, tol in zip(("out", "dq", "dk", "dv"), outputs, refs,
                                              (ATTENTION_TOL, *[ATTENTION_BWD_TOL] * 3)):
        assert (buffer[:pad] == -1234.0).all() and (buffer[pad + size:] == -1234.0).all(), name
        torch.testing.assert_close(out, want, **tol, msg=name)


def _one_term_backward(q, k, v, dout):
    """fused_attention's backward with W and dS rounded once to bf16 before
    their products (in fp64 otherwise): what a kernel carrying one bf16 term
    of each would give."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qd, kd, vd, dod = (t.double() for t in (q, k, v, dout))
    w = torch.softmax(qd @ kd.transpose(-1, -2) * scale, dim=-1)
    dw = dod @ vd.transpose(-1, -2)
    ds = w * (dw - (dw * w).sum(dim=-1, keepdim=True)) * scale
    w1, ds1 = (t.to(torch.bfloat16).double() for t in (w, ds))
    return tuple(g.to(torch.bfloat16) for g in (ds1 @ kd, ds1.transpose(-1, -2) @ qd,
                                                w1.transpose(-1, -2) @ dod))


@pytest.mark.parametrize("B, H, N, hd", [(4, 12, 577, 64), (4, 16, 577, 32)])
@torch.inference_mode()
def test_separate_attention_key_tiles_keep_w_and_ds_in_two_terms(gen, B, H, N, hd):
    # G1's check past 256 tokens: the key tiles' share of elements off the
    # fp64 backward's bf16 rounding stays under TWO_TERM_MISMATCH_SHARE, as
    # attention.cu's does up to 256; a plain emulation that rounds W and dS
    # once reads above it.  A small B keeps the fp64 reference in memory.
    from ssl4polyp_tpu_torch.ops import attention

    q, k, v, dout = (_randn(gen, B, H, N, hd) for _ in range(4))
    want = attention.fused_attention_backward_reference(q, k, v, dout, torch.float64)
    grads = attention._backward_kernel(q, k, v, dout)
    one_term = _one_term_backward(q, k, v, dout)
    torch.cuda.synchronize()
    readings = {name: (_mismatch_share(got, ref), _mismatch_share(loose, ref))
                for name, got, loose, ref in zip(("dq", "dk", "dv"), grads, one_term, want)}
    print(f"\n({B}, {H}, {N}, {hd}) share off the rounded fp64 result, key tiles | one term: "
          + "; ".join(f"{name} {two:.4f} | {one:.4f}" for name, (two, one) in readings.items()))
    for name, (two, one) in readings.items():
        assert two < TWO_TERM_MISMATCH_SHARE, (name, two)
        assert one > TWO_TERM_MISMATCH_SHARE, (name, one)


# The key tiles' forward and statistics pass (csrc/qkv_attention_tiles.cu:
# 128-row query blocks of two 64-row warpgroups, 64-key tiles by TMA) at the
# block's edges: one row past two blocks, a ragged block, one row short of,
# at and one past three, a ViT-B/16 at 384 px (a last block of 65 rows), one
# row past five, and 1,025; at every head dim, with and without a bias, both
# score types, every key or keys cut inside a tile.  The statistics, each
# row's (max * log2(e), 1/sum, tmp), against tiles_statistics_reference in
# fp32: the sums run in another order and exp2 on the special function unit
# (2^-22 relative), so each column sits within KEY_TILES_STATS_RTOL of its
# largest magnitude; with bf16 scores a score whose rounding flips on that
# order moves by one bf16 ulp (2^-8 relative), and with it the max and a
# weight, hence the wider limit.
KEY_TILES_STATS_RTOL = {True: 1e-4, False: 1e-2}
_KEY_TILES_EDGES = [(n, hd) for n in (257, 300, 383, 384, 385, 577, 641, 1025) for hd in (16, 32, 64)]


def _stats_error(got, want):
    """Each statistics column's max |diff| as a share of its largest value."""
    return [((got[..., c] - want[..., c]).abs().max() / want[..., c].abs().max()).item()
            for c in range(3)]


@pytest.mark.parametrize("cut", [False, True], ids=["every-key", "cut"])
@pytest.mark.parametrize("softmax_f32", [True, False], ids=["f32-scores", "bf16-scores"])
@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "no-bias"])
@pytest.mark.parametrize("N, hd", _KEY_TILES_EDGES)
@torch.inference_mode()
def test_key_tiles_forward_and_statistics_match_plain(gen, N, hd, with_bias, softmax_f32, cut):
    from ssl4polyp_tpu_torch.ops import qkv_attention as qa

    B, H = 2, 2
    valid_len = N - 37 if cut else None
    qkv, dout = _randn(gen, B, N, 3 * H * hd), _randn(gen, B, N, H * hd)
    bias = _randn(gen, 3 * H * hd, scale=0.5) if with_bias else None
    ops.reset_launch_counts()
    out = fused_qkv_attention(qkv, H, softmax_f32, valid_len, bias)
    again = fused_qkv_attention(qkv, H, softmax_f32, valid_len, bias)
    assert ops.launch_counts()["fused_qkv_attention_tiles"] == 2
    stats = qa.tiles_probe(qkv, H, softmax_f32, valid_len, bias, qa.TILES_PROBE_STATISTICS,
                           dout=dout)
    stats_again = qa.tiles_probe(qkv, H, softmax_f32, valid_len, bias,
                                 qa.TILES_PROBE_STATISTICS, dout=dout)
    first = qa.tiles_probe(qkv, H, softmax_f32, valid_len, bias, qa.TILES_PROBE_FIRST_DESIGN)
    torch.cuda.synchronize()
    ref = fused_qkv_attention_reference(qkv, H, softmax_f32, valid_len, bias)
    torch.testing.assert_close(out, ref, **ATTENTION_TOL)
    torch.testing.assert_close(first, ref, **ATTENTION_TOL)
    assert torch.equal(out, again) and torch.equal(stats, stats_again)  # no atomics
    errors = _stats_error(stats, qa.tiles_statistics_reference(qkv, dout, H, softmax_f32,
                                                               valid_len, bias))
    assert max(errors) < KEY_TILES_STATS_RTOL[softmax_f32], errors
    assert (stats[..., 3] == 0).all()


@pytest.mark.parametrize("N, hd", _KEY_TILES_EDGES)
@torch.inference_mode()
def test_separate_key_tiles_forward_and_statistics_match_plain(gen, N, hd):
    # The same edges in fused_attention's (B, H, N, hd) layout and roundings.
    from ssl4polyp_tpu_torch.ops import attention
    from ssl4polyp_tpu_torch.ops import qkv_attention as qa

    B, H = 2, 3
    q, k, v, dout = (_randn(gen, B, H, N, hd) for _ in range(4))
    out = attention.fused_attention(q, k, v)
    again = attention.fused_attention(q, k, v)
    separate = qa.TILES_PROBE_SEPARATE
    stats = qa.tiles_probe(q, H, probe=separate | qa.TILES_PROBE_STATISTICS, k=k, v=v,
                           dout=dout)
    first = qa.tiles_probe(q, H, probe=separate | qa.TILES_PROBE_FIRST_DESIGN, k=k, v=v)
    torch.cuda.synchronize()
    ref = attention.fused_attention_reference(q, k, v)
    torch.testing.assert_close(out, ref, **ATTENTION_TOL)
    torch.testing.assert_close(first, ref, **ATTENTION_TOL)
    assert torch.equal(out, again)
    errors = _stats_error(stats, qa.tiles_statistics_reference(q, dout, H, k=k, v=v))
    assert max(errors) < KEY_TILES_STATS_RTOL[True], errors


@pytest.mark.parametrize("N, hd, with_bias", [(300, 16, True), (385, 64, False), (577, 32, True),
                                              (641, 64, True)])
@torch.inference_mode()
def test_key_tiles_write_nothing_past_the_last_row(gen, N, hd, with_bias):
    # The forward's and the statistics pass's C entry on views inside
    # sentinel-filled buffers: nothing before the output or past the last
    # image's row N - 1 changes (the canary rows), and NaN past the inputs'
    # last row reaches neither.
    from ssl4polyp_tpu_torch.ops import qkv_attention as qa
    from ssl4polyp_tpu_torch.ops._build import library

    B, H, pad = 2, 2, 4096
    D = H * hd

    def inside(fill, numel, dtype=torch.bfloat16):
        buffer = torch.full((pad + numel + pad,), fill, dtype=dtype, device="cuda")
        return buffer, buffer[pad:pad + numel]

    qkv, dout = _randn(gen, B, N, 3 * D), _randn(gen, B, N, D)
    bias = _randn(gen, 3 * D, scale=0.5) if with_bias else None
    q_buf, q_view = inside(float("nan"), qkv.numel())
    q_view.copy_(qkv.reshape(-1))
    d_buf, d_view = inside(float("nan"), dout.numel())
    d_view.copy_(dout.reshape(-1))
    o_buf, o_view = inside(-1234.0, B * N * D)
    s_buf, s_view = inside(-1234.0, B * H * N * 4, torch.float32)
    stream = torch.cuda.current_stream().cuda_stream
    scale_c = qa._scale(hd, torch.bfloat16)
    bias_ptr = None if bias is None else bias.data_ptr()
    assert library().ssl4polyp_qkv_attention_fwd(q_view.data_ptr(), bias_ptr, o_view.data_ptr(),
                                                 B, N, H, hd, N, scale_c, 1, stream) == 0
    assert library().ssl4polyp_qkv_attention_tiles_fwd_probe(
        q_view.data_ptr(), None, None, bias_ptr, d_view.data_ptr(), None, s_view.data_ptr(), B,
        N, H, hd, N, scale_c, 1, qa.TILES_PROBE_STATISTICS, stream) == 0
    torch.cuda.synchronize()
    for name, buffer, fill in (("out", o_buf, -1234.0), ("stats", s_buf, -1234.0)):
        assert (buffer[:pad] == fill).all() and (buffer[-pad:] == fill).all(), name
    ref = fused_qkv_attention_reference(qkv, H, True, None, bias)
    torch.testing.assert_close(o_view.view(B, N, D), ref, **ATTENTION_TOL)
    errors = _stats_error(s_view.view(B, H, N, 4),
                          qa.tiles_statistics_reference(qkv, dout, H, True, None, bias))
    assert max(errors) < KEY_TILES_STATS_RTOL[True], errors


@pytest.mark.parametrize(
    "B, N, Din, H, hd, softmax_f32, valid_len",
    [
        (64, 197, 768, 12, 64, True, None),   # the classifier's block
        (8, 197, 512, 16, 32, False, None),   # the MAE decoder's block
        (3, 197, 768, 12, 64, True, 150),
        (2, 50, 64, 4, 32, False, 40),
        (1, 256, 128, 2, 64, True, 255),
        (2, 129, 192, 8, 32, False, None),
        (2, 50, 64, 3, 32, False, 40),        # an odd head count at hd 32: 3D = 288
        # Past 256 tokens (the composition on the key tiles): one key past the
        # last tile of 64, a ragged tile, a ViT-B/16 at 384 px (the
        # classifier's block and the MAE decoder's), at hd 32 and 64, with
        # keys cut below N and an odd head count.
        (2, 257, 64, 2, 64, True, None),
        (2, 257, 128, 4, 32, False, 250),
        (2, 300, 192, 3, 32, True, 299),
        (2, 300, 128, 2, 64, False, None),
        (2, 577, 768, 12, 64, True, None),
        (2, 577, 768, 12, 64, True, 500),
        (2, 577, 512, 16, 32, False, None),
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
        name = "fused_qkvproj_attention_tiles" if N > 256 else "fused_qkvproj_attention"
        assert counts[name] == counts[f"{name}_backward"] == int(kernel)
        statistics = int(kernel and N > 256)  # the backward's statistics pass
        assert counts["qkv_attention_tiles_statistics"] == statistics
        assert sum(counts.values()) == 2 * int(kernel) + statistics
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
    with torch.inference_mode():
        assert torch.equal(ab.fused_qkvproj_attention(x, w, b, H, softmax_f32, valid_len), out)


def test_qkvproj_attention_wrapper_refuses_what_the_kernel_does_not_take(gen):
    from ssl4polyp_tpu_torch.ops.attention_block import fused_qkvproj_attention

    x, w, b = _randn(gen, 1, 8, 64), _randn(gen, 64, 384), _randn(gen, 384)
    with torch.inference_mode():
        with pytest.raises(TypeError):  # fp32 x under bf16 weights: a kernel a dtype
            fused_qkvproj_attention(x.float(), w, b, 4)
        with pytest.raises(ValueError):  # head dim 16
            fused_qkvproj_attention(x, w, b, 8)
        with pytest.raises(ValueError):  # Din 32 is not a multiple of 64
            fused_qkvproj_attention(_randn(gen, 1, 8, 32), _randn(gen, 32, 384), b, 4)
        with pytest.raises(ValueError):  # no tokens
            fused_qkvproj_attention(_randn(gen, 1, 0, 64), w, b, 4)
        with pytest.raises(ValueError):  # valid_len outside 1..N
            fused_qkvproj_attention(x, w, b, 4, True, 9)


# The forward's tiling: tokens split in halves of 8 * NKT between two
# warpgroups (16 * NKT keys: 64, 128, 208, 256), 64-row query tiles, units of
# one head at hd 64 and two at hd 32 (an odd head count leaves the last
# unit's second head empty), 32-deep reduction steps of the x + W ring;
# every length at the edges of a 16-row group, a query tile or a key width,
# at both head dims, with Din 64, 512 and 768 and valid_len below N; then the
# six shapes of the test above, among them units below one wave of 132 SMs
# and past five rounds.
_QKVPROJ_FWD_EDGES = [
    (2, n, (64, 512, 768)[i % 3], 3, hd, i % 2 == 0, None if i % 4 < 2 else max(1, n - 7))
    for i, (n, hd) in enumerate((n, hd) for n in (1, 16, 17, 64, 65, 192, 193, 208, 256)
                                for hd in (32, 64))
]
_QKVPROJ_FWD_SHAPES = [
    (64, 197, 768, 12, 64, True, None), (8, 197, 512, 16, 32, False, None),
    (3, 197, 768, 12, 64, True, 150), (2, 50, 64, 4, 32, False, 40),
    (1, 256, 128, 2, 64, True, 255), (2, 129, 192, 8, 32, False, None),
]


def _qkvproj_args(gen, B, N, Din, H, hd):
    D = H * hd
    return (_randn(gen, B, N, Din), _randn(gen, Din, 3 * D, scale=Din ** -0.5),
            _randn(gen, 3 * D, scale=0.5))


@pytest.mark.parametrize("B, N, Din, H, hd, softmax_f32, valid_len",
                         _QKVPROJ_FWD_EDGES + _QKVPROJ_FWD_SHAPES)
@torch.inference_mode()
def test_qkvproj_attention_forward_matches_plain_and_reruns_equal(gen, B, N, Din, H, hd,
                                                                   softmax_f32, valid_len):
    from ssl4polyp_tpu_torch.ops import attention_block as ab

    x, w, b = _qkvproj_args(gen, B, N, Din, H, hd)
    ops.reset_launch_counts()
    out = ab.fused_qkvproj_attention(x, w, b, H, softmax_f32, valid_len)
    again = ab.fused_qkvproj_attention(x, w, b, H, softmax_f32, valid_len)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_qkvproj_attention"] == 2
    rows = slice(None) if valid_len is None else slice(0, valid_len)
    ref = ab.fused_qkvproj_attention_reference(x, w, b, H, softmax_f32, valid_len)
    # As in the test above: one flipped bf16 ulp of qkv carried into the core.
    torch.testing.assert_close(out[:, rows], ref[:, rows], atol=2e-2, rtol=2e-2)
    assert torch.isfinite(out).all()
    assert torch.equal(out, again)


@pytest.mark.parametrize("B, N, Din, H, hd, softmax_f32, valid_len",
                         _QKVPROJ_FWD_SHAPES[1:] + [(2, 1, 64, 3, 32, True, None)])
@torch.inference_mode()
def test_qkvproj_attention_first_design_agrees_with_the_kernel(gen, B, N, Din, H, hd,
                                                                softmax_f32, valid_len):
    from ssl4polyp_tpu_torch.ops import attention_block as ab

    x, w, b = _qkvproj_args(gen, B, N, Din, H, hd)
    args = (x, w, b, H, softmax_f32, valid_len)
    out = ab._forward_kernel(*args)
    first = ab._forward_kernel(*args, probe=ab.PROBE_FIRST_DESIGN)
    torch.cuda.synchronize()
    rows = slice(None) if valid_len is None else slice(0, valid_len)
    ref = ab.fused_qkvproj_attention_reference(*args)
    torch.testing.assert_close(first[:, rows], ref[:, rows], atol=2e-2, rtol=2e-2)
    torch.testing.assert_close(out[:, rows], first[:, rows], atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("B, N, Din, H, hd", [(3, 197, 768, 12, 64), (2, 197, 512, 16, 32),
                                              (2, 65, 64, 3, 32), (1, 256, 128, 2, 64),
                                              (2, 1, 64, 1, 64), (2, 17, 192, 5, 32)])
@torch.inference_mode()
def test_qkvproj_attention_projection_alone_is_exact(gen, B, N, Din, H, hd):
    # The projection apart from the attention, through the probe: each head's
    # q before its scale fold lands in its columns of out.  Small integers in
    # x, W and b make every product sum exact in fp32 on both sides, so the
    # two roundings agree and any fault of the operands' layouts (W MN-major,
    # x K-major, the transposed stores into swizzled tiles) shows bit for bit.
    from ssl4polyp_tpu_torch.ops import attention_block as ab

    D = H * hd

    def ints(*shape, low=-2, high=3):
        values = torch.randint(low, high, shape, generator=gen, device="cuda")
        return values.to(torch.bfloat16)

    x, w, b = ints(B, N, Din), ints(Din, 3 * D), ints(3 * D, low=-8, high=9)
    got = ab._forward_kernel(x, w, b, H, True, None, probe=ab.PROBE_PROJECTION_ONLY)
    torch.cuda.synchronize()
    assert torch.equal(got, ab._project(x, w, b)[..., :D])


@pytest.mark.parametrize("N, Din, H, hd", [(197, 768, 12, 64), (1, 64, 1, 64), (65, 64, 3, 32),
                                           (256, 128, 2, 64), (17, 192, 5, 32)])
@torch.inference_mode()
def test_qkvproj_attention_forward_reads_and_writes_nothing_outside(gen, N, Din, H, hd):
    # The C entry point on views inside filled buffers: NaN past the last
    # image of x and past the end of W would reach the output if a load read
    # there; nothing before out or past its end changes.
    from ssl4polyp_tpu_torch.ops import attention_block as ab
    from ssl4polyp_tpu_torch.ops._build import library

    B, pad, D = 2, 4096, H * hd

    def inside(fill, body):
        buffer = torch.full((pad + body.numel() + pad,), fill, dtype=torch.bfloat16, device="cuda")
        buffer[pad:pad + body.numel()] = body.reshape(-1)
        return buffer, buffer[pad:pad + body.numel()].view(body.shape)

    x, w, b = _qkvproj_args(gen, B, N, Din, H, hd)
    (_, x_in), (_, w_in) = inside(float("nan"), x), inside(float("nan"), w)
    buffer, out = inside(-1234.0, torch.zeros(B, N, D, device="cuda"))
    err = library().ssl4polyp_qkvproj_attention_fwd(
        x_in.data_ptr(), w_in.data_ptr(), b.data_ptr(), out.data_ptr(), B, N, Din, H, hd, N,
        ab._scale(hd, torch.bfloat16), 1, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert (buffer[:pad] == -1234.0).all() and (buffer[pad + out.numel():] == -1234.0).all()
    ref = ab.fused_qkvproj_attention_reference(x, w, b, H)
    torch.testing.assert_close(out, ref, atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("B, N, Din, H, hd, softmax_f32, valid_len", _QKVPROJ_FWD_SHAPES[2:])
def test_qkvproj_attention_gradients_after_the_forward_equal_the_backward_kernel(
        gen, B, N, Din, H, hd, softmax_f32, valid_len):
    # Through autograd, the new forward leaves the backward's inputs and
    # bits as they were: the gradients equal a direct backward launch's.
    from ssl4polyp_tpu_torch.ops import attention_block as ab

    x, w, b = _qkvproj_args(gen, B, N, Din, H, hd)
    dout = _randn(gen, B, N, H * hd)
    if valid_len is not None:
        dout[:, valid_len:] = 0
    leaves = [a.clone().requires_grad_() for a in (x, w, b)]
    ab.fused_qkvproj_attention(*leaves, H, softmax_f32, valid_len).backward(dout)
    direct = ab._backward_kernel(x, w, b, dout, H, softmax_f32, valid_len)
    torch.cuda.synchronize()
    assert all(torch.equal(leaf.grad, want) for leaf, want in zip(leaves, direct))


def _qkvproj_backward_inputs(gen, B, N, Din, H, hd, valid_len):
    x, w, b = _qkvproj_args(gen, B, N, Din, H, hd)
    dout = _randn(gen, B, N, H * hd)
    if valid_len is not None:
        dout[:, valid_len:] = 0
    return x, w, b, dout


@pytest.mark.parametrize("B, N, Din, H, hd, softmax_f32, valid_len",
                         _QKVPROJ_FWD_SHAPES[1:] + [(2, 256, 64, 2, 64, False, None)])
def test_qkvproj_attention_backward_first_design_matches_plain(gen, B, N, Din, H, hd,
                                                               softmax_f32, valid_len):
    # The first design (3D a multiple of 64), a timing aid, through the probe.
    from ssl4polyp_tpu_torch.ops import attention_block as ab

    args = (*_qkvproj_backward_inputs(gen, B, N, Din, H, hd, valid_len), H, softmax_f32,
            valid_len)
    first = ab._backward_kernel(*args, probe=ab.BACKWARD_PROBE_FIRST_DESIGN)
    torch.cuda.synchronize()
    for name, got, want in zip(("dx", "dw", "db"), first,
                               ab.fused_qkvproj_attention_backward_reference(*args)):
        scale = want.float().abs().max().item()
        torch.testing.assert_close(got.float(), want.float(), atol=1e-2 * scale, rtol=2e-2,
                                   msg=name)


@pytest.mark.parametrize("first_design, N", [(False, 197), (True, 197), (False, 577)])
def test_qkvproj_attention_backward_steps_add_up(gen, first_design, N):
    """The backward's launches run one at a time (the probe's step bits) give
    the whole backward's bits."""
    from ssl4polyp_tpu_torch.ops import attention_block as ab

    args = (*_qkvproj_backward_inputs(gen, 2, N, 512, 16, 32, None), 16, False, None)
    whole = ab._backward_kernel(*args, probe=int(first_design))
    run, results = ab._backward_plan(*args, first_design)
    for bit in ab.BACKWARD_STEPS.values():
        run(bit)
    torch.cuda.synchronize()
    assert all(torch.equal(a, g) for a, g in zip(whole, results()))


def test_qkvproj_attention_entry_points_route_past_256_tokens(gen):
    # ssl4polyp_qkvproj_attention_fwd_probe sends N > 256 with probe 0 to the
    # composition, with the caller's scratch: the wrapper's bits; without
    # it, with probe bits, and the backward's first design past 256 tokens,
    # it refuses (cudaErrorInvalidValue, 1).  ssl4polyp_qkvproj_attention_fwd,
    # for a C caller without scratch (the stream's pool gives it), gives the
    # same bits.
    from ssl4polyp_tpu_torch.ops import attention_block as ab
    from ssl4polyp_tpu_torch.ops._build import library

    B, N, Din, H, hd = 2, 577, 768, 12, 64
    x, w, b, dout = _qkvproj_backward_inputs(gen, B, N, Din, H, hd, None)
    with torch.inference_mode():
        want = ab.fused_qkvproj_attention(x, w, b, H, True, 500)
    out = torch.empty_like(want)
    lib, stream = library(), torch.cuda.current_stream().cuda_stream
    scale = ab._scale(hd, torch.bfloat16)
    scratch = (torch.empty((3 * H * hd, Din), dtype=torch.bfloat16, device="cuda"),
               torch.empty((B, N, 3 * H * hd), dtype=torch.bfloat16, device="cuda"))
    for given, probe, code in ((scratch, 0, 0), (scratch, ab.PROBE_FIRST_DESIGN, 1),
                               (scratch, ab.PROBE_PROJECTION_ONLY, 1), ((None, None), 0, 1)):
        err = lib.ssl4polyp_qkvproj_attention_fwd_probe(
            x.data_ptr(), w.data_ptr(), b.data_ptr(),
            *[None if t is None else t.data_ptr() for t in given], out.data_ptr(), B, N, Din, H,
            hd, 500, scale, 1, probe, stream)
        torch.cuda.synchronize()
        assert err == code
        if not code:
            assert torch.equal(out, want)
    out.zero_()
    err = lib.ssl4polyp_qkvproj_attention_fwd(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                              out.data_ptr(), B, N, Din, H, hd, 500, scale, 1,
                                              stream)
    torch.cuda.synchronize()
    assert err == 0 and torch.equal(out, want)
    run, _ = ab._backward_plan(x, w, b, dout, H, True, None, first_design=True)
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        run(0)


@pytest.mark.parametrize("N, Din, H, hd", [(197, 768, 12, 64), (50, 64, 3, 32), (577, 512, 16, 32)])
def test_qkvproj_attention_bwd_entry_point_equals_the_wrapper(gen, N, Din, H, hd):
    # ssl4polyp_qkvproj_attention_bwd, for a C caller without the two bf16
    # scratches (the stream's pool gives them), gives the wrapper's bits.
    from ssl4polyp_tpu_torch.ops import attention_block as ab
    from ssl4polyp_tpu_torch.ops._build import library

    B, three_d = 2, 3 * H * hd
    x, w, b, dout = _qkvproj_backward_inputs(gen, B, N, Din, H, hd, None)
    want = ab._backward_kernel(x, w, b, dout, H, True, None)
    lib = library()
    slices = lib.ssl4polyp_dw_product_slices(B * N, Din, three_d)
    dqkv = torch.empty((B, N, three_d), dtype=torch.bfloat16, device="cuda")
    db_part = torch.empty((B, three_d), device="cuda")
    db, dx = torch.empty(three_d, device="cuda"), torch.empty_like(x)
    dw_part, dw = torch.empty((slices, Din, three_d), device="cuda"), torch.empty((Din, three_d),
                                                                                   device="cuda")
    err = lib.ssl4polyp_qkvproj_attention_bwd(
        x.data_ptr(), w.data_ptr(), b.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
        db_part.data_ptr(), db.data_ptr(), dx.data_ptr(), dw_part.data_ptr(), dw.data_ptr(), B, N,
        Din, H, hd, N, ab._scale(hd, torch.bfloat16), 1.0 / math.sqrt(hd), 1, slices,
        torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert all(torch.equal(a, g) for a, g in zip(want, (dx, dw.bfloat16(), db.bfloat16())))


# The weight gradients' wgmma product (dw_product.cu): the three paths' shapes
# (the QKV projection's at the classifier and the MAE decoder, the output
# projection's), M off the 64-row step, M under one step, a column count of
# 288 (three heads of 32: a partial column tile), I of one 64-column box, and
# more slices than row steps (empty slices).
DW_SHAPES = [
    (12608, 768, 2304, 0), (12608, 512, 1536, 0), (12608, 768, 768, 0), (1000, 128, 256, 0),
    (37, 64, 288, 0), (100, 64, 288, 0), (3 * 197, 256, 768, 0), (100, 192, 512, 5),
    (12608, 768, 2304, 1), (12608, 768, 768, 3),
]


def _dw_product(a, b, slices=0):
    from ssl4polyp_tpu_torch.ops._build import library

    lib = library()
    M, I, J = a.shape[0], a.shape[1], b.shape[1]
    slices = slices or lib.ssl4polyp_dw_product_slices(M, I, J)
    assert slices >= 1
    part = torch.zeros((slices, I, J), device="cuda")
    out = torch.full((I, J), float("nan"), device="cuda")  # every element is written
    err = lib.ssl4polyp_dw_product(a.data_ptr(), b.data_ptr(), part.data_ptr(), out.data_ptr(), M,
                                   I, J, slices, 3, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    return out, part


@pytest.mark.parametrize("M, I, J, slices", DW_SHAPES)
@torch.inference_mode()
def test_dw_product_is_exact_on_integers(gen, M, I, J, slices):
    # Small integers make every fp32 sum exact in any order: the product must
    # equal torch.matmul in fp32 bit for bit, so any fault of the operands'
    # layouts (both MN-major, the descriptor's atom offset) or of the tails
    # shows.
    def ints(*shape):
        return torch.randint(-2, 3, shape, generator=gen, device="cuda").to(torch.bfloat16)

    a, b = ints(M, I), ints(M, J)
    out, _ = _dw_product(a, b, slices)
    assert torch.equal(out, torch.matmul(a.float().t(), b.float()))


@pytest.mark.parametrize("M, I, J, slices", DW_SHAPES)
@torch.inference_mode()
def test_dw_product_matches_plain_and_reruns_equal(gen, M, I, J, slices):
    a, b = _randn(gen, M, I), _randn(gen, M, J)
    out, part = _dw_product(a, b, slices)
    again, part_again = _dw_product(a, b, slices)
    assert torch.equal(out, again) and torch.equal(part, part_again)
    # fp32 sums of the same bf16 products in another order.
    want = torch.matmul(a.float().t(), b.float())
    torch.testing.assert_close(out, want, atol=1e-4 * want.abs().max().item(), rtol=1e-4)


# The warp-specialised wgmma GEMM's tiles are 128 rows by 128 or 256 columns
# in steps of 64 along K: shapes on, one below and one above each edge, the
# smallest the wrapper takes, and the paths' own.
GEMM_SHAPES = [
    (1, 8, 8), (1, 72, 136), (63, 8, 3072), (63, 512, 8), (63, 2304, 136), (129, 72, 2048),
    (129, 768, 136), (129, 512, 3072), (12608, 72, 8), (12608, 8, 136), (12608, 512, 2048),
    (12608, 768, 3072), (12608, 2304, 136), (3200, 768, 3072),
]


@pytest.mark.parametrize("write_h", [False, True])
@pytest.mark.parametrize("M, K, NF", GEMM_SHAPES)
@torch.inference_mode()
def test_fc1_gelu_tiles_match_plain_and_rerun_equal(gen, M, K, NF, write_h):
    x, w, b = _randn(gen, M, K), _randn(gen, NF, K, scale=K ** -0.5), _randn(gen, NF, scale=0.5)
    (h, y), (h2, y2) = mlp._kernel(x, w, b, write_h), mlp._kernel(x, w, b, write_h)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, fc1_gelu_reference(x, w, b), **FC1_TOL)
    assert torch.equal(y, y2)
    if write_h:
        torch.testing.assert_close(h, torch.matmul(x, w.t()) + b, **FC1_TOL)
        assert torch.equal(h, h2)
    else:
        assert h is None


@pytest.mark.parametrize("M, K, NF", GEMM_SHAPES + [(12608, 2304, 768)])
@torch.inference_mode()
def test_matmul_nt_tiles_match_plain_and_rerun_equal(gen, M, K, NF):
    # The bare product other kernels' phases call (attention_block.cu's dx, the
    # last shape): the same kernel as fc1+GELU with a bare epilogue.
    from ssl4polyp_tpu_torch.ops._build import library

    x, w = _randn(gen, M, K), _randn(gen, NF, K, scale=K ** -0.5)
    outs = [torch.empty((M, NF), dtype=x.dtype, device="cuda") for _ in range(2)]
    for y in outs:
        err = library().ssl4polyp_matmul_nt(x.data_ptr(), w.data_ptr(), y.data_ptr(), M, K, NF,
                                            torch.cuda.current_stream().cuda_stream)
        assert err == 0
    torch.cuda.synchronize()
    # One rounding of the fp32 sum on both sides: a bf16 ulp where it flips.
    torch.testing.assert_close(outs[0], torch.matmul(x, w.t()), **FUSED_TOL)
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("M, K, NF", GEMM_SHAPES + [(64 * 577, 768, 768), (4 * 577, 512, 512)])
@torch.inference_mode()
def test_matmul_nt_bias_rounds_the_product_before_the_bias(gen, M, K, NF):
    # The same GEMM with the bias in its epilogue (attn_proj.cu's y past 256
    # tokens): y = round(round(x . w^T) + b).  On small integers every sum
    # is exact, so the result is bit-equal to the bare product's plus the
    # bias, rounded again; on random inputs one ulp where a rounding flips.
    from ssl4polyp_tpu_torch.ops._build import library

    lib, stream = library(), torch.cuda.current_stream().cuda_stream
    for integers in (True, False):
        if integers:
            g = torch.Generator(device="cuda").manual_seed(M + K + NF)
            x, w = (torch.randint(-3, 4, shape, generator=g, device="cuda").to(torch.bfloat16)
                    for shape in ((M, K), (NF, K)))
            b = torch.randint(-300, 300, (NF,), generator=g, device="cuda").to(torch.bfloat16) / 8
        else:
            x, w, b = _randn(gen, M, K), _randn(gen, NF, K, scale=K ** -0.5), _randn(gen, NF)
        bare, y, y2 = (torch.empty((M, NF), dtype=x.dtype, device="cuda") for _ in range(3))
        assert lib.ssl4polyp_matmul_nt(x.data_ptr(), w.data_ptr(), bare.data_ptr(), M, K, NF,
                                       stream) == 0
        for out in (y, y2):
            assert lib.ssl4polyp_matmul_nt_bias(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                                out.data_ptr(), M, K, NF, stream) == 0
        torch.cuda.synchronize()
        assert torch.equal(y, bare + b)  # the bf16 add rounds the fp32 sum once
        assert torch.equal(y, y2)
        if integers:
            assert torch.equal(bare, torch.matmul(x.float(), w.float().t()).to(torch.bfloat16))
        else:
            torch.testing.assert_close(y, torch.matmul(x, w.t()) + b, **FUSED_TOL)


@pytest.mark.parametrize("softmax_f32", [True, False])
@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("hd", [16, 32, 64])
@pytest.mark.parametrize("N", [1, 50, 65, 197, 208, 256])
@torch.inference_mode()
def test_attention_forward_tiles_match_plain_and_rerun_equal(gen, N, hd, with_bias, softmax_f32):
    # Every key-tile count the kernel is built for, the lengths at their
    # edges, keys past valid_len masked: one block a head, its warps taking
    # the 16-row query tiles in turn.
    B, H = 3, 2
    valid_len = max(1, N - 7)
    qkv = _randn(gen, B, N, 3 * H * hd)
    bias = _randn(gen, 3 * H * hd, scale=0.5) if with_bias else None
    out = fused_qkv_attention(qkv, H, softmax_f32, valid_len, bias)
    again = fused_qkv_attention(qkv, H, softmax_f32, valid_len, bias)
    torch.cuda.synchronize()
    ref = fused_qkv_attention_reference(qkv, H, softmax_f32, valid_len, bias)
    torch.testing.assert_close(out, ref, **ATTENTION_TOL)
    assert torch.equal(out, again)
    whole = fused_qkv_attention(qkv, H, softmax_f32, None, bias)
    torch.testing.assert_close(whole, fused_qkv_attention_reference(qkv, H, softmax_f32, None, bias),
                               **ATTENTION_TOL)
