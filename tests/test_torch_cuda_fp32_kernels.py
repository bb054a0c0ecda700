"""The fp32 kernels against their plain fp32 versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  Run them on
the card with ``python -m pytest tests/test_torch_cuda_fp32_kernels.py -q``.
"""

import pytest
import torch

from ssl4polyp_tpu_torch import ops
from ssl4polyp_tpu_torch.ops import (attention, attention_block, attn_proj, layernorm, ln_linear,
                                     mlp, qkv_attention)

pytestmark = pytest.mark.cuda

# max |kernel - plain| as a fraction of max |plain|: the plain versions make
# the same fp32 arithmetic in another summation order (about 1e-6); a TF32 or
# bf16 product would miss by more than an order of magnitude.  The reasons
# are stated beside chip_smoke.py's FP32_FWD_FRAC and FP32_GRAD_FRAC.
FWD_FRAC = 2e-5
GRAD_FRAC = 1e-4


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, *shape, scale=1.0):
    return torch.randn(*shape, generator=gen, device="cuda") * scale


def _assert_close(got, want, frac, what):
    assert got.dtype == torch.float32, what
    err = (got - want).abs().max().item() / max(want.abs().max().item(), 1e-30)
    assert err <= frac, f"{what}: {err:.3e} of max |plain|"


@pytest.mark.parametrize(
    "B, N, H, hd, valid_len, with_bias",
    [
        (3, 197, 12, 64, None, True),   # the classifier's
        (3, 197, 16, 32, 150, True),    # the MAE decoder's
        (3, 50, 12, 64, None, False),   # the MAE encoder's
        (2, 1, 4, 64, None, True),
        (2, 256, 4, 32, 255, False),
        (2, 577, 12, 64, 500, True),    # ViT-B/16 at 384 px, past the bf16 kernels' 256
        (2, 300, 16, 32, None, False),
    ],
)
def test_attention_kernels_match_plain(gen, B, N, H, hd, valid_len, with_bias):
    qkv = _randn(gen, B, N, 3 * H * hd).requires_grad_()
    bias = _randn(gen, 3 * H * hd, scale=0.5).requires_grad_() if with_bias else None
    dout = _randn(gen, B, N, H * hd)
    ops.reset_launch_counts()
    out = qkv_attention.fused_qkv_attention(qkv, H, True, valid_len, bias)
    out.backward(dout)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["fused_qkv_attention_f32"] == counts["fused_qkv_attention_backward_f32"] == 1
    assert sum(counts.values()) == 2
    leaves = [qkv.detach()] + ([] if bias is None else [bias.detach()])
    ref = qkv_attention.fused_qkv_attention_reference(
        leaves[0], H, True, valid_len, None if bias is None else leaves[1])
    ref_dqkv, ref_dbias = qkv_attention.fused_qkv_attention_backward_reference(
        leaves[0], dout, H, True, valid_len, None if bias is None else leaves[1])
    _assert_close(out.detach(), ref, FWD_FRAC, "out")
    _assert_close(qkv.grad, ref_dqkv, GRAD_FRAC, "dqkv")
    if with_bias:
        _assert_close(bias.grad, ref_dbias, GRAD_FRAC, "dbias")
    again = qkv_attention._backward_kernel(qkv.detach(), dout, H, True, valid_len,
                                           None if bias is None else bias.detach())
    assert torch.equal(again[0], qkv.grad)  # no atomics
    if with_bias:
        assert torch.equal(again[1], bias.grad)


# The tiles' edges (64 query rows and 64 keys a tile): rows and keys one
# short of, at and one past a tile, key tiles that end at valid_len.
@pytest.mark.parametrize("N, valid_len", [(63, None), (64, None), (65, 64), (128, 65),
                                          (129, 1), (193, 128), (200, 63)])
@pytest.mark.parametrize("hd", [32, 64])
def test_attention_kernels_at_tile_edges(gen, N, valid_len, hd):
    H, with_bias = 3, N % 2 == 1
    qkv = _randn(gen, 2, N, 3 * H * hd)
    bias = _randn(gen, 3 * H * hd, scale=0.5) if with_bias else None
    dout = _randn(gen, 2, N, H * hd)
    out, lse = qkv_attention._forward_kernel(qkv, H, True, valid_len, bias, lse=True)
    dqkv, dbias = qkv_attention._backward_kernel(qkv, dout, H, True, valid_len, bias, out=out,
                                                 lse=lse)
    torch.cuda.synchronize()
    _assert_close(out, qkv_attention.fused_qkv_attention_reference(qkv, H, True, valid_len, bias),
                  FWD_FRAC, "out")
    ref_dqkv, ref_dbias = qkv_attention.fused_qkv_attention_backward_reference(
        qkv, dout, H, True, valid_len, bias)
    _assert_close(dqkv, ref_dqkv, GRAD_FRAC, "dqkv")
    if with_bias:
        _assert_close(dbias, ref_dbias, GRAD_FRAC, "dbias")
    # Each row's log-sum-exp over its weighted keys, from the plain scores.
    x = qkv if bias is None else qkv + bias
    q, k, _ = x.reshape(2, N, 3, H, hd).permute(2, 0, 3, 1, 4)
    scores = torch.matmul(q * qkv_attention._scale(hd, torch.float32), k.transpose(-1, -2))
    want = torch.logsumexp(scores[..., :valid_len or N], dim=-1)
    _assert_close(lse, want, FWD_FRAC, "lse")


@pytest.mark.parametrize("M, K, NF", [(12608, 768, 3072), (3200, 512, 2048), (37, 64, 24),
                                      (1, 8, 8)])
@torch.inference_mode()
def test_fc1_gelu_kernel_matches_plain(gen, M, K, NF):
    x, w, b = _randn(gen, M, K), _randn(gen, NF, K, scale=K ** -0.5), _randn(gen, NF, scale=0.5)
    ops.reset_launch_counts()
    h, y = mlp._kernel(x, w, b, write_h=True)
    y_only = mlp.fc1_gelu(x, w, b)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fc1_gelu_f32"] == 2 and ops.launch_counts()["fc1_gelu"] == 0
    _assert_close(y, mlp.fc1_gelu_reference(x, w, b), FWD_FRAC, "y")
    _assert_close(h, torch.matmul(x, w.t()) + b, FWD_FRAC, "h")
    assert torch.equal(y, y_only)


@pytest.mark.parametrize("M, D", [(12608, 768), (12608, 512), (3200, 768), (5, 1536)])
def test_layernorm_kernels_match_plain(gen, M, D):
    x, dy, dres = _randn(gen, M, D), _randn(gen, M, D), _randn(gen, M, D)
    w, b = 1.0 + 0.1 * _randn(gen, D), 0.1 * _randn(gen, D)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    ops.reset_launch_counts()
    y = layernorm.layernorm(*leaves)
    y.backward(dy)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["layernorm_f32"] == counts["layernorm_backward_f32"] == 1
    ref_leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    ref = layernorm.layernorm_reference(*ref_leaves)
    ref.backward(dy)
    _assert_close(y.detach(), ref.detach(), FWD_FRAC, "y")
    for name, got, want in zip(("dx", "dweight", "dbias"), leaves, ref_leaves):
        _assert_close(got.grad, want.grad, GRAD_FRAC, name)
    got = layernorm._backward_kernel(x, dy, w, 1e-6, dres)
    want = ln_linear.layernorm_backward(x, w, dy, 1e-6, True, dres)
    for name, a, r in zip(("dx + dres", "dweight", "dbias"), got, want):
        _assert_close(a, r, GRAD_FRAC, name)


# The fused MLPs in fp32 (csrc/mlp_fused_f32.cu): ViT-B's and the MAE
# decoder's widths at the classifier's 12608 rows, then ragged row blocks
# (M 37) with a last NF chunk of 32 and of 96 columns.
@pytest.mark.parametrize("M, K, NF", [(12608, 768, 3072), (12608, 512, 2048), (37, 768, 160),
                                      (37, 512, 96)])
@pytest.mark.parametrize("with_ln", [False, True], ids=["mlp_fused", "mlp_ln_fused"])
@torch.inference_mode()
def test_fused_mlp_kernels_match_plain(gen, M, K, NF, with_ln):
    x = _randn(gen, M, K, scale=2.0) + 0.5
    w1, b1 = _randn(gen, NF, K, scale=K ** -0.5), _randn(gen, NF, scale=0.5)
    w2, b2 = _randn(gen, K, NF, scale=NF ** -0.5), _randn(gen, K, scale=0.5)
    s, t = (1.0 + 0.1 * _randn(gen, K), 0.1 * _randn(gen, K)) if with_ln else (None, None)
    eps = 1e-6 if with_ln else 0.0
    ops.reset_launch_counts()
    h, out = mlp._fused_kernel(x, s, t, w1, b1, w2, b2, eps, write_h=True)
    h2, out2 = mlp._fused_kernel(x, s, t, w1, b1, w2, b2, eps, write_h=True)
    no_h, out_alone = mlp._fused_kernel(x, s, t, w1, b1, w2, b2, eps, write_h=False)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    name = "mlp_ln_fused" if with_ln else "mlp_fused"
    assert counts[name + "_f32"] == 3 and sum(counts.values()) == 3
    ref_h, ref = mlp._mlp_forward_plain(x, s, t, w1, b1, w2, b2, eps)
    _assert_close(out, ref, FWD_FRAC, "out")
    _assert_close(h, ref_h, FWD_FRAC, "h")
    assert no_h is None
    assert torch.equal(out, out2) and torch.equal(h, h2) and torch.equal(out, out_alone)


@pytest.mark.parametrize("with_ln", [False, True], ids=["mlp_fused", "mlp_ln_fused"])
def test_fused_mlp_wrappers_train_in_fp32(gen, with_ln):
    """The public wrappers on the card in fp32: the kernel forward saving h,
    then the backward's cuBLAS products (TF32 off) and, for the LN variant,
    the fp32 LayerNorm kernels; every gradient against the plain version's."""
    M, K, NF = 394, 768, 3072
    x = _randn(gen, M, K)
    leaves = [x, _randn(gen, NF, K, scale=K ** -0.5), _randn(gen, NF, scale=0.5),
              _randn(gen, K, NF, scale=NF ** -0.5), _randn(gen, K, scale=0.5)]
    if with_ln:
        leaves[1:1] = [1.0 + 0.1 * _randn(gen, K), 0.1 * _randn(gen, K)]
    dy = _randn(gen, M, K)
    ours = [t.clone().requires_grad_() for t in leaves]
    plain = [t.clone().requires_grad_() for t in leaves]
    run, run_plain = ((mlp.mlp_ln_fused, mlp.mlp_ln_fused_plain) if with_ln
                      else (mlp.mlp_fused, mlp.mlp_fused_plain))
    ops.reset_launch_counts()
    out = run(*ours)
    out.backward(dy)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    name = "mlp_ln_fused_f32" if with_ln else "mlp_fused_f32"
    # The LN variant's backward: the normalised row again, then its backward.
    want = {name: 1, "layernorm_f32": 1, "layernorm_backward_f32": 1} if with_ln else {name: 1}
    assert {n: c for n, c in counts.items() if c} == want
    ref = run_plain(*plain)
    ref.backward(dy)
    _assert_close(out.detach(), ref.detach(), FWD_FRAC, "out")
    for i, (a, b) in enumerate(zip(ours, plain)):
        _assert_close(a.grad, b.grad, GRAD_FRAC, f"gradient {i}")


# LN+QKV in fp32 (csrc/ln_linear_f32.cu): ViT-B's and the MAE decoder's QKV
# at 12608 rows, then ragged tiles (M 37, N 24) and K 576, not a multiple of
# the statistics' 128-column pieces.
@pytest.mark.parametrize("M, K, N", [(12608, 768, 2304), (12608, 512, 1536), (37, 64, 24),
                                     (130, 576, 136)])
def test_ln_linear_kernel_matches_plain(gen, M, K, N):
    x = _randn(gen, M, K, scale=2.0) + 0.5
    s, t = 1.0 + 0.1 * _randn(gen, K), 0.1 * _randn(gen, K)
    w, b = _randn(gen, N, K, scale=K ** -0.5), _randn(gen, N, scale=0.5)
    leaves = [u.clone().requires_grad_() for u in (x, s, t, w, b)]
    dy = _randn(gen, M, N)
    ops.reset_launch_counts()
    out = ln_linear.ln_linear(*leaves)
    out.backward(dy)
    again = ln_linear._kernel(x, s, t, w, b, 1e-6)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert {n: c for n, c in counts.items() if c} == {
        "ln_linear_f32": 2, "layernorm_f32": 1, "layernorm_backward_f32": 1}
    plain = [u.clone().requires_grad_() for u in (x, s, t, w, b)]
    ref = ln_linear.ln_linear_plain(*plain)
    ref.backward(dy)
    _assert_close(out.detach(), ref.detach(), FWD_FRAC, "out")
    assert torch.equal(out.detach(), again)
    for name, a, r in zip(("dx", "ds", "dt", "dw", "db"), leaves, plain):
        _assert_close(a.grad, r.grad, GRAD_FRAC, name)


# The attention+projection fold in fp32 (csrc/attn_proj_f32.cu), through the
# public wrapper forward and backward: the classifier's and the MAE
# decoder's shapes, valid_len below N (the pad rows' upstream gradient zero),
# one token, 300 tokens (past the bf16 kernels' 256), hd 32 with an odd head
# count, and B * N rows that are not a multiple of 8 (the split-K slices'
# ragged end).
@pytest.mark.parametrize("B, N, H, hd, valid_len", [
    (3, 197, 12, 64, None),   # the classifier's
    (3, 197, 16, 32, None),   # the MAE decoder's
    (3, 197, 12, 64, 150),
    (2, 1, 4, 64, None),
    (2, 300, 8, 32, 280),
    (3, 61, 5, 32, None),
])
def test_attn_proj_kernels_match_plain(gen, B, N, H, hd, valid_len):
    D = H * hd
    qkv, dy = _randn(gen, B, N, 3 * D), _randn(gen, B, N, D)
    w, b = _randn(gen, D, D, scale=D ** -0.5), _randn(gen, D, scale=0.5)
    dy[:, valid_len or N:] = 0
    leaves = [t.clone().requires_grad_() for t in (qkv, w, b)]
    ops.reset_launch_counts()
    y = attn_proj.fused_attention_proj(*leaves, H, True, valid_len)
    y.backward(dy)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert {n: c for n, c in counts.items() if c} == {"attn_proj_f32": 1,
                                                      "attn_proj_backward_f32": 1}
    ref = attn_proj.fused_attention_proj_reference(qkv, w, b, H, True, valid_len)
    ref_grads = attn_proj.fused_attention_proj_backward_reference(qkv, w, b, dy, H, True,
                                                                  valid_len)
    _assert_close(y.detach(), ref, FWD_FRAC, "y")
    for name, leaf, want in zip(("dqkv", "dw", "db"), leaves, ref_grads):
        _assert_close(leaf.grad, want, GRAD_FRAC, name)
    # Reruns, and the backward's launch from (qkv, w, b, dy) alone, which
    # runs the attention forward first: the same bits (no atomics).
    again = attn_proj._backward_kernel(qkv, w, b, dy, H, True, valid_len)
    assert all(torch.equal(a, leaf.grad) for a, leaf in zip(again, leaves))
    assert torch.equal(attn_proj._forward_kernel(qkv, w, b, H, True, valid_len), y.detach())


# The QKV projection with the attention core in fp32
# (csrc/attention_block_f32.cu), through the public wrapper: the same cases,
# at Din 768, 512 and narrower widths.
@pytest.mark.parametrize("B, N, Din, H, hd, valid_len", [
    (3, 197, 768, 12, 64, None),   # the classifier's
    (3, 197, 512, 16, 32, None),   # the MAE decoder's
    (3, 197, 768, 12, 64, 150),
    (2, 1, 128, 4, 64, None),
    (2, 300, 256, 8, 32, 280),
    (3, 61, 192, 5, 32, None),
])
def test_qkvproj_attention_kernels_match_plain(gen, B, N, Din, H, hd, valid_len):
    D = H * hd
    x, dout = _randn(gen, B, N, Din), _randn(gen, B, N, D)
    w, b = _randn(gen, Din, 3 * D, scale=Din ** -0.5), _randn(gen, 3 * D, scale=0.5)
    dout[:, valid_len or N:] = 0
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    ops.reset_launch_counts()
    out = attention_block.fused_qkvproj_attention(*leaves, H, True, valid_len)
    out.backward(dout)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert {n: c for n, c in counts.items() if c} == {
        "fused_qkvproj_attention_f32": 1, "fused_qkvproj_attention_backward_f32": 1}
    ref = attention_block.fused_qkvproj_attention_reference(x, w, b, H, True, valid_len)
    ref_grads = attention_block.fused_qkvproj_attention_backward_reference(
        x, w, b, dout, H, True, valid_len)
    _assert_close(out.detach(), ref, FWD_FRAC, "out")
    for name, leaf, want in zip(("dx", "dw", "db"), leaves, ref_grads):
        _assert_close(leaf.grad, want, GRAD_FRAC, name)
    again = attention_block._backward_kernel(x, w, b, dout, H, True, valid_len)
    assert all(torch.equal(a, leaf.grad) for a, leaf in zip(again, leaves))
    assert torch.equal(attention_block._forward_kernel(x, w, b, H, True, valid_len),
                       out.detach())


@pytest.mark.parametrize("N, valid_len", [(61, None), (197, 150)])
@pytest.mark.parametrize("hd", [32, 64])
def test_attention_backward_in_the_scaled_ds_mode_matches_plain(gen, N, valid_len, hd):
    H = 3
    qkv, bias = _randn(gen, 2, N, 3 * H * hd), _randn(gen, 3 * H * hd, scale=0.5)
    dout = _randn(gen, 2, N, H * hd)
    dqkv, dbias = qkv_attention._backward_kernel(qkv, dout, H, True, valid_len, bias,
                                                 scaled_ds=True)
    torch.cuda.synchronize()
    ref_dqkv, ref_dbias = qkv_attention.fused_qkv_attention_backward_reference(
        qkv, dout, H, True, valid_len, bias, scaled_ds=True)
    _assert_close(dqkv, ref_dqkv, GRAD_FRAC, "dqkv")
    _assert_close(dbias, ref_dbias, GRAD_FRAC, "dbias")


def test_bf16_only_wrappers_refuse_fp32_on_the_card(gen):
    # No wrapper is bf16-only any longer: attention over separate q, k, v
    # computes fp32 on its fp32 kernels (ROADMAP.md §2a, item 2b); what it
    # refuses in fp32 is a head dim those kernels do not take (item 4).
    q = _randn(gen, 1, 2, 8, 64)
    with torch.inference_mode():
        ops.reset_launch_counts()
        out = attention.fused_attention(q, q, q)
        torch.cuda.synchronize()
        assert out.dtype == torch.float32 and ops.launch_counts()["fused_attention_f32"] == 1
        _assert_close(out, attention.fused_attention_reference(q, q, q), FWD_FRAC, "out")
        q = _randn(gen, 1, 2, 8, 16)
        with pytest.raises(ValueError, match=r"ROADMAP.md §2a, item 4"):
            attention.fused_attention(q, q, q)


# Attention over separate q, k, v in fp32 (qkv_attention_f32.cu in its
# layout, the scale inside dS): every edge of its 64-row tiles, past 256
# tokens, the classifier's and the MAE decoder's heads.
def _assert_grads_close(grads, wants, frac):
    """dq, dk and dv against their plain versions, each max error as a
    fraction of the largest plain gradient, as the fused layout's dqkv is
    held (test_attention_kernels_match_plain).  At one token the plain dq and
    dk are exactly zero (W = 1 and tmp = dW, so dS = 0), while the kernel
    takes tmp as dO . O, equal to dW in another summation order: their own
    max would make that rounding of order 1e-7 an infinite error."""
    scale = max(want.abs().max().item() for want in wants)
    for name, got, want in zip(("dq", "dk", "dv"), grads, wants):
        assert got.dtype == torch.float32, name
        err = (got - want).abs().max().item() / max(scale, 1e-30)
        assert err <= frac, f"{name}: {err:.3e} of max |plain| over dq, dk, dv"


_SEPARATE_F32 = ([(2, 3, n, hd) for n in (1, 63, 64, 65, 197, 256, 257, 300, 577, 1025)
                  for hd in (32, 64)] + [(3, 12, 197, 64), (3, 16, 197, 32), (2, 12, 577, 64)])


@pytest.mark.parametrize("B, H, N, hd", _SEPARATE_F32)
def test_separate_attention_fp32_kernels_match_plain(gen, B, H, N, hd):
    q, k, v, dout = (_randn(gen, B, H, N, hd) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launch_counts()
    out = attention.fused_attention(*leaves)
    out.backward(dout)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["fused_attention_f32"] == counts["fused_attention_backward_f32"] == 1
    assert sum(counts.values()) == 2
    _assert_close(out.detach(), attention.fused_attention_reference(q, k, v), FWD_FRAC, "out")
    _assert_grads_close([leaf.grad for leaf in leaves],
                        attention.fused_attention_backward_reference(q, k, v, dout), GRAD_FRAC)
    # Reruns bit-identical, and the backward from (q, k, v, dout) alone (its
    # launch runs the forward first) gives the autograd path's bits.
    with torch.inference_mode():
        again = attention._forward_kernel(q, k, v)
        alone = attention._backward_kernel(q, k, v, dout)
    assert torch.equal(again, out.detach())
    assert all(torch.equal(a, leaf.grad) for a, leaf in zip(alone, leaves))


@pytest.mark.parametrize("N, hd", [(1, 32), (65, 64), (197, 32), (577, 64)])
@torch.inference_mode()
def test_separate_attention_fp32_writes_nothing_past_the_last_row(gen, N, hd):
    # The C entry points on views inside sentinel-filled buffers: nothing
    # before the outputs or past the last head's row N - 1 changes, and NaN
    # past the inputs' last row does not reach them.
    from ssl4polyp_tpu_torch.ops._build import library

    B, H, pad = 2, 3, 4096
    size = B * H * N * hd

    def inside(fill, body=None, rows=size):
        buffer = torch.full((pad + rows + pad,), fill, device="cuda")
        if body is not None:
            buffer[pad:pad + rows] = body.reshape(-1)
        return buffer, buffer[pad:pad + rows]

    q, k, v, dout = (_randn(gen, B, H, N, hd) for _ in range(4))
    views = [inside(float("nan"), t)[1] for t in (q, k, v, dout)]
    outputs = [inside(-1234.0) for _ in range(4)]
    lse = inside(-1234.0, rows=B * H * N)
    delta = torch.full((B, H, N), float("nan"), device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    scale = 1.0 / hd ** 0.5
    assert library().ssl4polyp_attention_fwd_f32(
        *(t.data_ptr() for t in views[:3]), outputs[0][1].data_ptr(), lse[1].data_ptr(), B, H, N,
        hd, scale, stream) == 0
    assert library().ssl4polyp_attention_bwd_f32(
        *(t.data_ptr() for t in views), outputs[0][1].data_ptr(), lse[1].data_ptr(),
        delta.data_ptr(), *(out.data_ptr() for _, out in outputs[1:]), B, H, N, hd, scale, 0,
        stream) == 0
    torch.cuda.synchronize()
    for name, (buffer, _) in zip(("out", "dq", "dk", "dv"), outputs):
        assert (buffer[:pad] == -1234.0).all() and (buffer[pad + size:] == -1234.0).all(), name
    got = [out.view(B, H, N, hd) for _, out in outputs]
    _assert_close(got[0], attention.fused_attention_reference(q, k, v), FWD_FRAC, "out")
    _assert_grads_close(got[1:], attention.fused_attention_backward_reference(q, k, v, dout),
                        GRAD_FRAC)
    assert (lse[0][:pad] == -1234.0).all() and (lse[0][pad + B * H * N:] == -1234.0).all()
    assert torch.isfinite(lse[1]).all()


def test_dense_fp32_gradients_do_not_take_tf32(gen):
    """The fp32 dense model (ViT-B/16 taps -> DPT, batch 2): its gradients are
    bit-equal under torch's default ``cudnn.allow_tf32`` (True) and with it
    off, and the backward leaves the flag as it found it.  cuDNN's own
    deterministic mode holds for both runs, so that only TF32 could part
    them."""
    import numpy as np

    from ssl4polyp_tpu_torch.models.factory import build_classifier

    dense = build_classifier(torch.Generator().manual_seed(0),
                             {"dense": True, "dense_readout": "project"}, device="cuda",
                             compute_dtype=torch.float32)
    images = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (2, 224, 224, 3), dtype=np.uint8)).cuda()
    params = dict(dense.model.named_parameters())
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic
    runs = []
    try:
        torch.backends.cudnn.deterministic = True
        for allow in (True, False):
            torch.backends.cudnn.allow_tf32 = allow
            dense.model.zero_grad(set_to_none=True)
            dense.model(images.float() / 255.0).square().mean().backward()
            torch.cuda.synchronize()
            assert torch.backends.cudnn.allow_tf32 is allow
            runs.append({n: p.grad.clone() for n, p in params.items() if p.grad is not None})
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic = saved
    assert runs[0].keys() == runs[1].keys() and any(n.startswith("dpt.") for n in runs[0])
    assert [n for n in runs[0] if not torch.equal(runs[0][n], runs[1][n])] == []
