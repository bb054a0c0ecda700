"""The fp32 kernels against their plain fp32 versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  Run them on
the card with ``python -m pytest tests/test_torch_cuda_fp32_kernels.py -q``.
"""

import pytest
import torch

from ssl4polyp_tpu_torch import ops
from ssl4polyp_tpu_torch.ops import attn_proj, layernorm, ln_linear, mlp, qkv_attention

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


def test_bf16_only_wrappers_refuse_fp32_on_the_card(gen):
    x, w1, b1 = _randn(gen, 4, 512), _randn(gen, 64, 512), _randn(gen, 64)
    w2, b2 = _randn(gen, 512, 64), _randn(gen, 512)
    s, t = torch.ones(512, device="cuda"), torch.zeros(512, device="cuda")
    qkv, w, b = _randn(gen, 1, 8, 384), _randn(gen, 128, 128), _randn(gen, 128)
    with torch.inference_mode():
        for call in (lambda: mlp.mlp_fused(x, w1, b1, w2, b2),
                     lambda: mlp.mlp_ln_fused(x, s, t, w1, b1, w2, b2),
                     lambda: ln_linear.ln_linear(x, s, t, w1, b1),
                     lambda: attn_proj.fused_attention_proj(qkv, w, b, 2)):
            with pytest.raises(TypeError, match=r"not yet ported \(ROADMAP.md §2a, item 1\)"):
                call()
