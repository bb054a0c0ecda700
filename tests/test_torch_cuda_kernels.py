"""The CUDA kernels against their plain torch versions, on the card.

These tests need an NVIDIA GPU and nvcc; elsewhere they skip.  Run them on
the card with ``python -m pytest tests/test_torch_cuda_kernels.py -q``.
"""

import pytest
import torch

from ssl4polyp_tpu_torch import ops
from ssl4polyp_tpu_torch.ops.mlp import fc1_gelu, fc1_gelu_reference
from ssl4polyp_tpu_torch.ops.qkv_attention import (
    fused_qkv_attention,
    fused_qkv_attention_reference,
)

pytestmark = pytest.mark.cuda

# bf16 outputs; the plain versions round at the same points except the plain
# fc1, which rounds h before the GELU: 1-2 bf16 ulps (see chip_smoke.py).
ATTENTION_TOL = dict(atol=1e-2, rtol=1e-2)
FC1_TOL = dict(atol=1e-2, rtol=1.6e-2)


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
    with pytest.raises(NotImplementedError):
        fused_qkv_attention(qkv.requires_grad_(), 2)
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
    w.requires_grad_()
    with pytest.raises(NotImplementedError):
        fc1_gelu(x, w, b)
