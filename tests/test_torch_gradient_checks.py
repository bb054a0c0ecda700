"""The backward kernels' wrappers refuse an incoming gradient they cannot copy.

Each backward kernel reads its incoming gradient in 16-byte ``cp.async``
pieces from its own device.  A strided gradient, or one that starts two
bytes into its storage, must be refused with ``ValueError`` before anything
is allocated or built: on the card it would fault and lose the context.
These run on the CPU, with the library build replaced by a failure.
"""

import pytest
import torch

from ssl4polyp_tpu_torch.ops import _build, attention, attention_block, attn_proj, layernorm

BF16 = torch.bfloat16


def _strided(shape):
    return torch.zeros((*shape[:-1], 2 * shape[-1]), dtype=BF16)[..., ::2]


def _misaligned(shape):
    flat = torch.zeros(torch.Size(shape).numel() + 1, dtype=BF16)
    view = flat[1:].view(shape)
    assert view.is_contiguous() and view.data_ptr() % 16 == 2
    return view


def _attention(bad):
    q = torch.zeros((1, 2, 8, 16), dtype=BF16)
    attention._backward_kernel(q, q, q, bad(q.shape))


def _attention_block(bad):
    x, w, b = (torch.zeros((1, 8, 32), dtype=BF16), torch.zeros((32, 96), dtype=BF16),
               torch.zeros(96, dtype=BF16))
    attention_block._backward_kernel(x, w, b, bad((1, 8, 32)), 2, True, None)


def _attn_proj(bad):
    qkv, w, b = (torch.zeros((1, 8, 96), dtype=BF16), torch.zeros((32, 32), dtype=BF16),
                 torch.zeros(32, dtype=BF16))
    attn_proj._backward_plan(qkv, w, b, bad((1, 8, 32)), 2, True, None)


def _layernorm_dy(bad):
    x, weight = torch.zeros((4, 64), dtype=BF16), torch.ones(64)
    layernorm._backward_plan(x, bad(x.shape), weight, 1e-6)


def _layernorm_dres(bad):
    x, weight = torch.zeros((4, 64), dtype=BF16), torch.ones(64)
    layernorm._backward_plan(x, torch.zeros_like(x), weight, 1e-6, bad(x.shape))


@pytest.mark.parametrize("bad", [_strided, _misaligned], ids=["strided", "misaligned"])
@pytest.mark.parametrize("call", [_attention, _attention_block, _attn_proj, _layernorm_dy,
                                  _layernorm_dres],
                         ids=["attention", "attention_block", "attn_proj", "layernorm_dy",
                              "layernorm_dres"])
def test_backward_wrappers_refuse_a_gradient_the_kernel_cannot_copy(monkeypatch, call, bad):
    def no_build():
        raise AssertionError("the library was asked for before the gradient was checked")

    monkeypatch.setattr(_build, "library", no_build)
    with pytest.raises(ValueError, match="16-byte aligned"):
        call(bad)


def test_backward_wrappers_refuse_a_gradient_of_another_shape(monkeypatch):
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("built before the check"))
    with pytest.raises(ValueError, match="does not fit"):
        _layernorm_dy(lambda shape: torch.zeros((shape[0], shape[1] + 8), dtype=BF16))
    with pytest.raises(ValueError, match="does not fit"):
        _attn_proj(lambda shape: torch.zeros(shape, dtype=torch.float32))
