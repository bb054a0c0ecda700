"""The port's plain LayerNorm against the JAX Pallas kernels (interpret mode).

Forward and vjp (dx, dscale, dbias), 3-D and 2-D, fp32 and bf16; inputs made
with numpy from a seed and handed to both frameworks.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.ops.layernorm import layernorm_fused_bwd, layernorm_fused_view
from ssl4polyp_tpu_torch.ops import _build
from ssl4polyp_tpu_torch.ops import layernorm as layernorm_module
from ssl4polyp_tpu_torch.ops.layernorm import layernorm, layernorm_reference
from ssl4polyp_tpu_torch.ops.ln_linear import layernorm_backward

EPS = 1e-6
# fp32 on both sides, the same two-pass statistics: summation order only.
F32_TOL = 2e-5
# bf16 x, y, dy and dx: each side rounds its fp32 result once, so a rounding
# that flips on an fp32 order difference is one bf16 ulp, 2^-8 relative;
# dscale and dbias stay fp32 sums of the same bf16 products.
BF16_TOL = 1e-2
BF16_PARAM_TOL = 1e-4


def _inputs(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    D = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    dy = rng.standard_normal(shape).astype(np.float32)
    scale = (1 + 0.2 * rng.standard_normal(D)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(D)).astype(np.float32)
    if dtype == "bf16":  # both sides see the same bf16 values
        x = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
        dy = np.array(jnp.asarray(dy, jnp.bfloat16).astype(jnp.float32))
    return x, dy, scale, bias


def _jax(fn, x, dy, scale, bias, dtype):
    jdt = jnp.float32 if dtype == "fp32" else jnp.bfloat16
    y, vjp = jax.vjp(lambda a, s, b: fn(a, s, b, EPS, True),
                     jnp.asarray(x, jdt), jnp.asarray(scale), jnp.asarray(bias))
    grads = vjp(jnp.asarray(dy, jdt))
    return [np.asarray(t.astype(jnp.float32)) for t in (y, *grads)]


def _torch(x, dy, scale, bias, dtype):
    tdt = torch.float32 if dtype == "fp32" else torch.bfloat16
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    st = torch.from_numpy(scale).requires_grad_()
    bt = torch.from_numpy(bias).requires_grad_()
    y = layernorm(xt, st, bt, EPS)
    y.backward(torch.from_numpy(dy).to(tdt))
    assert y.dtype == tdt and xt.grad.dtype == tdt and st.grad.dtype == torch.float32
    return [t.detach().float().numpy() for t in (y, xt.grad, st.grad, bt.grad)]


def _assert_close(ours, ref, dtype):
    names = ("y", "dx", "dscale", "dbias")
    for name, a, b in zip(names, ours, ref):
        if dtype == "fp32":
            tol = F32_TOL
        else:
            tol = BF16_PARAM_TOL if name in ("dscale", "dbias") else BF16_TOL
        scale = 1.0 if name in ("y", "dx") else max(1.0, float(np.abs(b).max()))
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(4, 13, 64), (3, 50, 32), (64, 96), (24, 40)],
                         ids=["3d", "3d-encoder-tokens", "2d", "2d-small"])
def test_reference_matches_jax_kernel(shape, dtype):
    x, dy, scale, bias = _inputs(0, shape, dtype)
    _assert_close(_torch(x, dy, scale, bias, dtype),
                  _jax(layernorm_fused_bwd, x, dy, scale, bias, dtype), dtype)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_reference_matches_jax_fused_view(dtype):
    # layernorm_fused_view runs the kernel on a permuted view of the rows;
    # the port's one row kernel (and its plain version) covers it because
    # LayerNorm does not depend on the order of the rows.
    x, dy, scale, bias = _inputs(1, (4, 6, 32), dtype)
    _assert_close(_torch(x, dy, scale, bias, dtype),
                  _jax(layernorm_fused_view, x, dy, scale, bias, dtype), dtype)


def test_cpu_wrapper_is_the_reference():
    x, _, scale, bias = _inputs(2, (3, 5, 16), "bf16")
    xt = torch.from_numpy(x).to(torch.bfloat16)
    st, bt = torch.from_numpy(scale), torch.from_numpy(bias)
    torch.testing.assert_close(layernorm(xt, st, bt), layernorm_reference(xt, st, bt),
                               rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("shape", [(64, 96), (24, 40), (4, 13, 64), (3, 50, 32)],
                         ids=["2d", "2d-small", "3d", "3d-encoder-tokens"])
def test_plain_backward_with_a_residual_gradient_is_autograd_plus_the_residual(shape, dtype):
    # The fused LN+MLP kernel's backward hands the LayerNorm backward the
    # gradient of the block's residual: dx = (LayerNorm's dx in fp32) + dres,
    # rounded once; dscale and dbias are those of the LayerNorm alone.
    x, dm, scale, bias = _inputs(3, shape, "bf16" if dtype == torch.bfloat16 else "fp32")
    dres = np.random.default_rng(4).standard_normal(shape).astype(np.float32)
    xt, dmt, drest = (torch.from_numpy(a).to(dtype) for a in (x, dm, dres))
    st = torch.from_numpy(scale)
    D = shape[-1]
    # The function takes rows: 3-D inputs go in flattened, as the models pass them.
    dx, dscale, dbias = layernorm_backward(xt.reshape(-1, D), st, dmt.reshape(-1, D), EPS, True,
                                           drest.reshape(-1, D))
    leaves = [xt.float().requires_grad_(), st.clone().requires_grad_(),
              torch.from_numpy(bias).requires_grad_()]
    layernorm_reference(*leaves, EPS).backward(dmt.float())
    want_dx = (leaves[0].grad + drest.float()).to(dtype)
    assert dx.dtype == dtype and dscale.dtype == dbias.dtype == torch.float32
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    torch.testing.assert_close(dx.reshape(shape).float(), want_dx.float(), rtol=tol, atol=tol)
    for got, leaf in zip((dscale, dbias), leaves[1:]):
        scale_of = max(1.0, leaf.grad.abs().max().item())
        torch.testing.assert_close(got, leaf.grad, rtol=BF16_PARAM_TOL,
                                   atol=BF16_PARAM_TOL * scale_of)
    # Without a residual the same call is the LayerNorm backward itself.
    alone = layernorm_backward(xt.reshape(-1, D), st, dmt.reshape(-1, D), EPS, True)
    torch.testing.assert_close(alone[0].reshape(shape).float(), leaves[0].grad.to(dtype).float(),
                               rtol=tol, atol=tol)


class _StubLibrary:
    """Stands in for the built library: records what the wrapper asks and hands it."""

    def __init__(self, blocks):
        self.blocks = blocks
        self.asked = []
        self.part_rows = None

    def ssl4polyp_layernorm_bwd_blocks(self, m, d):
        self.asked.append((m, d))
        return self.blocks

    def ssl4polyp_layernorm_bwd(self, x, dy, dres, weight, dx, part, dparams, m, d, eps, parts,
                                stream):
        self.launched = (m, d, parts, dres)
        return 0


@pytest.mark.parametrize("blocks", [1, 7, 264])
def test_backward_scratch_follows_the_library_s_grid(monkeypatch, blocks):
    # The backward's grid is persistent and follows the device; the wrapper
    # must size its (blocks, 2, D) scratch from what the library says, not from
    # a number of its own.
    stub = _StubLibrary(blocks)
    monkeypatch.setattr(_build, "library", lambda: stub)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("Stream", (), {"cuda_stream": 0})())
    made = []
    real_empty = torch.empty

    def recording_empty(*args, **kwargs):
        out = real_empty(*args, **kwargs)
        made.append(tuple(out.shape))
        return out

    monkeypatch.setattr(torch, "empty", recording_empty)
    x = torch.zeros((5, 9, 64), dtype=torch.bfloat16)
    weight = torch.ones(64)
    before = layernorm_module.backward_launches
    dx, dweight, dbias = layernorm_module._backward_kernel(x, x, weight, EPS)
    assert stub.asked == [(45, 64)]
    assert (blocks, 2, 64) in made
    assert stub.launched == (45, 64, 3, None)
    assert dx.shape == x.shape and dweight.shape == dbias.shape == (64,)
    assert layernorm_module.backward_launches == before + 1
    layernorm_module.backward_launches = before


def test_backward_raises_when_the_library_gives_no_grid(monkeypatch):
    stub = _StubLibrary(0)
    monkeypatch.setattr(_build, "library", lambda: stub)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    x = torch.zeros((4, 64), dtype=torch.bfloat16)
    with pytest.raises(RuntimeError, match="no grid"):
        layernorm_module._backward_kernel(x, x, torch.ones(64), EPS)
