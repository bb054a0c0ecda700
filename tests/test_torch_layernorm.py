"""The port's plain LayerNorm against the JAX Pallas kernels (interpret mode).

Forward and vjp (dx, dscale, dbias), 3-D and 2-D, fp32 and bf16; inputs made
with numpy from a seed and handed to both frameworks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.ops.layernorm import layernorm_fused_bwd, layernorm_fused_view
from ssl4polyp_tpu_torch.ops.layernorm import layernorm, layernorm_reference

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
