"""The port's plain fc1+GELU against the JAX Pallas kernel (interpret mode),
forward and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.ops.mlp import fc1_gelu as jax_fc1_gelu
from ssl4polyp_tpu_torch.ops.mlp import fc1_gelu, fc1_gelu_backward, fc1_gelu_reference

# The JAX kernel's erf is a Chebyshev polynomial with max |gelu error|
# 2.2e-6; the port's is torch's exact erf.  Add fp32 GEMM order at K = 32.
TOL = 1e-5


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_jax_kernel(seed):
    rng = np.random.default_rng(seed)
    m, k, nf = 64, 32, 256
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, nf)) / np.sqrt(k) * 2).astype(np.float32)  # JAX (in, out)
    b = (0.5 * rng.standard_normal(nf)).astype(np.float32)
    ref = np.asarray(jax_fc1_gelu(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), True))
    ours = fc1_gelu_reference(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)),
                              torch.from_numpy(b))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=TOL, atol=TOL)
    # On the CPU the wrapper is the plain version.
    wrapped = fc1_gelu(torch.from_numpy(x), torch.from_numpy(np.ascontiguousarray(w.T)),
                       torch.from_numpy(b))
    torch.testing.assert_close(wrapped, ours, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_gradients_match_jax_custom_vjp(dtype):
    # The JAX VJP takes dgelu from the kernel's saved h with its polynomial
    # erf (max |dgelu error| 4.4e-7), the port from the plain forward's h with
    # the exact erf.  fp32: that plus GEMM order at K = 32.  bf16: h, dh, dx,
    # dw and db are each rounded once on both sides, but the plain h rounds
    # twice (product, then bias add) where the kernel rounds once, so dh may
    # differ by a bf16 ulp or two, 2^-7 relative, before the GEMMs sum them.
    rng = np.random.default_rng(3)
    m, k, nf = 64, 32, 128
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = (rng.standard_normal((k, nf)) / np.sqrt(k) * 2).astype(np.float32)  # JAX (in, out)
    b = (0.5 * rng.standard_normal(nf)).astype(np.float32)
    dy = rng.standard_normal((m, nf)).astype(np.float32)
    jdt, tdt, tol = {"fp32": (jnp.float32, torch.float32, 2e-5),
                     "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}[dtype]
    _, vjp = jax.vjp(lambda a, c, d: jax_fc1_gelu(a, c, d, True),
                     jnp.asarray(x, jdt), jnp.asarray(w, jdt), jnp.asarray(b, jdt))
    ref = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dy, jdt))]
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(np.ascontiguousarray(w.T)).to(tdt).requires_grad_()
    bt = torch.from_numpy(b).to(tdt).requires_grad_()
    fc1_gelu(xt, wt, bt).backward(torch.from_numpy(dy).to(tdt))
    ours = [xt.grad, wt.grad.t(), bt.grad]
    for name, a, r in zip(("dx", "dw", "db"), ours, ref):
        assert a.dtype == tdt, name
        scale = max(1.0, float(np.abs(r).max()))
        np.testing.assert_allclose(a.float().numpy(), r, rtol=tol, atol=tol * scale, err_msg=name)


def test_backward_from_h_is_autograd_of_the_reference_in_fp32():
    rng = np.random.default_rng(4)
    x, w = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for s in ((8, 16), (24, 16)))
    b = torch.from_numpy(rng.standard_normal(24).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((8, 24)).astype(np.float32))
    xs, ws, bs = (t.clone().requires_grad_() for t in (x, w, b))
    fc1_gelu_reference(xs, ws, bs).backward(dy)
    dx, dw, db = fc1_gelu_backward(x, w, torch.matmul(x, w.t()) + b, dy)
    for got, want in ((dx, xs.grad), (dw, ws.grad), (db, bs.grad)):
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
