"""The port's plain LN+linear against the JAX Pallas kernel (interpret mode),
forward and gradients."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.ops.ln_linear import ln_linear as jax_ln_linear
from ssl4polyp_tpu_torch.ops.ln_linear import ln_linear, ln_linear_backward, ln_linear_reference

M, K, N = 48, 64, 96
BLOCK = 16  # rows per program: a grid of three
# fp32: the same steps on both sides, in another summation order.  bf16:
# each side rounds m, the output and each gradient once from fp32 sums of
# the same rounded operands, so a rounding flips (one bf16 ulp, 2^-8 to
# 2^-7 relative) only where the fp32 sums differ in their last bits.
TOL = {"fp32": 1e-5, "bf16": 2e-2}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((M, K)).astype(np.float32),
            (1 + 0.1 * rng.standard_normal(K)).astype(np.float32),
            (0.05 * rng.standard_normal(K)).astype(np.float32),
            (rng.standard_normal((K, N)) / np.sqrt(K)).astype(np.float32),  # JAX (in, out)
            (0.5 * rng.standard_normal(N)).astype(np.float32),
            rng.standard_normal((M, N)).astype(np.float32))


def _dtypes(name):
    return {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[name]


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
def test_reference_and_gradients_match_jax_kernel(dtype):
    x, s, t, w, b, dy = _inputs(0)
    jdt, tdt = _dtypes(dtype)
    jargs = (jnp.asarray(x, jdt), jnp.asarray(s), jnp.asarray(t), jnp.asarray(w, jdt),
             jnp.asarray(b, jdt))
    out, vjp = jax.vjp(lambda *a: jax_ln_linear(*a, 1e-6, True, BLOCK), *jargs)
    ref_grads = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(dy, jdt))]

    leaves = [torch.from_numpy(x).to(tdt), torch.from_numpy(s), torch.from_numpy(t),
              torch.from_numpy(np.ascontiguousarray(w.T)).to(tdt), torch.from_numpy(b).to(tdt)]
    leaves = [a.requires_grad_() for a in leaves]
    ours = ln_linear(*leaves)
    assert ours.dtype == tdt
    # On the CPU the wrapper is the plain version.
    torch.testing.assert_close(ours.detach(), ln_linear_reference(*leaves).detach(), rtol=0, atol=0)
    tol = TOL[dtype]
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(out.astype(jnp.float32)),
                               rtol=tol, atol=tol)
    ours.backward(torch.from_numpy(dy).to(tdt))
    grads = [leaves[0].grad, leaves[1].grad, leaves[2].grad, leaves[3].grad.t(), leaves[4].grad]
    for name, got, want in zip(("dx", "ds", "dt", "dw", "db"), grads, ref_grads):
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol * scale,
                                   err_msg=name)


def test_backward_is_autograd_of_the_reference_in_fp32():
    x, s, t, w, b, dy = (torch.from_numpy(a) for a in _inputs(1))
    w = w.t().contiguous()
    leaves = [a.clone().requires_grad_() for a in (x, s, t, w, b)]
    ln_linear_reference(*leaves).backward(dy)
    for name, got, leaf in zip(("dx", "ds", "dt", "dw", "db"),
                               ln_linear_backward(x, s, t, w, dy, 1e-6), leaves):
        torch.testing.assert_close(got, leaf.grad, rtol=1e-5, atol=1e-5, msg=name)


# The fp32 kernel's full widths (csrc/ln_linear_f32.cu): ViT-B's QKV (768 ->
# 2304) and the MAE decoder's (512 -> 1536).  The plain fp32 version the
# kernel is held to on the card, against the interpret-mode JAX kernel at
# compute_dtype float32, forward and VJP: the same fp32 steps in another
# summation order over 512 or 768 products; the gradients two or three fp32
# sums deep.
FP32_FWD_TOL = 2e-5
FP32_GRAD_TOL = 1e-4


@pytest.mark.parametrize("m, k, n", [(56, 768, 2304), (64, 512, 1536)])
def test_fp32_plain_version_matches_jax_kernel_at_full_width(m, k, n):
    rng = np.random.default_rng(m + k)
    x = (rng.standard_normal((m, k)) * 2 + 0.5).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(k)).astype(np.float32)
    t = (0.05 * rng.standard_normal(k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) / np.sqrt(k)).astype(np.float32)  # JAX (in, out)
    b = (0.5 * rng.standard_normal(n)).astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    out, vjp = jax.vjp(lambda *a: jax_ln_linear(*a, 1e-6, True),
                       *(jnp.asarray(v) for v in (x, s, t, w, b)))
    ref_grads = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    leaves = [torch.from_numpy(np.ascontiguousarray(v)).requires_grad_()
              for v in (x, s, t, w.T, b)]
    ours = ln_linear(*leaves)
    assert ours.dtype == torch.float32
    ref = np.asarray(out)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=FP32_FWD_TOL,
                               atol=FP32_FWD_TOL * scale, err_msg="out")
    ours.backward(torch.from_numpy(dy))
    grads = [leaves[0].grad, leaves[1].grad, leaves[2].grad, leaves[3].grad.t(), leaves[4].grad]
    for name, got, want in zip(("dx", "ds", "dt", "dw", "db"), grads, ref_grads):
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=FP32_GRAD_TOL,
                                   atol=FP32_GRAD_TOL * scale, err_msg=name)
