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


def _fused_inputs(seed, m=48, k=32, nf=128):
    rng = np.random.default_rng(seed)
    return {"x": rng.standard_normal((m, k)).astype(np.float32),
            "s": (1 + 0.1 * rng.standard_normal(k)).astype(np.float32),
            "t": (0.05 * rng.standard_normal(k)).astype(np.float32),
            "w1": (rng.standard_normal((k, nf)) / np.sqrt(k) * 2).astype(np.float32),  # (in, out)
            "b1": (0.5 * rng.standard_normal(nf)).astype(np.float32),
            "w2": (rng.standard_normal((nf, k)) / np.sqrt(nf)).astype(np.float32),
            "b2": (0.5 * rng.standard_normal(k)).astype(np.float32),
            "dy": rng.standard_normal((m, k)).astype(np.float32)}


# The JAX kernels' GELU takes the polynomial erf (max |gelu error| 2.2e-6,
# |dgelu error| 4.4e-7), the port's the exact one; fp32 adds the GEMMs'
# summation order through two products.  bf16: h, g, the output and each
# gradient are rounded once on both sides from fp32 sums of the same rounded
# operands, so a rounding flips (one bf16 ulp, 2^-8 to 2^-7 relative) only
# where the erfs or the summation orders differ in the last bits.
FUSED_TOL = {"fp32": (2e-5, 5e-5), "bf16": (2e-2, 3e-2)}  # (forward, gradients)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("with_ln", [False, True], ids=["mlp_fused", "mlp_ln_fused"])
def test_fused_references_and_gradients_match_jax_kernels(with_ln, dtype):
    # three row programs, four NF steps into the accumulator
    _check_fused_against_jax(with_ln, dtype, _fused_inputs(5), block=(16, 32))


# The widths the CUDA kernel is built for (K 512, the MAE decoder's, and 768,
# ViT-B's), at a small M and NF: two row programs and one or two NF steps of
# the JAX kernel.
@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("with_ln", [False, True], ids=["mlp_fused", "mlp_ln_fused"])
@pytest.mark.parametrize("k, nf", [(512, 32), (512, 64), (768, 32), (768, 64)])
def test_fused_references_match_jax_kernels_at_the_kernel_widths(k, nf, with_ln, dtype):
    _check_fused_against_jax(with_ln, dtype, _fused_inputs(7, m=16, k=k, nf=nf), block=(8, 32))


def _check_fused_against_jax(with_ln, dtype, a, block):
    """The port's fused forward (plain on the CPU) equals its reference bit
    for bit, and matches the interpret-mode JAX kernel, gradients included."""
    from ssl4polyp_tpu.ops.mlp import mlp_fused as jax_mlp_fused
    from ssl4polyp_tpu.ops.mlp import mlp_ln_fused as jax_mlp_ln_fused
    from ssl4polyp_tpu_torch.ops.mlp import (mlp_fused, mlp_fused_reference, mlp_ln_fused,
                                             mlp_ln_fused_reference)

    jdt, tdt = {"fp32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    names = ("x", "s", "t", "w1", "b1", "w2", "b2") if with_ln else ("x", "w1", "b1", "w2", "b2")
    jargs = [jnp.asarray(a[n]) if n in "st" else jnp.asarray(a[n], jdt) for n in names]
    if with_ln:
        fn = lambda *args: jax_mlp_ln_fused(*args, 1e-6, True, block)  # noqa: E731
    else:
        fn = lambda *args: jax_mlp_fused(*args, True, block)  # noqa: E731
    out, vjp = jax.vjp(fn, *jargs)
    ref_grads = [np.asarray(g.astype(jnp.float32)) for g in vjp(jnp.asarray(a["dy"], jdt))]

    def port(n):
        value = a[n].T if n in ("w1", "w2") else a[n]  # torch (out, in)
        tensor = torch.from_numpy(np.ascontiguousarray(value))
        return (tensor if n in "st" else tensor.to(tdt)).requires_grad_()

    leaves = [port(n) for n in names]
    ours = (mlp_ln_fused if with_ln else mlp_fused)(*leaves)
    reference = (mlp_ln_fused_reference if with_ln else mlp_fused_reference)(*leaves)
    torch.testing.assert_close(ours.detach(), reference.detach(), rtol=0, atol=0)
    fwd_tol, grad_tol = FUSED_TOL[dtype]
    np.testing.assert_allclose(ours.detach().float().numpy(), np.asarray(out.astype(jnp.float32)),
                               rtol=fwd_tol, atol=fwd_tol)
    ours.backward(torch.from_numpy(a["dy"]).to(tdt))
    for n, leaf, want in zip(names, leaves, ref_grads):
        got = leaf.grad.t() if n in ("w1", "w2") else leaf.grad
        assert got.dtype == leaf.dtype, n
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=grad_tol,
                                   atol=grad_tol * scale, err_msg=f"d{n}")


@pytest.mark.parametrize("with_ln", [False, True], ids=["mlp_fused", "mlp_ln_fused"])
def test_fused_backwards_are_autograd_of_the_references_in_fp32(with_ln):
    from ssl4polyp_tpu_torch.ops import mlp

    a = {n: torch.from_numpy(np.ascontiguousarray(v.T if n in ("w1", "w2") else v))
         for n, v in _fused_inputs(6, m=8, k=16, nf=24).items()}
    names = ("x", "s", "t", "w1", "b1", "w2", "b2") if with_ln else ("x", "w1", "b1", "w2", "b2")
    leaves = [a[n].clone().requires_grad_() for n in names]
    (mlp.mlp_ln_fused_reference if with_ln else mlp.mlp_fused_reference)(*leaves).backward(a["dy"])
    h = torch.matmul(a["x"] if not with_ln else torch.nn.functional.layer_norm(
        a["x"], (16,), a["s"], a["t"], 1e-6), a["w1"].t()) + a["b1"]
    if with_ln:
        got = mlp.mlp_ln_fused_backward(a["x"], a["s"], a["t"], a["w1"], a["w2"], h, a["dy"], 1e-6)
        order = ("x", "s", "t", "w1", "b1", "w2", "b2")
    else:
        got = mlp.mlp_fused_backward(a["x"], a["w1"], a["w2"], h, a["dy"])
        order = ("x", "w1", "b1", "w2", "b2")
    grads = dict(zip(names, (leaf.grad for leaf in leaves)))
    for n, g in zip(order, got):
        torch.testing.assert_close(g, grads[n], rtol=1e-5, atol=1e-5, msg=n)


# The fp32 kernels' full widths (csrc/mlp_fused_f32.cu): ViT-B's (K 768, NF
# 3072) and the MAE decoder's (K 512, NF 2048), the whole NF that a row
# block walks.  The plain fp32 versions the kernels are held to on the card,
# against the interpret-mode JAX kernels at compute_dtype float32, forward
# and VJP.  The JAX erf is a polynomial within 2.2e-6 of the exact erf the
# port takes, and h and out sum 512 to 3072 products in another order; the
# gradients are two or three fp32 sums deep.
FP32_FWD_TOL = 2e-5
FP32_GRAD_TOL = 1e-4


@pytest.mark.parametrize("with_ln", [False, True], ids=["mlp_fused", "mlp_ln_fused"])
@pytest.mark.parametrize("m, k, nf", [(56, 768, 3072), (128, 512, 2048)])
def test_fused_fp32_plain_versions_match_jax_kernels_at_full_width(m, k, nf, with_ln):
    from ssl4polyp_tpu.ops.mlp import mlp_fused as jax_mlp_fused
    from ssl4polyp_tpu.ops.mlp import mlp_ln_fused as jax_mlp_ln_fused
    from ssl4polyp_tpu_torch.ops.mlp import mlp_fused_plain, mlp_ln_fused_plain

    a = _fused_inputs(m + k, m=m, k=k, nf=nf)
    names = ("x", "s", "t", "w1", "b1", "w2", "b2") if with_ln else ("x", "w1", "b1", "w2", "b2")
    if with_ln:
        fn = lambda *args: jax_mlp_ln_fused(*args, 1e-6, True)  # noqa: E731
    else:
        fn = lambda *args: jax_mlp_fused(*args, True)  # noqa: E731
    out, vjp = jax.vjp(fn, *[jnp.asarray(a[n]) for n in names])
    ref_grads = [np.asarray(g) for g in vjp(jnp.asarray(a["dy"]))]
    leaves = [torch.from_numpy(np.ascontiguousarray(a[n].T if n in ("w1", "w2") else a[n]))
              .requires_grad_() for n in names]
    ours = (mlp_ln_fused_plain if with_ln else mlp_fused_plain)(*leaves)
    assert ours.dtype == torch.float32
    ref = np.asarray(out)
    scale = max(1.0, float(np.abs(ref).max()))
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=FP32_FWD_TOL,
                               atol=FP32_FWD_TOL * scale, err_msg="out")
    ours.backward(torch.from_numpy(a["dy"]))
    for n, leaf, want in zip(names, leaves, ref_grads):
        got = leaf.grad.t() if n in ("w1", "w2") else leaf.grad
        assert got.dtype == torch.float32, n
        scale = max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.numpy(), want, rtol=FP32_GRAD_TOL,
                                   atol=FP32_GRAD_TOL * scale, err_msg=f"d{n}")
