"""The port's plain fc1+GELU against the JAX Pallas kernel (interpret mode)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.ops.mlp import fc1_gelu as jax_fc1_gelu
from ssl4polyp_tpu_torch.ops.mlp import fc1_gelu, fc1_gelu_reference

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
