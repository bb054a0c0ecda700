"""ssl4polyp_tpu_torch — the PyTorch and CUDA port of ssl4polyp_tpu for one
NVIDIA H100.

Module paths mirror the JAX package (``ssl4polyp_tpu``), which stays the
reference the port is tested against.  This package imports torch and never
jax.
"""

__version__ = "0.1.0"
