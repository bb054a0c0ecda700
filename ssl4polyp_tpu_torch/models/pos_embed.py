"""Fixed 2D sine-cosine positional embeddings, in numpy.

A copy of ``ssl4polyp_tpu/models/pos_embed.py``: that module sits in a
package whose ``__init__`` imports jax, so the port cannot import it.
Same embedding family as the reference
(``src/ssl4polyp/models/mae/util/pos_embed.py``): for a ``g x g`` patch grid
and an even dimension ``D``, half the channels encode the column coordinate
and half the row coordinate, each as sin/cos of geometrically spaced
frequencies (base 10000).
"""

from __future__ import annotations

import numpy as np

__all__ = ["sincos_2d", "sincos_1d"]


def sincos_1d(dim: int, positions: np.ndarray) -> np.ndarray:
    """1D sin-cos embedding: (len(positions), dim) with dim even."""
    if dim % 2 != 0:
        raise ValueError("sincos embedding dimension must be even")
    omega = np.arange(dim // 2, dtype=np.float64)
    omega = 1.0 / (10000.0 ** (omega / (dim / 2.0)))
    angles = np.einsum("p,f->pf", positions.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(angles), np.cos(angles)], axis=1)


def sincos_2d(dim: int, grid_size: int, cls_token: bool = False) -> np.ndarray:
    """2D sin-cos embedding: (grid²[+1], dim); row 0 is zeros when ``cls_token``."""
    if dim % 2 != 0:
        raise ValueError("sincos embedding dimension must be even")
    coords = np.arange(grid_size, dtype=np.float64)
    grid_y, grid_x = np.meshgrid(coords, coords, indexing="ij")
    # Row-major flattening; the FIRST half of the channels encodes the
    # COLUMN coordinate, as the reference's ``np.meshgrid(grid_w, grid_h)``
    # does (``mae/util/pos_embed.py:26-46``), which pretrained checkpoints
    # depend on.
    emb_col = sincos_1d(dim // 2, grid_x)
    emb_row = sincos_1d(dim // 2, grid_y)
    table = np.concatenate([emb_col, emb_row], axis=1)
    if cls_token:
        table = np.concatenate([np.zeros((1, dim)), table], axis=0)
    return table.astype(np.float32)
