"""One AdamW step over a list of tensors, with the compute copy in the same pass.

Counterpart of ``ssl4polyp_tpu/ops/adamw.py`` (``adamw_leaf_pallas``, one
launch per leaf): one CUDA kernel (``csrc/adamw.cu``) walks up to 64 tensors
per launch, updates the fp32 parameters and moments in place and writes the
bf16 copy of every tensor that has one.

Tensors on the CPU go through :func:`adamw_multi_tensor_plain`, eager torch
``_foreach`` ops; CUDA tensors go through the kernel, or the wrapper raises.
The wrapper's own work counts, for a step is bound by the host: the table of
a state's tensors is checked and packed once and kept with that state.
The kernel repeats the plain version's operations one by one, each rounded
to fp32 once, so the two agree bit for bit given the same scalars.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

__all__ = ["TENSORS_PER_LAUNCH", "adamw_multi_tensor", "adamw_multi_tensor_plain", "launches"]

# Kernel launches since the last ops.reset_launch_counts().
launches = 0

TENSORS_PER_LAUNCH = 64
_BLOCK_ELEMS = 8192
_FLAG_GRAD_BF16, _FLAG_FROZEN, _FLAG_DECAY = 1, 2, 4
# csrc/adamw.cu::AdamWChunk, byte for byte.
_CHUNK = np.dtype([
    ("p", "<u8", TENSORS_PER_LAUNCH), ("g", "<u8", TENSORS_PER_LAUNCH),
    ("mu", "<u8", TENSORS_PER_LAUNCH), ("nu", "<u8", TENSORS_PER_LAUNCH),
    ("copy", "<u8", TENSORS_PER_LAUNCH), ("n", "<i4", TENSORS_PER_LAUNCH),
    ("lr", "<f4", TENSORS_PER_LAUNCH), ("decay", "<f4", TENSORS_PER_LAUNCH),
    ("flags", "<i4", TENSORS_PER_LAUNCH), ("block_start", "<i4", TENSORS_PER_LAUNCH + 1),
    ("count", "<i4"), ("scalars", "<f4", 7), ("pad", "<i4"),
])

Tensors = Sequence[torch.Tensor]


def _copies(params: Tensors, copies: Optional[Sequence[Optional[torch.Tensor]]]
            ) -> List[Optional[torch.Tensor]]:
    """The copy to write for each parameter: None where there is none or it
    aliases the parameter itself (a vector's copy is its master)."""
    if copies is None:
        return [None] * len(params)
    return [None if c is None or c.data_ptr() == p.data_ptr() else c
            for p, c in zip(params, copies)]


@torch.no_grad()
def adamw_multi_tensor_plain(
    params: Tensors, copies: Optional[Sequence[Optional[torch.Tensor]]], grads: Tensors,
    mu: Tensors, nu: Tensors, lr_scales: Sequence[float], wd_scales: Sequence[float], *,
    lr: float, b1: float, b2: float, eps: float, weight_decay: float, bc1: float, bc2: float,
) -> None:
    """The plain torch version: ``_foreach`` ops over the tensors that share
    an (lr scale, weight-decay scale) pair, then the copies.

    ``bc1`` and ``bc2`` are the step's bias corrections; the moments are
    multiplied by their reciprocals (taken in double), which is how torch
    divides a CUDA tensor by a scalar: written out, the CPU does the same.
    Where ``lr * lr_scale`` is 0 the moments move and the parameter and its
    copy keep their bits.
    """
    groups: Dict[tuple, list] = {}
    for i, pair in enumerate(zip(lr_scales, wd_scales)):
        groups.setdefault(pair, []).append(i)
    targets = _copies(params, copies)
    for (ls, ws), members in groups.items():
        p = [params[i] for i in members]
        g = [grads[i].float() for i in members]
        m = [mu[i] for i in members]
        v = [nu[i] for i in members]
        torch._foreach_mul_(m, b1)
        torch._foreach_add_(m, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(v, b2)
        torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
        if lr * ls == 0.0:  # frozen: the moments move, the parameters do not
            continue
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_mul(v, 1.0 / bc2)), eps)
        step_dir = torch._foreach_div(torch._foreach_mul(m, 1.0 / bc1), denom)
        if weight_decay * ws:
            torch._foreach_add_(step_dir, torch._foreach_mul(p, weight_decay * ws))
        torch._foreach_sub_(p, torch._foreach_mul(step_dir, lr * ls))
        for i in members:
            if targets[i] is not None:
                targets[i].copy_(params[i])


class _Table:
    """The launches' tensor tables for one set of parameters, copies and
    moments: validated and packed once, reused while the same tensors come
    back (same objects, same storage).  A step fills in its gradients and
    scalars."""

    def __init__(self, params, targets, mu, nu, key):
        self.key = key
        self.tensors = (params, targets, mu, nu)  # keeps the key's ids from being reused
        self.device = params[0].device
        for p, c, m, v in zip(params, targets, mu, nu):
            tensors = [p, m, v] + ([] if c is None else [c])
            if any(t.device != self.device for t in tensors):
                raise ValueError(f"every tensor of a step must lie on {self.device}")
            if any(t.shape != p.shape for t in tensors):
                raise ValueError(f"shapes differ within one parameter's tensors: "
                                 f"{[tuple(t.shape) for t in tensors]}")
            if not all(t.dtype == torch.float32 for t in (p, m, v)):
                raise TypeError("the kernel takes fp32 parameters and moments")
            if c is not None and c.dtype != torch.bfloat16:
                raise TypeError(f"the kernel writes a bf16 copy, got {c.dtype}")
            if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
                raise ValueError("every tensor must be contiguous and 16-byte aligned")
            if p.numel() >= 2 ** 31:
                raise ValueError("the kernel indexes a tensor with 32 bits")
        self.count = len(params)
        self.sizes = [p.numel() for p in params]
        self.chunks = np.zeros(-(-self.count // TENSORS_PER_LAUNCH), dtype=_CHUNK)
        columns = {
            "p": [t.data_ptr() for t in params],
            "mu": [t.data_ptr() for t in mu],
            "nu": [t.data_ptr() for t in nu],
            "copy": [0 if t is None else t.data_ptr() for t in targets],
            "n": self.sizes,
        }
        for name, values in columns.items():
            self.fill(name, values)
        for k, (lo, hi) in enumerate(self.spans()):
            blocks = [-(-n // _BLOCK_ELEMS) for n in self.sizes[lo:hi]]
            self.chunks["block_start"][k, :hi - lo + 1] = np.concatenate([[0], np.cumsum(blocks)])
            self.chunks["count"][k] = hi - lo

    def spans(self):
        return [(lo, min(self.count, lo + TENSORS_PER_LAUNCH))
                for lo in range(0, self.count, TENSORS_PER_LAUNCH)]

    def fill(self, name, values) -> None:
        for k, (lo, hi) in enumerate(self.spans()):
            self.chunks[name][k, :hi - lo] = values[lo:hi]

    def step(self, grads, lr_scales, wd_scales, lr, weight_decay, scalars) -> np.ndarray:
        """The records of one step: this step's gradients and scalars
        beside the cached pointers."""
        pointers, bf16 = [], []
        for g, n in zip(grads, self.sizes):
            if g.device != self.device or g.numel() != n:
                raise ValueError(f"a gradient of {g.numel()} elements on {g.device} does not fit "
                                 f"its parameter of {n} on {self.device}")
            if g.dtype not in (torch.float32, torch.bfloat16):
                raise TypeError(f"the kernel takes fp32 or bf16 gradients, got {g.dtype}")
            if g.data_ptr() % 16:
                raise ValueError("every gradient must be 16-byte aligned")
            pointers.append(g.data_ptr())
            bf16.append(g.dtype == torch.bfloat16)
        # Python floats are doubles: the products are rounded to fp32 once,
        # as the plain version's foreach ops round their scalar.
        rates = lr * np.asarray(lr_scales, dtype=np.float64)
        decays = weight_decay * np.asarray(wd_scales, dtype=np.float64)
        flags = (_FLAG_GRAD_BF16 * np.asarray(bf16, dtype=np.int32)
                 + _FLAG_FROZEN * (rates == 0.0) + _FLAG_DECAY * (decays != 0.0))
        self.fill("g", pointers)
        self.fill("lr", rates)
        self.fill("decay", decays)
        self.fill("flags", flags)
        self.chunks["scalars"][:] = scalars
        return self.chunks


def _table(cache: Optional[dict], params, targets, mu, nu) -> _Table:
    """The cached table when the same tensors come back, else a new one."""
    static = (params, targets, mu, nu)
    key = tuple(id(t) for tensors in static for t in tensors) + tuple(
        0 if t is None else t.data_ptr() for tensors in static for t in tensors)
    table = None if cache is None else cache.get("table")
    if table is None or table.key != key:
        table = _Table(list(params), list(targets), list(mu), list(nu), key)
        if cache is not None:
            cache["table"] = table
    return table


@torch.no_grad()
def adamw_multi_tensor(
    params: Tensors, copies: Optional[Sequence[Optional[torch.Tensor]]], grads: Tensors,
    mu: Tensors, nu: Tensors, lr_scales: Sequence[float], wd_scales: Sequence[float], *,
    lr: float, b1: float, b2: float, eps: float, weight_decay: float, bc1: float, bc2: float,
    cache: Optional[dict] = None,
) -> None:
    """One AdamW step on ``params``, ``mu`` and ``nu`` in place; ``copies[i]``
    (bf16, or None, or the parameter itself) receives parameter i's new value.

    The contract of :func:`adamw_multi_tensor_plain`.  CUDA tensors take
    ``ceil(len(params) / 64)`` launches of the kernel.  ``cache`` is a dict
    the caller keeps between steps (the optimizer state's): the wrapper
    leaves its validated tensor table there, so that a step over the same
    parameters, copies and moments only adds its gradients and scalars.  A
    gradient that is not contiguous is copied into a contiguous one first.
    """
    if not params:
        return
    if params[0].device.type == "cpu":
        return adamw_multi_tensor_plain(params, copies, grads, mu, nu, lr_scales, wd_scales,
                                        lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay,
                                        bc1=bc1, bc2=bc2)
    if params[0].device.type != "cuda":
        raise ValueError(f"no kernel for device {params[0].device}")
    from ._build import library

    global launches
    table = _table(cache, params, _copies(params, copies), mu, nu)
    grads = [g if g.is_contiguous() else g.contiguous() for g in grads]
    scalars = np.array([b1, 1.0 - b1, b2, 1.0 - b2, 1.0 / bc1, 1.0 / bc2, eps], dtype=np.float64)
    chunks = table.step(grads, lr_scales, wd_scales, lr, weight_decay, scalars.astype(np.float32))
    lib = library()
    layout = tuple(lib.ssl4polyp_adamw_layout(what) for what in range(3))
    if layout != (_CHUNK.itemsize, TENSORS_PER_LAUNCH, _BLOCK_ELEMS):
        raise RuntimeError(f"the kernel's table layout {layout} is not the host's")
    with torch.cuda.device(params[0].device):
        err = lib.ssl4polyp_adamw_step(chunks.ctypes.data, len(chunks),
                                       torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"adamw kernel launch failed: CUDA error {err}")
    launches += len(chunks)
