"""AdamW with per-parameter learning-rate and weight-decay scales, and LARS.

Counterpart of ``ssl4polyp_tpu/training/optim.py`` (``adamw_init``,
``adamw_update``, ``no_weight_decay_scales``, ``pretrain_lr_scales``,
``finetune_lr_scales``, ``layerwise_lr_decay_scales``, the LARS of the
linear probe, ``global_norm``, ``clip_by_global_norm``): plain torch on fp32
tensors keyed by parameter name.  AdamW has the same formula
(``torch.optim.AdamW``'s: bias-corrected moments, decoupled weight decay
scaled by the step's learning rate)::

    step_dir = m_hat / (sqrt(n_hat) + eps) + weight_decay * ws * p
    p = p - lr * ls * step_dir

Unlike the functional JAX version, the update works in place on the fp32
masters and moments, which saves a copy of the model and both moments.
The train steps call :func:`adamw_update_fused`, which also refreshes the
compute copy: on the card one multi-tensor kernel pass (``ops/adamw.py``),
on the CPU the plain version, where tensors with the same (ls, ws) pair
update together through torch's ``_foreach`` ops.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from ..ops.adamw import adamw_multi_tensor, adamw_multi_tensor_plain

__all__ = [
    "AdamWState",
    "LARSState",
    "adamw_init",
    "adamw_update",
    "adamw_update_fused",
    "adamw_update_fused_plain",
    "clip_by_global_norm",
    "copy_into",
    "finetune_lr_scales",
    "global_norm",
    "lars_init",
    "lars_update",
    "layerwise_lr_decay_scales",
    "no_weight_decay_scales",
    "pretrain_lr_scales",
    "refresh_compute_copy",
]

Tensors = Dict[str, torch.Tensor]

# Leaves without weight decay besides every tensor of rank <= 1 (timm's
# grouping, reference main_pretrain.py:217-218), under the port's names.
_NO_DECAY_NAMES = {"cls_token", "pos_embed", "mask_token", "decoder_pos_embed"}
# The MAE's sin-cos tables: frozen buffers in the reference (models_mae.py:37,51).
_FROZEN_NAMES = {"pos_embed", "decoder_pos_embed"}


@dataclass
class AdamWState:
    step: int
    mu: Tensors
    nu: Tensors
    # What the kernel's wrapper keeps between steps (its tensor table).
    cache: dict = field(default_factory=dict)


def adamw_init(params: Mapping[str, torch.Tensor]) -> AdamWState:
    """Zero fp32 moments for every parameter."""
    zeros = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    return AdamWState(step=0, mu=zeros, nu={n: z.clone() for n, z in zeros.items()})


def no_weight_decay_scales(params: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """0.0 on biases, norm weights, tokens and position tables; 1.0 elsewhere."""
    return {n: 0.0 if n.rsplit(".", 1)[-1] in _NO_DECAY_NAMES or p.dim() <= 1 else 1.0
            for n, p in params.items()}


def pretrain_lr_scales(params: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """MAE pretraining: 1.0 everywhere, 0.0 on the frozen sin-cos tables
    (the cls and mask tokens train)."""
    return {n: 0.0 if n in _FROZEN_NAMES else 1.0 for n in params}


def finetune_lr_scales(
    params: Mapping[str, torch.Tensor],
    mode: str,
    depth: int,
    head_scale: float = 1.0,
    backbone_scale: float = 1.0,
    freeze_pos_embed: bool = False,
) -> Dict[str, float]:
    """The learning-rate scale of each classifier parameter under a
    fine-tune regime (JAX ``optim.py:234-284``, reference ``finetune.py:29-91``).

    ``full`` trains everything; ``none`` only the head; ``head+1`` and
    ``head+2`` also the last one or two blocks.  The head takes
    ``head_scale``, every trained backbone parameter ``backbone_scale``.
    ``freeze_pos_embed`` gives ``pos_embed`` 0 in every mode: the MAE
    lineage's sin-cos table is a frozen buffer in the reference.
    """
    mode = (mode or "full").strip().lower()
    if mode not in {"none", "full", "head+1", "head+2"}:
        raise ValueError(f"Unsupported fine-tune mode {mode!r}")
    first_trained = depth - {"none": 0, "full": depth, "head+1": 1, "head+2": 2}[mode]

    def scale(name: str) -> float:
        if name == "pos_embed" and freeze_pos_embed:
            return 0.0
        if name.startswith("head."):
            return head_scale
        if name.startswith("blocks."):
            return backbone_scale if int(name.split(".")[1]) >= first_trained else 0.0
        # The patch embedding, cls token, position table and final norm.
        return backbone_scale if mode == "full" else 0.0

    return {name: scale(name) for name in params}


def layerwise_lr_decay_scales(
    params: Mapping[str, torch.Tensor],
    depth: int,
    decay: float = 0.75,
    head_scale: float = 1.0,
) -> Dict[str, float]:
    """Layer-wise learning-rate decay for the upstream MAE fine-tune (JAX
    ``optim.py:301-330``, the reference's ``mae/util/lr_decay.py``:
    ``param_groups_lrd``): block i takes ``decay ** (depth - i)`` (an fp32
    value, as the JAX package's scale vector holds it), the final norm 1,
    the head ``head_scale``, and the embeddings (patch embedding, cls token,
    position table) ``decay ** (depth + 1)``."""

    def scale(name: str) -> float:
        if name.startswith("head."):
            return head_scale
        if name.startswith("blocks."):
            return float(np.float32(decay ** (depth - int(name.split(".")[1]))))
        if name.startswith("norm."):
            return 1.0
        return decay ** (depth + 1)

    return {name: scale(name) for name in params}


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    norms = torch._foreach_norm([t.float() for t in tensors.values()])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """(``grads`` scaled by min(1, max_norm / norm), their global norm)
    (JAX ``optim.py:405-409``); the factor is cast to each gradient's dtype."""
    norm = global_norm(grads)
    factor = torch.clamp(max_norm / torch.clamp(norm, min=1e-12), max=1.0)
    return {n: g * factor.to(g.dtype) for n, g in grads.items()}, norm


@dataclass
class LARSState:
    step: int
    momentum: Tensors


def lars_init(params: Mapping[str, torch.Tensor]) -> LARSState:
    """Zero fp32 momentum for every parameter."""
    return LARSState(step=0, momentum={n: torch.zeros_like(p, dtype=torch.float32)
                                       for n, p in params.items()})


@torch.no_grad()
def lars_update(
    params: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor],
    state: LARSState,
    *,
    lr: float,
    weight_decay: float = 0.0,
    momentum: float = 0.9,
    trust_coefficient: float = 0.001,
    lr_scale: Optional[Mapping[str, float]] = None,
    params_c: Optional[Mapping[str, torch.Tensor]] = None,
) -> None:
    """One LARS step (the upstream MAE ``util/lars.py``, JAX
    ``optim.py:348-397``) on the fp32 ``params`` and the momentum, in place.

    A tensor of more than one dimension takes weight decay and the trust
    ratio ``trust_coefficient * |p| / |g|`` (1 where either norm is 0);
    vectors take plain momentum SGD.  Then ``m = momentum * m + g`` and
    ``p -= lr * lr_scale * m``.  Every tensor of ``params_c`` that is a copy
    of its own (the cast of a matrix) is rewritten from its new master.
    Plain torch on any device: the linear probe updates two tensors."""
    state.step += 1
    for name, p in params.items():
        g = grads[name].float()
        if p.dim() > 1:
            g = g + weight_decay * p
            p_norm, g_norm = torch.linalg.vector_norm(p), torch.linalg.vector_norm(g)
            trust = torch.where((p_norm > 0) & (g_norm > 0),
                                trust_coefficient * p_norm / g_norm, torch.ones_like(p_norm))
            g = g * trust
        m = state.momentum[name]
        m.mul_(momentum).add_(g)
        p.sub_(m * (lr * (1.0 if lr_scale is None else lr_scale[name])))
    if params_c is not None:
        refresh_compute_copy(params, {n: params_c[n] for n in params})


def _bias_corrections(step: int, b1: float, b2: float) -> tuple[float, float]:
    """1 - b^step for both betas, in fp32 as the JAX step computes them."""
    t = torch.tensor(float(step), dtype=torch.float32)
    return (float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t),
            float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t))


def _step(run, params, params_c, grads, state, lr, b1, b2, eps, weight_decay, lr_scale,
          wd_scale, **cache) -> None:
    state.step += 1
    bc1, bc2 = _bias_corrections(state.step, b1, b2)
    names = list(params)
    run([params[n] for n in names],
        None if params_c is None else [params_c[n] for n in names],
        [grads[n] for n in names], [state.mu[n] for n in names], [state.nu[n] for n in names],
        [lr_scale[n] for n in names], [wd_scale[n] for n in names],
        lr=lr, b1=b1, b2=b2, eps=eps, weight_decay=weight_decay, bc1=bc1, bc2=bc2, **cache)


def adamw_update(
    params: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor],
    state: AdamWState,
    *,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    lr_scale: Mapping[str, float],
    wd_scale: Mapping[str, float],
) -> None:
    """One AdamW step on the fp32 ``params`` and the moments, in place, in
    plain torch on any device."""
    _step(adamw_multi_tensor_plain, params, None, grads, state, lr, b1, b2, eps, weight_decay,
          lr_scale, wd_scale)


def adamw_update_fused(
    params: Mapping[str, torch.Tensor],
    params_c: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor],
    state: AdamWState,
    *,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    lr_scale: Mapping[str, float],
    wd_scale: Mapping[str, float],
) -> None:
    """One AdamW step that also refreshes the compute copy (JAX
    ``adamw_update_fused``): ``params`` and the moments in place, and every
    entry of ``params_c`` that is a tensor of its own (the bf16 copy of a
    matrix; a vector's copy is its master, and in fp32 compute every copy is
    its master, so nothing is written) rewritten from the new value.

    CUDA tensors go through the multi-tensor kernel (``ops/adamw.py``), or
    it raises; CPU tensors through :func:`adamw_update_fused_plain`.
    """
    _step(adamw_multi_tensor, params, params_c, grads, state, lr, b1, b2, eps, weight_decay,
          lr_scale, wd_scale, cache=state.cache)


def adamw_update_fused_plain(
    params: Mapping[str, torch.Tensor],
    params_c: Mapping[str, torch.Tensor],
    grads: Mapping[str, torch.Tensor],
    state: AdamWState,
    *,
    lr: float,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    lr_scale: Mapping[str, float],
    wd_scale: Mapping[str, float],
) -> None:
    """:func:`adamw_update_fused` in plain torch on any device: the
    ``_foreach`` chain of :func:`adamw_update`, then the copies."""
    _step(adamw_multi_tensor_plain, params, params_c, grads, state, lr, b1, b2, eps,
          weight_decay, lr_scale, wd_scale)


@torch.no_grad()
def copy_into(target: Mapping[str, torch.Tensor], source: Mapping[str, torch.Tensor]) -> None:
    """Copy each tensor of ``source`` into the tensor of ``target`` of its
    name, in place (a restore): the masters are the model's own parameters,
    an fp32 compute copy aliases them and the AdamW kernel's wrapper keeps
    the addresses of masters and moments (``AdamWState.cache``), so none is
    ever rebound.  The names and every shape must match."""
    if sorted(source) != sorted(target):
        raise ValueError("the checkpoint's parameters are not this model's: "
                         f"{sorted(set(source) ^ set(target))}")
    for name, tensor in target.items():
        if source[name].shape != tensor.shape:
            raise ValueError(f"{name}: checkpoint shape {tuple(source[name].shape)}, "
                             f"model shape {tuple(tensor.shape)}")
        tensor.copy_(source[name])


@torch.no_grad()
def refresh_compute_copy(params: Mapping[str, torch.Tensor],
                         params_c: Mapping[str, torch.Tensor]) -> None:
    """Rewrite every compute-copy tensor of its own (the cast of a matrix)
    from its master, in place; a copy that aliases its master is left."""
    for name, copy in params_c.items():
        master = params[name]
        if copy.data_ptr() != master.data_ptr():
            copy.copy_(master)
