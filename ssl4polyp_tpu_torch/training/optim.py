"""AdamW with per-parameter learning-rate and weight-decay scales.

Counterpart of ``ssl4polyp_tpu/training/optim.py`` (``adamw_init``,
``adamw_update``, ``no_weight_decay_scales``, ``pretrain_lr_scales``,
``finetune_lr_scales``, ``global_norm``): plain torch on fp32 tensors keyed
by parameter name, the same formula (``torch.optim.AdamW``'s: bias-corrected moments, decoupled
weight decay scaled by the step's learning rate)::

    step_dir = m_hat / (sqrt(n_hat) + eps) + weight_decay * ws * p
    p = p - lr * ls * step_dir

Unlike the functional JAX version, the update works in place on the fp32
masters and moments, which saves a copy of the model and both moments.
Tensors with the same (ls, ws) pair update together through torch's
``_foreach`` ops, a few launches per group instead of a dozen per tensor.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping

import torch

__all__ = [
    "AdamWState",
    "adamw_init",
    "adamw_update",
    "finetune_lr_scales",
    "global_norm",
    "no_weight_decay_scales",
    "pretrain_lr_scales",
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


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32."""
    norms = torch._foreach_norm([t.float() for t in tensors.values()])
    return torch.linalg.vector_norm(torch.stack(norms))


@torch.no_grad()
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
    """One AdamW step on the fp32 ``params`` and the moments, in place."""
    state.step += 1
    # The bias corrections in fp32, as the JAX step computes them.
    t = torch.tensor(float(state.step), dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** t)
    bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** t)
    groups: Dict[tuple, list] = {}
    for name in params:
        groups.setdefault((lr_scale[name], wd_scale[name]), []).append(name)
    for (ls, ws), names in groups.items():
        p = [params[n] for n in names]
        g = [grads[n].float() for n in names]
        mu = [state.mu[n] for n in names]
        nu = [state.nu[n] for n in names]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(g, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(g, g), 1.0 - b2))
        if lr * ls == 0.0:  # frozen: the moments move, the parameters do not
            continue
        denom = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
        step_dir = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
        if weight_decay * ws:
            torch._foreach_add_(step_dir, torch._foreach_mul(p, weight_decay * ws))
        torch._foreach_sub_(p, torch._foreach_mul(step_dir, lr * ls))
