#!/usr/bin/env python3
"""Drive the PyTorch port's eval forward, MAE pretrain step, classifier
fine-tune step (with and without ``BENCH_ATTN_PROJ=1``), its two attention
functions of ``ops`` that no model route calls, and its standalone eval CLI
on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

(``--kernels-only`` stops after phase 2, for work on a kernel.)  Phases:

1. Device and build: requires CUDA, prints the card's name and power limit,
   builds the CUDA kernels from ``ssl4polyp_tpu_torch/ops/csrc``.
2. Each kernel against its plain torch version on the card, in bf16, at the
   eval, pretrain and fine-tune paths' shapes, forward and backward: max
   error against the stated tolerance (the AdamW kernel bit for bit, on the
   classifier's and the MAE's parameter lists), the kernel's and the plain
   version's times from CUDA events, beside them the time of the PyTorch
   library call for the same function where there is one (timed only; the
   port never calls it), and the least time the card could take (the larger
   of the bytes over its memory rate and the operations over its peak rate),
   at each shape a kernel is timed at: the classifier's, the MAE decoder's
   and the MAE encoder's.  The summary quotes the classifier's shape.  The
   attention backward prints which of its paths each shape takes, its first
   design's time beside its own, and its time with parts left out (wrong
   results, times only: where its time goes).  The
   LayerNorm backward is also held and timed with a residual's gradient
   folded in, and its two launches (the row kernel, the sum of the blocks'
   partials) are timed apart; the attention+projection backward's four
   phases are timed apart, each beside its bound (its dW phase also on its
   first design, through a phase bit), and its forward is timed
   without its attention arithmetic, without its projection's products and
   without both (wrong results, times only: where its time goes).  The fused
   MLPs (with and without the LayerNorm) print, at the classifier's and the
   MAE decoder's shapes, their first design's time (through the kernel's
   probe, in the same process, held to the plain version too), the unfused
   bf16 chain, and their times with parts left out and with other cluster
   sizes; their reruns and their output without h are bit-identical.  LN+QKV
   prints, at the same two shapes, its first design's time (through its
   probe, held to the plain version), the unfused chain, cuBLAS's
   ``torch.addmm`` alone on a ready normalised row (timed only), and its
   times with parts left out and at the other tile width; its reruns and
   its C entry point for callers without scratch are bit-identical, and
   with W = I its output (the normalised row itself) is bit-equal to the
   first design's.  Attention over separate q, k, v prints, at the
   classifier's and the MAE decoder's shapes, its forward's first design's
   time (through the kernel's probe, held to the plain version too) and its
   times with parts left out; its forward and backward reruns are
   bit-identical.  The QKV projection with the attention core prints the
   same at both shapes (its forward's first design, the plain version and
   ``F.linear`` + SDPA beside the bound, then its forward without the
   softmax arithmetic, without the projection's products, without the
   prefetch, and the projection alone; its backward beside its first
   design's, held to the plain version too, and each launch of both designs
   timed alone beside its bound), with both ``softmax_f32`` settings, a
   ``valid_len`` below the token count and an odd head count at hd 32; its
   forward and backward reruns are bit-identical.
3. The eval forward: a full-width ViT-B/16 2-class classifier, weights from
   a numpy-seeded tree in the JAX package's layout, answers 8 requests of 64
   uint8 224x224 images through ``make_forward_fn``.  Per request, attention
   and fc1+GELU must launch exactly 12 times and LayerNorm 25 (no backward
   kernel); the logits must be finite and match the same forward with every
   kernel swapped for its plain version.  Prints images/s for both, median
   and range over 5 repeats of 10 requests.  Then the same classifier built
   under ``BENCH_ATTN_PROJ=1``: 12 launches of the attention+projection
   kernel and none of the attention kernel per request, logits against the
   plain path's and the unfolded forward's.
4. The MAE ViT-B/16 pretrain step at full width, batch 64: weights from a
   numpy-seeded JAX-layout tree through ``mae_state_dict_from_jax``; step 1's
   loss and every parameter's gradient against the plain step's; then 6
   steps through ``make_pretrain_step`` with exact launch counts per step
   (the AdamW kernel's 4 among them), finite losses and parameters and both
   sin-cos tables unchanged; then the same 6 steps from the same state with
   every kernel swapped for its plain version.  Prints images/s for both,
   median and range over 5 repeats of 10 further steps, and the model
   TFLOP/s at the median.  Then the model built under ``BENCH_ATTN_PROJ=1``
   (the decoder folds, the encoder at 50 tokens does not): step 1 against
   the plain step, and 2 steps with exact launch counts.
5. The ViT-B/16 classifier's fine-tune step at full width, batch 64 (on-device
   augmentation, BCE, backward, AdamW with fine-tune scales), weights from a
   numpy-seeded JAX-layout tree, under its four kernel configurations: the
   default (fc1+GELU), ``mlp_fusion="full_ln"`` with ``qkv_ln_fusion`` (the
   LN+MLP and LN+QKV kernels), ``mlp_fusion="full"`` (the fused MLP), and
   the default under ``BENCH_ATTN_PROJ=1`` (the attention+projection kernel
   forward and backward, 12 each per step, and no attention kernel).
   For each: step 1's loss and every gradient against the plain step's; 6
   steps with exact launch counts per step, finite losses and parameters;
   2 steps under the ``head+1`` regime, after which every frozen parameter
   keeps its bits; images/s for the kernels and the plain path, median and
   range over 5 repeats of 10 steps.
6. The attention functions over a real activation: the eval classifier's
   patch embedding, position table and block 0's first LayerNorm turn one
   batch of 64 images into a (64, 197, 768) activation; block 0's attention
   core then runs three ways on block 0's own QKV weight and bias: the
   model's route (the bare product, then the QKV attention kernel),
   ``fused_qkvproj_attention`` and ``linear`` -> heads -> ``fused_attention``
   -> merge.  Outputs and, for one fixed output gradient, the gradients of
   the activation, the weight and the bias must agree within the stated
   tolerances, each route with its plain version too; each new kernel must
   launch exactly once forward and once backward per pass, and not at all
   while the plain versions run.
7. The standalone eval CLI at full width: a synthetic pack of 224 px JPEG
   frames (128 a split) and a ViT-B/16 checkpoint (numpy-seeded JAX-layout
   tree, ``model_cfg`` and a thresholds block in its meta) are written with
   the port's own writers; ``cli_main([... "--export-outputs"])`` runs in
   process on the card.  Per batch of 64 the launch counts must be the eval
   forward's; ``n_frames`` 128, finite metrics, the stored tau, ``logits.npz``
   equal to ``make_forward_fn`` on the same decoded frames, and every output
   file present.  Prints frames/s end to end (checkpoint read and decode
   included), of the forward alone, and the host's and the card's shares.

The last two lines of standard output are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero,
and without a CUDA device the script exits non-zero before printing a result.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import statistics
import subprocess
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from ssl4polyp_tpu_torch import ops
from ssl4polyp_tpu_torch.data.loader import HostDataLoader
from ssl4polyp_tpu_torch.data.packs import create_classification_datasets
from ssl4polyp_tpu_torch.evaluation import eval_classification
from ssl4polyp_tpu_torch.evaluation.evaluate import evaluate_split
from ssl4polyp_tpu_torch.models import layers
from ssl4polyp_tpu_torch.models.factory import get_imagenet_or_random_vit
from ssl4polyp_tpu_torch.models.mae import MAE, MAEConfig
from ssl4polyp_tpu_torch.models.pos_embed import sincos_2d
from ssl4polyp_tpu_torch.models.vit import ViTConfig
from ssl4polyp_tpu_torch.models.weights import mae_state_dict_from_jax
from ssl4polyp_tpu_torch.ops import (_build, adamw, attention, attention_block, attn_proj,
                                     layernorm, ln_linear, mlp, qkv_attention)
from ssl4polyp_tpu_torch.polypdb.synth import build_synthetic_pack
from ssl4polyp_tpu_torch.profiling import (FINETUNE_CONFIGS, REPEAT_CALLS, REPEATS,
                                           projection_fold, rates, spread)
from ssl4polyp_tpu_torch.training import optim
from ssl4polyp_tpu_torch.training.classification import (
    TrainContext,
    init_train_state,
    loss_and_grads,
    loss_settings,
    make_forward_fn,
    make_train_step,
)
from ssl4polyp_tpu_torch.data.augment import draw_augment_params, normalize_batch
from ssl4polyp_tpu_torch.training.pretrain import loss_and_grads as pretrain_loss_and_grads
from ssl4polyp_tpu_torch.training.pretrain import (
    PretrainSettings,
    init_pretrain_state,
    make_pretrain_step,
    model_config,
)
from ssl4polyp_tpu_torch.training.schedules import warmup_cosine
from ssl4polyp_tpu_torch.utils.checkpoint import load_checkpoint, save_checkpoint

SEED = 0
BATCH = 64
REQUESTS = 8
STEPS = 6
# |kernel - plain| <= atol + rtol * |plain|, elementwise, in bf16.  The plain
# attention makes the same roundings, so only fp32 summation order and expf
# differ: a flipped bf16 rounding of the output is 1 ulp, 2^-8 relative.  The
# plain fc1 rounds h to bf16 twice (product, bias add) and the kernel once,
# so h and y may differ by up to 2 bf16 ulps (2^-7 relative each).
ATTENTION_TOL = (1e-2, 1e-2)
FC1_TOL = (1e-2, 1.6e-2)
# The attention backward: the plain version makes the same roundings (W, dS,
# dqkv), so a rounding of dS that flips on an fp32 order difference moves
# dQ or dK by |k| or |q| times one bf16 ulp of dS, and a flipped output by an
# ulp: 2e-2 covers both at |dqkv| <= 5.  dbias sums B*N rows of each side's
# own dqkv in fp32: those flips, with random signs, against a column scale
# of hundreds, hence an atol relative to max|dbias|.
ATTENTION_BWD_TOL = (2e-2, 2e-2)
DBIAS_TOL = (2e-3, 2e-2)  # (atol as a fraction of max|plain|, rtol)
# LayerNorm: y and dx are rounded once from fp32 on both sides (one ulp);
# dweight and dbias are fp32 sums over up to 12,608 rows in another order,
# of terms up to ~30, whose rounding error grows like sqrt(rows) * 2^-24.
LN_TOL = (1e-2, 1e-2)
LN_PARAM_TOL = (5e-3, 1e-4)
# Logits after 12 blocks of such 1-ulp differences in the residual stream.
LOGITS_TOL = (5e-2, 5e-2)
# Step 1 of the pretrain step, kernels against plain: the loss after 20
# blocks of 1-ulp differences, relative; each parameter's gradient as the
# relative L2 distance ||g - g_plain|| / ||g_plain||.  On an H100 the loss
# differed by 4.0e-6 relative and the worst gradient by 3.3e-3 (a decoder
# fc2 weight), so the limits sit 25 and 4.5 times above those readings: a
# glue fault that moves a gradient by a few percent fails.  The K slice of
# each qkv bias is left out: its exact gradient is zero (softmax is
# invariant to a shift of the scores along k), so both sides hold rounding
# noise there.
LOSS_RTOL = 1e-4
GRAD_RTOL = 1.5e-2
# The fused kernels' plain versions make the same roundings (m, h, g, the
# output), so only fp32 summation order differs: one bf16 ulp where a
# rounding flips.
FUSED_TOL = (1e-2, 1e-2)
# Step 1 of the fine-tune step, kernels against plain, as for the pretrain
# step.  The classifier's loss is BCE on 64 logit pairs after 12 blocks of
# 1-ulp differences (the eval forward's logits differ by up to 6e-2), so it
# moves far more than the pretrain step's mean over 9,408 patches.  Over
# two runs on an H100 the loss differed by up to 5.2e-3 (fc1), 2.3e-3
# (full_ln+qkv_ln) and 8.8e-4 (full) relative, and the worst gradient by up
# to 1.4e-2, 1.8e-2 and 1.2e-2 (the cls token, which sums every row's): the
# limits sit 4.8 and 2.8 times above the worst readings.
# The attention+projection kernel: y is the attention output (one flipped
# bf16 ulp, times a row of W) through two more roundings on both sides; dqkv
# as the attention backward's.  dW and db are fp32 sums over all 12,608 rows
# in another order than the plain version's, of each side's own bf16 O, then
# rounded to bf16: an atol relative to max|plain|, as for dbias.
ATTN_PROJ_TOL = (1e-2, 1e-2)
ATTN_PROJ_PARAM_TOL = (5e-3, 2e-2)  # (atol as a fraction of max|plain|, rtol)
# Attention over separate q, k, v: the plain forward rounds where the kernel
# does (one flipped bf16 ulp); the plain backward keeps W and dS in fp32
# where the kernel carries them as two bf16 terms (2^-17 relative a term),
# far inside the one bf16 ulp of each rounded gradient: the attention limits.
# Projection + attention: qkv carries a flipped ulp (fp32 summation order of
# the projection) into the core on each side's own roundings, hence twice
# the attention limit on the output; dx, dw and db are sums of each side's
# own rounded dqkv over 3D columns or over all 12,608 rows: an atol relative
# to max|plain|, as for the other parameter sums.
QKVPROJ_TOL = (2e-2, 2e-2)
QKVPROJ_GRAD_TOL = (1e-2, 2e-2)  # (atol as a fraction of max|plain|, rtol)
# The three routes of block 0's attention core on a real activation.  The
# fused projection differs from the model's route by fp32 summation order in
# qkv alone: the same limits as kernel against plain.  The route through
# fused_attention also keeps W and dS unrounded in its backward (at hd 64 the
# scale 1/8 is a power of two, so the forward's scale placement rounds
# nothing): a bf16 ulp of dS per key, summed with random signs.  Gradients
# are held by their relative L2 distance to the model route's; the K slice of
# the bias gradient is left out (its exact value is zero).
ROUTE_OUT_TOL = (2e-2, 2e-2)
ROUTE_GRAD_RTOL = 2e-2
# The card's published peaks (NVIDIA H100 SXM data sheet, dense): the bound
# of a kernel is the larger of its bytes over the memory rate and its
# operations over the rate of their type.
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12
# Cycles the card spins before a timed batch (about 2 ms at 1.7 GHz): longer
# than the host takes to queue 20 launches of one kernel.
SPIN_CYCLES = 3_500_000
FT_LOSS_RTOL = 2.5e-2
FT_GRAD_RTOL = 5e-2
FT_LR = 1e-4
FT_WEIGHT_DECAY = 0.05


def fail(message: str) -> None:
    raise SystemExit(f"chip_smoke: {message}")


def max_error(out: torch.Tensor, ref: torch.Tensor, tol: tuple[float, float], what: str) -> float:
    out, ref = out.float(), ref.float()
    if not torch.isfinite(out).all():
        fail(f"{what}: non-finite output")
    diff = (out - ref).abs()
    atol, rtol = tol
    if (diff > atol + rtol * ref.abs()).any():
        fail(f"{what}: max |diff| {diff.max().item()} exceeds atol {atol} + rtol {rtol}*|ref|")
    return diff.max().item()


def time_ms(fn, iters: int = 20, batches: int = 5) -> float:
    """The median over ``batches`` of the device time of one call in ms.

    Each batch is ``iters`` calls between two CUDA events, after 3 calls to
    warm up.  The card first spins for about 2 ms (``torch.cuda._sleep``), so
    that the host has queued the whole batch before the first call starts:
    the events then bracket the calls running back to back, and a kernel
    shorter than its wrapper's host time is not timed by the wrapper.
    """
    for _ in range(3):
        fn()
    times = []
    for _ in range(batches):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel of the models' paths, forward and backward, for its
    plain torch version."""
    plain = [
        (layers, "fused_qkv_attention", qkv_attention.fused_qkv_attention_plain),
        (layers, "fused_attention_proj", attn_proj.fused_attention_proj_plain),
        (layers, "fc1_gelu", mlp.fc1_gelu_plain),
        (layers, "layernorm", layernorm.layernorm_reference),
        (layers, "ln_linear", ln_linear.ln_linear_plain),
        (layers, "mlp_fused", mlp.mlp_fused_plain),
        (layers, "mlp_ln_fused", mlp.mlp_ln_fused_plain),
        (optim, "adamw_update_fused", optim.adamw_update_fused_plain),
    ]
    saved = [(module, name, getattr(module, name)) for module, name, _ in plain]
    for module, name, fn in plain:
        setattr(module, name, fn)
    try:
        yield
    finally:
        for module, name, fn in saved:
            setattr(module, name, fn)


def bound(bytes_moved: float, flops: float, peak: float = BF16_FLOPS) -> tuple[float, str]:
    """The least time in ms the card could take, and what sets it: the larger
    of ``bytes_moved`` (each input read once, each output written once) over
    the memory rate and ``flops`` over ``peak``, the rate of their type."""
    by_bytes, by_flops = 1e3 * bytes_moved / HBM_BYTES_PER_S, 1e3 * flops / peak
    return max(by_bytes, by_flops), "bytes" if by_bytes >= by_flops else "operations"


def entry(source: str, replaces: str, err: float, ms: float, plain_ms: float, *,
          bytes_moved: float, flops: float, peak: float = BF16_FLOPS,
          library_ms: float | None = None) -> dict:
    """A kernel's line of the summary, with its bound at the timed shape."""
    bound_ms, bound_by = bound(bytes_moved, flops, peak)
    return {"route": "cuda", "source": f"ssl4polyp_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": library_ms}


def bound_text(bytes_moved: float, flops: float, peak: float = BF16_FLOPS) -> str:
    return "bound {:.4f} ms ({})".format(*bound(bytes_moved, flops, peak))


def heads_of(qkv: torch.Tensor, h: int):
    """q, k, v as (B, H, N, hd) views of a (B, N, 3*H*hd) tensor."""
    b, n, three_d = qkv.shape
    return qkv.reshape(b, n, 3, h, three_d // 3 // h).permute(2, 0, 3, 1, 4)


def phase_kernels(gen: torch.Generator) -> dict[str, dict]:
    """Each kernel against its plain version at the paths' shapes."""
    dev = "cuda"

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(dtype)

    report = {}
    # Attention forward: (batch, tokens, heads, head dim, fp32 scores,
    # valid_len, bias).  The third case is the eval path's call, the last two
    # the pretrain encoder's and decoder's.
    cases = [
        (BATCH, 197, 12, 64, True, None, False),
        (BATCH, 197, 12, 64, True, 150, False),
        (BATCH, 197, 12, 64, True, None, True),
        (BATCH, 197, 12, 64, True, 150, True),
        (BATCH, 197, 16, 32, False, None, False),
        (BATCH, 50, 12, 64, False, None, True),
        (BATCH, 197, 16, 32, False, None, True),
    ]
    errors, times = [], {}
    shape_names = {2: "classifier", 5: "MAE encoder", 6: "MAE decoder"}

    def attention_cost(b, n, h, hd):  # qkv and the bias in, the output out; two products
        return dict(bytes_moved=2 * (b * n * 4 * h * hd + 3 * h * hd), flops=4 * b * h * n * n * hd)

    for i, (b, n, h, hd, f32, valid_len, with_bias) in enumerate(cases):
        qkv = randn(b, n, 3 * h * hd)
        bias = randn(3 * h * hd, scale=0.5) if with_bias else None
        run = lambda: qkv_attention.fused_qkv_attention(qkv, h, f32, valid_len, bias)  # noqa: E731
        plain = lambda: qkv_attention.fused_qkv_attention_reference(qkv, h, f32, valid_len, bias)  # noqa: E731
        out, again = run(), run()
        torch.cuda.synchronize()
        what = f"attention B={b} N={n} H={h} hd={hd} f32={f32} valid_len={valid_len} bias={with_bias}"
        errors.append(max_error(out, plain(), ATTENTION_TOL, what))
        if not torch.equal(out, again):
            fail(f"{what}: two runs gave different bits")
        print(f"{what}: max |diff| {errors[-1]:.3e} (atol {ATTENTION_TOL[0]}, rtol "
              f"{ATTENTION_TOL[1]}); rerun bit-identical")
        if i in shape_names:
            q, k, v = heads_of(qkv + bias, h)
            library = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
            times[i] = time_ms(run), time_ms(plain), time_ms(library)
            print(f"  {shape_names[i]}'s shape: kernel {times[i][0]:.4f} ms, plain {times[i][1]:.4f} "
                  f"ms, scaled_dot_product_attention {times[i][2]:.4f} ms, "
                  f"{bound_text(**attention_cost(b, n, h, hd))}")
    report["fused_qkv_attention"] = entry(
        "qkv_attention.cu", "ssl4polyp_tpu/ops/qkv_attention.py:91", max(errors), *times[2][:2],
        **attention_cost(*cases[2][:4]), library_ms=times[2][2])

    # Attention backward against the plain version with the JAX kernel's
    # roundings.  The first two cases are the pretrain path's calls, the
    # last the fine-tune step's (fp32 scores, with bias).
    cases = [
        (BATCH, 50, 12, 64, False, None, True),
        (BATCH, 197, 16, 32, False, None, True),
        (BATCH, 197, 16, 32, False, 150, True),
        (BATCH, 50, 12, 64, False, 40, False),
        (BATCH, 197, 12, 64, False, None, True),
        (8, 197, 16, 32, True, None, False),
        (BATCH, 197, 12, 64, True, None, True),
    ]
    errors, times = [], {}
    bwd_names = {0: "MAE encoder", 1: "MAE decoder", 6: "classifier"}

    def attention_bwd_cost(b, n, h, hd):  # qkv, dout and the bias in, dqkv and dbias out
        return dict(bytes_moved=2 * (b * n * 7 * h * hd + 6 * h * hd),
                    flops=10 * b * h * n * n * hd)

    def backward_probe(qkv, dout, h, f32, valid_len, bias, probe):
        return lambda: qkv_attention._backward_kernel(qkv, dout, h, f32, valid_len, bias, probe)

    for i, (b, n, h, hd, f32, valid_len, with_bias) in enumerate(cases):
        qkv, dout = randn(b, n, 3 * h * hd), randn(b, n, h * hd)
        bias = randn(3 * h * hd, scale=0.5) if with_bias else None
        run = backward_probe(qkv, dout, h, f32, valid_len, bias, 0)
        plain = lambda: qkv_attention.fused_qkv_attention_backward_reference(  # noqa: E731
            qkv, dout, h, f32, valid_len, bias)
        (dqkv, dbias), again = run(), run()
        torch.cuda.synchronize()
        ref_dqkv, ref_dbias = plain()
        plan = qkv_attention.backward_plan(n, hd)
        what = (f"attention backward B={b} N={n} H={h} hd={hd} f32={f32} valid_len={valid_len} "
                f"bias={with_bias}")
        errors.append(max_error(dqkv, ref_dqkv, ATTENTION_BWD_TOL, f"{what}: dqkv"))
        line = f"{what}: dqkv max |diff| {errors[-1]:.3e} (atol {ATTENTION_BWD_TOL[0]}, rtol {ATTENTION_BWD_TOL[1]})"
        if with_bias:
            tol = (DBIAS_TOL[0] * ref_dbias.float().abs().max().item(), DBIAS_TOL[1])
            err = max_error(dbias, ref_dbias, tol, f"{what}: dbias")
            line += f", dbias {err:.3e} (atol {tol[0]:.3e}, rtol {tol[1]})"
        if not torch.equal(dqkv, again[0]) or (with_bias and not torch.equal(dbias, again[1])):
            fail(f"{what}: two runs gave different bits")
        print(line + f"; rerun bit-identical; path: {plan['path']}, {plan['warps']} warps a "
              f"block, {plan['smem_bytes']} bytes of shared memory")
        if i in bwd_names:
            leaf = (qkv + bias).requires_grad_()
            out = F.scaled_dot_product_attention(*heads_of(leaf, h)).transpose(1, 2).reshape(
                dout.shape)
            library = lambda: torch.autograd.grad(out, leaf, dout, retain_graph=True)  # noqa: E731
            first = backward_probe(qkv, dout, h, f32, valid_len, bias,
                                   qkv_attention.PROBE_FIRST_DESIGN)
            first_err = max_error(first()[0], ref_dqkv, ATTENTION_BWD_TOL, f"{what}: first design")
            times[i] = time_ms(run), time_ms(plain), time_ms(library), time_ms(first)
            print(f"  {bwd_names[i]}'s shape: kernel {times[i][0]:.4f} ms, first design "
                  f"{times[i][3]:.4f} ms (dqkv {first_err:.3e}), plain {times[i][1]:.4f} "
                  f"ms, scaled_dot_product_attention's backward {times[i][2]:.4f} ms, "
                  f"{bound_text(**attention_bwd_cost(b, n, h, hd))}")
            # Where the time goes: the kernel with parts left out (wrong
            # results, timed only).
            ablations = {
                "without phase B": qkv_attention.PROBE_NO_PHASE_B,
                "phase A stopped after the softmax": qkv_attention.PROBE_NO_PHASE_A_BACKWARD,
                "staging and the softmax alone": (qkv_attention.PROBE_NO_PHASE_B
                                                  | qkv_attention.PROBE_NO_PHASE_A_BACKWARD),
                "phase B's weights without the exponential": qkv_attention.PROBE_NO_EXP_B,
            }
            print(f"  {bwd_names[i]}'s shape, ablations (wrong results, timed only): " + ", ".join(
                f"{name} {time_ms(backward_probe(qkv, dout, h, f32, valid_len, bias, probe)):.4f} ms"
                for name, probe in ablations.items()))
            del leaf, out
    report["fused_qkv_attention_backward"] = entry(
        "qkv_attention.cu", "ssl4polyp_tpu/ops/qkv_attention.py:108", max(errors), *times[6][:2],
        **attention_bwd_cost(*cases[6][:4]), library_ms=times[6][2])

    # LayerNorm forward and backward: the pretrain encoder's and decoder's
    # rows, then the eval forward's.  The plain backward is autograd's of the
    # plain forward, timed alone.
    fwd_errors, bwd_errors, fwd_times, bwd_times = [], [], {}, {}
    ln_shapes = [(BATCH * 50, 768), (BATCH * 197, 512), (BATCH * 197, 768)]
    ln_names = ["MAE encoder", "MAE decoder", "classifier"]

    def ln_cost(m, d):  # x in and y out in bf16, the fp32 affine in
        return dict(bytes_moved=4 * m * d + 8 * d, flops=8 * m * d, peak=FP32_FLOPS)

    # x, dy (and dres) in, dx out in bf16; the weight in, both gradients out
    def ln_bwd_cost(m, d, dres=False):
        return dict(bytes_moved=(8 if dres else 6) * m * d + 12 * d,
                    flops=(13 if dres else 12) * m * d, peak=FP32_FLOPS)

    for i, (m, d) in enumerate(ln_shapes):
        x, dy = randn(m, d), randn(m, d)
        w = 1.0 + 0.1 * randn(d, dtype=torch.float32)
        bias = 0.1 * randn(d, dtype=torch.float32)
        run = lambda: layernorm._forward_kernel(x, w, bias, 1e-6)  # noqa: E731
        plain = lambda: layernorm.layernorm_reference(x, w, bias, 1e-6)  # noqa: E731
        run_bwd = lambda: layernorm._backward_kernel(x, dy, w, 1e-6)  # noqa: E731
        y, (dx, dw, db), again = run(), run_bwd(), run_bwd()
        torch.cuda.synchronize()
        leaves = [t.clone().requires_grad_() for t in (x, w, bias)]
        ref = layernorm.layernorm_reference(*leaves, 1e-6)
        plain_bwd = lambda: torch.autograd.grad(ref, leaves, dy, retain_graph=True)  # noqa: E731
        ref_dx, ref_dw, ref_db = plain_bwd()
        what = f"layernorm ({m}, {d})"
        fwd_errors.append(max_error(y, plain(), LN_TOL, f"{what}: y"))
        bwd_errors.append(max_error(dx, ref_dx, LN_TOL, f"{what}: dx"))
        param_err = max(max_error(dw, ref_dw, LN_PARAM_TOL, f"{what}: dweight"),
                        max_error(db, ref_db, LN_PARAM_TOL, f"{what}: dbias"))
        if not all(torch.equal(a, b) for a, b in zip((dx, dw, db), again)):
            fail(f"{what}: two backward runs gave different bits")
        # The variant the LN+MLP kernel's backward calls: a residual's
        # gradient added to dx in fp32 before its one rounding.
        dres = randn(m, d)
        run_dres = lambda: layernorm._backward_kernel(x, dy, w, 1e-6, dres)  # noqa: E731
        with_dres, dres_again = run_dres(), run_dres()
        ref_dres = ln_linear.layernorm_backward(x, w, dy, 1e-6, True, dres)
        bwd_errors.append(max_error(with_dres[0], ref_dres[0], LN_TOL, f"{what}: dx + dres"))
        dres_param_err = max(
            max_error(with_dres[1], ref_dres[1], LN_PARAM_TOL, f"{what}: dweight (dres)"),
            max_error(with_dres[2], ref_dres[2], LN_PARAM_TOL, f"{what}: dbias (dres)"))
        if not all(torch.equal(a, b) for a, b in zip(with_dres, dres_again)):
            fail(f"{what}: two backward runs with dres gave different bits")
        print(f"{what}: y max |diff| {fwd_errors[-1]:.3e}, dx {bwd_errors[-2]:.3e}, with dres "
              f"{bwd_errors[-1]:.3e} (atol {LN_TOL[0]}, rtol {LN_TOL[1]}); dweight, dbias "
              f"{param_err:.3e}, with dres {dres_param_err:.3e} (atol {LN_PARAM_TOL[0]}, rtol "
              f"{LN_PARAM_TOL[1]}); reruns bit-identical")
        # The library call takes its affine in the input's dtype.
        lib_leaves = [x.clone().requires_grad_(), w.bfloat16().requires_grad_(),
                      bias.bfloat16().requires_grad_()]
        library = lambda: F.layer_norm(lib_leaves[0], (d,), lib_leaves[1], lib_leaves[2], 1e-6)  # noqa: E731
        lib_y = library()
        library_bwd = lambda: torch.autograd.grad(lib_y, lib_leaves, dy, retain_graph=True)  # noqa: E731
        fwd_times[i] = time_ms(run), time_ms(plain), time_ms(library)
        bwd_times[i] = time_ms(run_bwd), time_ms(plain_bwd), time_ms(library_bwd)
        print(f"  {ln_names[i]}'s shape: forward kernel {fwd_times[i][0]:.4f} ms, plain "
              f"{fwd_times[i][1]:.4f} ms, F.layer_norm {fwd_times[i][2]:.4f} ms, "
              f"{bound_text(**ln_cost(m, d))}; backward kernel {bwd_times[i][0]:.4f} ms, plain "
              f"{bwd_times[i][1]:.4f} ms, F.layer_norm's {bwd_times[i][2]:.4f} ms, "
              f"{bound_text(**ln_bwd_cost(m, d))}")
        # The backward's two launches apart (one plan: the same buffers), then
        # the dres variant, whole.
        launch, _ = layernorm._backward_plan(x, dy, w, 1e-6)
        rows_ms, sum_ms = (time_ms(lambda: launch(layernorm.BACKWARD_PARTS[part]))  # noqa: B023
                           for part in ("rows", "sum"))
        blocks = _build.library().ssl4polyp_layernorm_bwd_blocks(m, d)
        part_bytes = 8 * blocks * d  # (blocks, 2, D) fp32
        plain_dres = lambda: ln_linear.layernorm_backward(x, w, dy, 1e-6, True, dres)  # noqa: E731
        rows_bound = bound_text(6 * m * d + 4 * d + part_bytes, 12 * m * d, FP32_FLOPS)
        sum_bound = bound_text(part_bytes + 8 * d, 2 * blocks * d, FP32_FLOPS)
        print(f"    backward's row kernel {rows_ms:.4f} ms, {rows_bound}; the sum of its "
              f"{blocks} partial rows {sum_ms:.4f} ms, {sum_bound}; with dres, whole "
              f"{time_ms(run_dres):.4f} ms, plain {time_ms(plain_dres):.4f} ms, "
              f"{bound_text(**ln_bwd_cost(m, d, True))}")
    m, d = ln_shapes[2]  # the classifier's
    report["layernorm"] = entry(
        "layernorm.cu", "ssl4polyp_tpu/ops/layernorm.py:32", max(fwd_errors), *fwd_times[2][:2],
        **ln_cost(m, d), library_ms=fwd_times[2][2])
    report["layernorm_backward"] = entry(
        "layernorm.cu", "ssl4polyp_tpu/ops/layernorm.py:69", max(bwd_errors), *bwd_times[2][:2],
        **ln_bwd_cost(m, d), library_ms=bwd_times[2][2])

    # fc1+GELU: the pretrain calls and the fine-tune step's write h for the
    # backward; the eval call writes y only.
    errors, times = [], {}
    fc1_shapes = [("MAE encoder", BATCH * 50, 768, 3072, True),
                  ("MAE decoder", BATCH * 197, 512, 2048, True),
                  ("classifier", BATCH * 197, 768, 3072, False),
                  ("classifier (fine-tune)", BATCH * 197, 768, 3072, True)]

    def fc1_cost(m, k, nf, write_h):  # x, w and the bias in; y, and h when asked, out
        return dict(bytes_moved=2 * (m * k + nf * k + nf + (2 if write_h else 1) * m * nf),
                    flops=2 * m * k * nf)

    for i, (name, m, k, nf, write_h) in enumerate(fc1_shapes):
        x, w, bias = randn(m, k), randn(nf, k, scale=k ** -0.5), randn(nf, scale=0.5)
        run = lambda: mlp._kernel(x, w, bias, write_h)  # noqa: E731
        plain = lambda: mlp.fc1_gelu_reference(x, w, bias)  # noqa: E731
        (h, y), (h2, y2) = run(), run()
        torch.cuda.synchronize()
        what = f"fc1_gelu ({m}, {k}) -> {nf}, h written: {write_h}"
        errors.append(max_error(y, plain(), FC1_TOL, f"{what}: y"))
        if write_h:
            errors.append(max_error(h, torch.matmul(x, w.t()) + bias, FC1_TOL, f"{what}: h"))
        if not torch.equal(y, y2) or (write_h and not torch.equal(h, h2)):
            fail(f"{what}: two runs gave different bits")
        library = lambda: F.gelu(F.linear(x, w, bias))  # noqa: E731
        times[i] = time_ms(run), time_ms(plain), time_ms(library)
        print(f"{what}: max |diff| {max(errors[-2:]):.3e} (atol {FC1_TOL[0]}, rtol {FC1_TOL[1]}); "
              f"rerun bit-identical")
        print(f"  {name}'s shape: kernel {times[i][0]:.4f} ms, plain {times[i][1]:.4f} ms, "
              f"F.linear + F.gelu {times[i][2]:.4f} ms, {bound_text(**fc1_cost(m, k, nf, write_h))}")
    report["fc1_gelu"] = entry(
        "mlp.cu", "ssl4polyp_tpu/ops/mlp.py:73", max(errors), *times[2][:2],
        **fc1_cost(*fc1_shapes[2][1:]), library_ms=times[2][2])

    # The same kernel with a bare epilogue (ssl4polyp_matmul_nt): the dx product
    # of fused_qkvproj_attention's backward, then fc1's shape without its
    # bias and GELU, which prices the epilogue.
    lib = _build.library()
    for what, m, k, nf in (("dx of fused_qkvproj_attention", BATCH * 197, 2304, 768),
                           ("fc1's shape, bare epilogue", BATCH * 197, 768, 3072)):
        x, w = randn(m, k), randn(nf, k, scale=k ** -0.5)
        outs = [torch.empty((m, nf), dtype=x.dtype, device=dev) for _ in range(2)]

        def run(y=outs[0]):
            err = lib.ssl4polyp_matmul_nt(x.data_ptr(), w.data_ptr(), y.data_ptr(), m, k, nf,
                                          torch.cuda.current_stream().cuda_stream)
            if err:
                fail(f"matmul_nt launch failed: CUDA error {err}")

        run()
        run(outs[1])
        torch.cuda.synchronize()
        library = lambda: torch.matmul(x, w.t())  # noqa: E731
        err = max_error(outs[0], library(), FUSED_TOL, f"matmul_nt ({m}, {k}) -> {nf}")
        if not torch.equal(*outs):
            fail(f"matmul_nt ({m}, {k}) -> {nf}: two runs gave different bits")
        cost = dict(bytes_moved=2 * (m * k + nf * k + m * nf), flops=2 * m * k * nf)
        print(f"matmul_nt ({m}, {k}) -> {nf} ({what}): max |diff| {err:.3e} (atol {FUSED_TOL[0]}, "
              f"rtol {FUSED_TOL[1]}); rerun bit-identical; kernel {time_ms(run):.4f} ms, "
              f"torch.matmul {time_ms(library):.4f} ms, {bound_text(**cost)}")

    # The fine-tune path's fused kernels at its shapes, then the MAE
    # decoder's.  Beside the plain version (fp32 products of the rounded
    # operands, the kernels' roundings) is timed the fastest unfused bf16
    # chain: the LayerNorm kernel, cuBLAS products, bias adds and GELU; for
    # LN+QKV also cuBLAS's addmm alone on a normalised row made beforehand.
    def affine(d):
        return 1.0 + 0.1 * randn(d, dtype=torch.float32), 0.1 * randn(d, dtype=torch.float32)

    def ln_linear_cost(m, k, n):  # x, w, b and the affine in, out out
        return dict(bytes_moved=2 * (m * k + n * k + n + m * n) + 8 * k, flops=2 * m * k * n)

    ln_ablations = {"without the normalisation": ln_linear.PROBE_NO_NORMALISE,
                    "without the statistics launch": ln_linear.PROBE_NO_STATS,
                    "bare epilogue": ln_linear.PROBE_BARE_EPILOGUE,
                    "the other tile width": ln_linear.PROBE_OTHER_WIDTH}
    errors, times = [], {}
    for i, (shape, m, k, n) in enumerate([("classifier", BATCH * 197, 768, 2304),
                                          ("MAE decoder", BATCH * 197, 512, 1536)]):
        x, (s, t) = randn(m, k), affine(k)
        w, bias = randn(n, k, scale=k ** -0.5), randn(n, scale=0.5)

        def probe_run(probe, w=w, bias=bias):
            return lambda: ln_linear._kernel(x, s, t, w, bias, 1e-6, probe)

        run, first = probe_run(0), probe_run(ln_linear.PROBE_FIRST_DESIGN)
        plain = lambda: ln_linear.ln_linear_reference(x, s, t, w, bias, 1e-6)  # noqa: E731
        unfused = lambda: layers.linear(layernorm._forward_kernel(x, s, t, 1e-6), w, bias)  # noqa: E731
        m_ready = layernorm._forward_kernel(x, s, t, 1e-6)
        addmm = lambda: torch.addmm(bias, m_ready, w.t())  # noqa: E731
        out, again, first_out = run(), run(), first()
        other_out = probe_run(ln_linear.PROBE_OTHER_WIDTH)()
        # The C entry point for a caller without scratch (the stream's pool).
        entry_out = torch.empty_like(out)
        rc = lib.ssl4polyp_ln_linear_fwd(x.data_ptr(), s.data_ptr(), t.data_ptr(), w.data_ptr(),
                                         bias.data_ptr(), entry_out.data_ptr(), m, k, n, 1e-6,
                                         torch.cuda.current_stream().cuda_stream)
        # With W = I and b = 0 the output is m itself: bit-equal to the first
        # design's, the statistics, the formula and its rounding are unchanged.
        eye = torch.eye(k, dtype=torch.bfloat16, device=dev)
        zero = torch.zeros(k, dtype=torch.bfloat16, device=dev)
        m_new = probe_run(0, eye, zero)()
        m_first = probe_run(ln_linear.PROBE_FIRST_DESIGN, eye, zero)()
        torch.cuda.synchronize()
        what = f"ln_linear ({m}, {k}) -> {n}"
        ref = plain()
        errors.append(max_error(out, ref, FUSED_TOL, what))
        first_err = max_error(first_out, ref, FUSED_TOL, f"{what}: first design")
        max_error(other_out, ref, FUSED_TOL, f"{what}: the other tile width")
        if not torch.equal(out, again):
            fail(f"{what}: two runs gave different bits")
        if rc or not torch.equal(out, entry_out):
            fail(f"{what}: ssl4polyp_ln_linear_fwd (rc {rc}) differs from the wrapper's launch")
        if not torch.equal(m_new, m_first):
            fail(f"{what}, W = I: m differs from the first design's")
        times[i] = time_ms(run), time_ms(plain), time_ms(unfused), time_ms(first), time_ms(addmm)
        print(f"{what}: max |diff| {errors[-1]:.3e} (atol {FUSED_TOL[0]}, rtol {FUSED_TOL[1]}); "
              f"rerun and ssl4polyp_ln_linear_fwd bit-identical; W = I: m bit-equal to the "
              f"first design's")
        print(f"  {shape}'s shape: kernel {times[i][0]:.4f} ms, first design {times[i][3]:.4f} ms "
              f"(max |diff| {first_err:.3e}), plain {times[i][1]:.4f} ms, unfused bf16 chain "
              f"{times[i][2]:.4f} ms, torch.addmm on a ready m {times[i][4]:.4f} ms, "
              f"{bound_text(**ln_linear_cost(m, k, n))}")
        print(f"  {shape}'s shape, ablations (wrong results but the other width's, timed only): "
              + ", ".join(f"{label} {time_ms(probe_run(probe)):.4f} ms"
                          for label, probe in ln_ablations.items()))
    report["ln_linear"] = entry(
        "ln_linear.cu", "ssl4polyp_tpu/ops/ln_linear.py:28", max(errors), *times[0][:2],
        **ln_linear_cost(BATCH * 197, 768, 2304))

    report.update(fused_mlp_kernels(randn))
    report.update(attn_proj_kernels(randn))
    report.update(attention_ops_kernels(randn))
    report.update(adamw_kernel(gen))
    return report


def fused_mlp_kernels(randn) -> dict[str, dict]:
    """The fused MLPs: the kernel, its first design (through the probe, in this
    process), the plain version, the unfused chain and the bound at the
    classifier's and the MAE decoder's shapes, and the kernel with parts left
    out (wrong results, timed only)."""
    def affine(d):
        return 1.0 + 0.1 * randn(d, dtype=torch.float32), 0.1 * randn(d, dtype=torch.float32)

    def fused_cost(m, k, nf, with_ln):  # x, W1, b1, W2, b2 (and the affine) in; h and out out
        return dict(bytes_moved=2 * (2 * m * k + 2 * nf * k + nf + k + m * nf)
                    + (8 * k if with_ln else 0), flops=4 * m * k * nf)

    report = {}
    ablations = {"without fc2's products": mlp.FUSED_PROBE_NO_FC2,
                 "without fc1's epilogue": mlp.FUSED_PROBE_NO_EPILOGUE,
                 "without fc1's products": mlp.FUSED_PROBE_NO_FC1,
                 "the products alone (no loads, no epilogue)": (mlp.FUSED_PROBE_NO_LOADS
                                                                | mlp.FUSED_PROBE_NO_EPILOGUE),
                 "the loads alone": (mlp.FUSED_PROBE_NO_FC1 | mlp.FUSED_PROBE_NO_FC2
                                     | mlp.FUSED_PROBE_NO_EPILOGUE),
                 "clusters of 4": mlp.FUSED_PROBE_CLUSTER_4,
                 "clusters of 1 (no multicast)": mlp.FUSED_PROBE_CLUSTER_1}
    for name, with_ln, line in (("mlp_fused", False, 188), ("mlp_ln_fused", True, 332)):
        errors, times = [], {}
        for i, (shape, m, k, nf) in enumerate([("classifier", BATCH * 197, 768, 3072),
                                               ("MAE decoder", BATCH * 197, 512, 2048)]):
            x = randn(m, k)
            s, t = affine(k) if with_ln else (None, None)
            w1, b1 = randn(nf, k, scale=k ** -0.5), randn(nf, scale=0.5)
            w2, b2 = randn(k, nf, scale=nf ** -0.5), randn(k, scale=0.5)

            def probe_run(probe, write_h=True):
                return lambda: mlp._fused_kernel(x, s, t, w1, b1, w2, b2, 1e-6, write_h, probe)

            run, first = probe_run(0), probe_run(mlp.FUSED_PROBE_FIRST_DESIGN)
            plain = lambda: mlp._mlp_forward_plain(x, s, t, w1, b1, w2, b2, 1e-6)  # noqa: E731

            def unfused():
                a = x if s is None else layernorm._forward_kernel(x, s, t, 1e-6)
                out = layers.linear(mlp.fc1_gelu_reference(a, w1, b1), w2, b2)
                return out if s is None else x + out

            (h, out), (h2, out2), (_, out3) = run(), run(), probe_run(0, False)()
            first_h, first_out = first()
            torch.cuda.synchronize()
            what = f"{name} ({m}, {k}) -> {nf} -> {k}, h written"
            ref_h, ref_out = plain()
            errors.append(max(max_error(h, ref_h, FUSED_TOL, f"{what}: h"),
                              max_error(out, ref_out, FUSED_TOL, f"{what}: out")))
            first_err = max(max_error(first_h, ref_h, FUSED_TOL, f"{what}: first design's h"),
                            max_error(first_out, ref_out, FUSED_TOL, f"{what}: first design's out"))
            if not (torch.equal(h, h2) and torch.equal(out, out2)):
                fail(f"{what}: two runs gave different bits")
            if not torch.equal(out, out3):
                fail(f"{what}: out differs without h")
            times[i] = time_ms(run), time_ms(plain), time_ms(unfused), time_ms(first)
            print(f"{what}: max |diff| {errors[-1]:.3e} (atol {FUSED_TOL[0]}, rtol "
                  f"{FUSED_TOL[1]}); rerun and without h bit-identical")
            print(f"  {shape}'s shape: kernel {times[i][0]:.4f} ms, without h "
                  f"{time_ms(probe_run(0, False)):.4f} ms, first design {times[i][3]:.4f} ms "
                  f"(max |diff| {first_err:.3e}), plain {times[i][1]:.4f} ms, unfused bf16 chain "
                  f"{times[i][2]:.4f} ms, {bound_text(**fused_cost(m, k, nf, with_ln))}")
            print(f"  {shape}'s shape, ablations (wrong results but the clusters', timed only): "
                  + ", ".join(f"{label} {time_ms(probe_run(probe)):.4f} ms"
                              for label, probe in ablations.items()))
        m, k, nf = BATCH * 197, 768, 3072
        report[name] = entry(
            "mlp.cu", f"ssl4polyp_tpu/ops/mlp.py:{line}", max(errors), *times[0][:2],
            **fused_cost(m, k, nf, with_ln))
    return report


def attn_proj_cost(b, n, h, hd):
    """The attention+projection kernel's bytes and operations, forward and
    backward: qkv, W, b (and dy) in, y (and dqkv, dW, db) out once."""
    d = h * hd
    core, proj = b * h * n * n * hd, b * n * d * d
    return (dict(bytes_moved=2 * (4 * b * n * d + d * d + d), flops=4 * core + 2 * proj),
            dict(bytes_moved=2 * (7 * b * n * d + 2 * d * d + d), flops=10 * core + 6 * proj))


def qkvproj_cost(b, n, d_in, h, hd):
    """The projection + attention kernel's bytes and operations, forward and
    backward: x, W, b (and dout) in, out (and dx, dW, db) out once."""
    d = h * hd
    core, proj = b * h * n * n * hd, b * n * d_in * 3 * d
    return (dict(bytes_moved=2 * (b * n * (d_in + d) + d_in * 3 * d + 3 * d),
                 flops=2 * proj + 4 * core),
            dict(bytes_moved=2 * (b * n * (2 * d_in + d) + 2 * (d_in * 3 * d + 3 * d)),
                 flops=6 * proj + 10 * core))


def qkvproj_backward_split(x, w, bias, dout, h, f32, first_design: bool) -> dict[str, tuple]:
    """The projection + attention backward's launches, each timed alone on one
    plan's buffers (each finds what the earlier ones left there), of the
    first design or the second: {step: (ms, bound text)}.  The first design
    has no transpose or projection launch: its attention kernel recomputes qkv
    per head."""
    b, n, d_in = x.shape
    three_d = w.shape[1]
    m, hd = b * n, three_d // 3 // h
    run, _ = attention_block._backward_plan(x, w, bias, dout, h, f32, None, first_design)
    run(0)
    slices = (attention_block._FIRST_DESIGN_DW_SLICES if first_design
              else _build.library().ssl4polyp_dw_product_slices(m, d_in, three_d))
    product = dict(flops=2 * m * d_in * three_d)
    act = 2 * m * three_d  # a (B, N, 3D) bf16 tensor's bytes
    cost = {  # what each reads and writes once, and its operations
        "transpose": dict(bytes_moved=4 * d_in * three_d, flops=0),
        "projection": dict(bytes_moved=2 * m * d_in + 2 * d_in * three_d + act, **product),
        "attention": dict(bytes_moved=2 * act + 2 * m * three_d // 3 + 2 * three_d
                          + 4 * b * three_d + (2 * m * d_in + 2 * d_in * three_d
                                               if first_design else 0),
                          flops=10 * b * h * n * n * hd
                          + (2 * m * d_in * three_d if first_design else 0)),
        "db sum": dict(bytes_moved=4 * (b + 1) * three_d, flops=b * three_d, peak=FP32_FLOPS),
        "dx": dict(bytes_moved=act + 2 * d_in * three_d + 2 * m * d_in, **product),
        "dw": dict(bytes_moved=2 * m * d_in + act + 4 * slices * d_in * three_d, **product),
        "dw sum": dict(bytes_moved=4 * (slices + 1) * d_in * three_d if slices > 1 else 0,
                       flops=slices * d_in * three_d, peak=FP32_FLOPS),
    }
    skip = ("transpose", "projection") if first_design else ()
    return {step: (time_ms(lambda: run(bit)), bound_text(**cost[step]))  # noqa: B023
            for step, bit in attention_block.BACKWARD_STEPS.items() if step not in skip}


def attn_proj_kernels(randn) -> dict[str, dict]:
    """The attention+projection kernel, forward and backward, against its
    plain version: the classifier's call (fp32 scores), the MAE decoder's
    (16 heads of 32, bf16 scores) and a padded one (keys past ``valid_len``
    masked, the pad rows' upstream gradient zero).  Beside each, the library
    route for the same function: scaled_dot_product_attention and F.linear,
    and their autograd backward."""
    fwd_errors, bwd_errors, fwd_times, bwd_times = [], [], {}, {}
    cases = [(BATCH, 197, 12, 64, True, None), (BATCH, 197, 16, 32, False, None),
             (BATCH, 197, 12, 64, True, 150)]
    for i, (b, n, h, hd, f32, valid_len) in enumerate(cases):
        d = h * hd
        qkv, dy = randn(b, n, 3 * d), randn(b, n, d)
        w, bias = randn(d, d, scale=d ** -0.5), randn(d, scale=0.5)
        rows = n if valid_len is None else valid_len
        dy[:, rows:] = 0
        run = lambda: attn_proj._forward_kernel(qkv, w, bias, h, f32, valid_len)  # noqa: E731
        plain = lambda: attn_proj.fused_attention_proj_reference(qkv, w, bias, h, f32, valid_len)  # noqa: E731
        run_bwd = lambda: attn_proj._backward_kernel(qkv, w, bias, dy, h, f32, valid_len)  # noqa: E731
        plain_bwd = lambda: attn_proj.fused_attention_proj_backward_reference(  # noqa: E731
            qkv, w, bias, dy, h, f32, valid_len)
        y, grads, again = run(), run_bwd(), run_bwd()
        torch.cuda.synchronize()
        what = f"attn_proj B={b} N={n} H={h} hd={hd} f32={f32} valid_len={valid_len}"
        fwd_errors.append(max_error(y[:, :rows], plain()[:, :rows], ATTN_PROJ_TOL, f"{what}: y"))
        ref = plain_bwd()
        bwd_errors.append(max_error(grads[0], ref[0], ATTENTION_BWD_TOL, f"{what}: dqkv"))
        line = (f"{what}: y max |diff| {fwd_errors[-1]:.3e} (atol {ATTN_PROJ_TOL[0]}, rtol "
                f"{ATTN_PROJ_TOL[1]}), dqkv {bwd_errors[-1]:.3e} (atol {ATTENTION_BWD_TOL[0]}, "
                f"rtol {ATTENTION_BWD_TOL[1]})")
        for name, got, want in (("dw", grads[1], ref[1]), ("db", grads[2], ref[2])):
            tol = (ATTN_PROJ_PARAM_TOL[0] * want.float().abs().max().item(), ATTN_PROJ_PARAM_TOL[1])
            err = max_error(got, want, tol, f"{what}: {name}")
            line += f", {name} {err:.3e} (atol {tol[0]:.3e}, rtol {tol[1]})"
        if not all(torch.equal(a, g) for a, g in zip(again, grads)):
            fail(f"{what}: two backward runs gave different bits")
        print(line + "; rerun bit-identical")
        if valid_len is not None:
            continue
        leaves = [t.clone().requires_grad_() for t in (qkv, w, bias)]

        def library(leaves=leaves):
            out = F.scaled_dot_product_attention(*heads_of(leaves[0], h))
            return F.linear(out.transpose(1, 2).reshape(b, n, d), leaves[1], leaves[2])

        lib_y = library()
        library_bwd = lambda: torch.autograd.grad(lib_y, leaves, dy, retain_graph=True)  # noqa: E731
        with torch.no_grad():
            fwd_times[i] = time_ms(run), time_ms(plain), time_ms(library)
        bwd_times[i] = time_ms(run_bwd), time_ms(plain_bwd), time_ms(library_bwd)
        fwd_cost, bwd_cost = attn_proj_cost(b, n, h, hd)
        print(f"  forward kernel {fwd_times[i][0]:.4f} ms, plain {fwd_times[i][1]:.4f} ms, "
              f"scaled_dot_product_attention + F.linear {fwd_times[i][2]:.4f} ms, "
              f"{bound_text(**fwd_cost)}; backward kernels {bwd_times[i][0]:.4f} ms, plain "
              f"{bwd_times[i][1]:.4f} ms, the library pair's {bwd_times[i][2]:.4f} ms, "
              f"{bound_text(**bwd_cost)}")
        # The backward's four phases apart, on one plan's buffers (each phase
        # finds what the earlier ones left there), each beside its bound.
        core, proj, act = b * h * n * n * hd, b * n * d * d, 2 * b * n * d
        launch, _ = attn_proj._backward_plan(qkv, w, bias, dy, h, f32, valid_len)
        launch(sum(attn_proj.BACKWARD_PHASES.values()))
        phase_cost = {  # (what it reads and writes once, its operations, their peak rate)
            "prep": (3 * act + act + 2 * act + 4 * d * d, 4 * core + 2 * proj, BF16_FLOPS),
            "dw": (2 * act + 4 * d * d, 2 * proj, BF16_FLOPS),
            "db": (act + 4 * d, b * n * d, FP32_FLOPS),
            "attention": (3 * act + act + 3 * act, 10 * core, BF16_FLOPS),
        }
        phase_ms = {phase: time_ms(lambda: launch(bit))  # noqa: B023
                    for phase, bit in attn_proj.BACKWARD_PHASES.items()}
        dw_first_ms = time_ms(lambda: launch(attn_proj.DW_FIRST_DESIGN_PHASE))  # noqa: B023
        print("    backward's phases: " + "; ".join(
            f"{phase} {ms:.4f} ms, {bound_text(*phase_cost[phase])}"
            for phase, ms in phase_ms.items())
            + f"; dw on its first design (mma.sync) {dw_first_ms:.4f} ms")
        # Where the forward's time goes: the kernel without its attention
        # arithmetic, without its projection's products, without both (wrong
        # results; the copies, barriers, W ring and stores stay).
        with torch.no_grad():
            ablated = [time_ms(lambda: attn_proj._forward_kernel(  # noqa: B023
                qkv, w, bias, h, f32, valid_len, ablate)) for ablate in (1, 2, 3)]
        print("    forward without the attention arithmetic {:.4f} ms, without the wgmma "
              "{:.4f} ms, without both {:.4f} ms".format(*ablated))
        del leaves, lib_y
    fwd_cost, bwd_cost = attn_proj_cost(*cases[0][:4])
    return {
        "attn_proj": entry(
            "attn_proj.cu", "ssl4polyp_tpu/ops/attn_proj.py:77", max(fwd_errors),
            *fwd_times[0][:2], **fwd_cost, library_ms=fwd_times[0][2]),
        "attn_proj_backward": entry(
            "attn_proj.cu", "ssl4polyp_tpu/ops/attn_proj.py:90", max(bwd_errors),
            *bwd_times[0][:2], **bwd_cost, library_ms=bwd_times[0][2]),
    }


def attention_ops_kernels(randn) -> dict[str, dict]:
    """The two attention functions of ``ops`` that no model route calls,
    forward and backward, against their plain versions at the classifier's
    shape and the MAE decoder's: attention over separate q, k, v (each
    direction also through its first design, held to the plain version, and
    timed with parts left out, through the kernels' probes), and the QKV
    projection with the attention core (both ``softmax_f32`` settings and a
    ``valid_len`` below the token count).  Beside each, the library route
    for the same function, timed only, and the bound."""
    report = {}
    fwd_errors, bwd_errors, fwd_times, bwd_times = [], [], {}, {}
    fwd_ablations = {"without the softmax arithmetic": attention.PROBE_NO_SOFTMAX,
                     "without P.V": attention.PROBE_NO_VALUES,
                     "without the prefetch": attention.PROBE_NO_PREFETCH,
                     "without the exponential": attention.PROBE_NO_EXP}
    bwd_ablations = {"without phase B": attention.BACKWARD_PROBE_NO_PHASE_B,
                     "phase A stopped after the softmax": attention.BACKWARD_PROBE_SOFTMAX_ONLY,
                     "phase A's softmax alone": (attention.BACKWARD_PROBE_SOFTMAX_ONLY
                                                 | attention.BACKWARD_PROBE_NO_PHASE_B),
                     "without the second terms": attention.BACKWARD_PROBE_ONE_TERM,
                     "without the prefetch": attention.BACKWARD_PROBE_NO_PREFETCH}
    for i, (b, h, n, hd) in enumerate([(BATCH, 12, 197, 64), (BATCH, 16, 197, 32)]):
        q, k, v, dout = (randn(b, h, n, hd) for _ in range(4))

        def probe_run(probe, q=q, k=k, v=v):
            return lambda: attention._forward_kernel(q, k, v, probe)

        run, first = probe_run(0), probe_run(attention.PROBE_FIRST_DESIGN)
        plain = lambda: attention.fused_attention_reference(q, k, v)  # noqa: E731

        def probe_bwd(probe, q=q, k=k, v=v, dout=dout):
            return lambda: attention._backward_kernel(q, k, v, dout, probe)

        run_bwd, first_bwd = probe_bwd(0), probe_bwd(attention.BACKWARD_PROBE_FIRST_DESIGN)
        plain_bwd = lambda: attention.fused_attention_backward_reference(q, k, v, dout)  # noqa: E731
        out, again, first_out = run(), run(), first()
        grads, grads_again, first_grads = run_bwd(), run_bwd(), first_bwd()
        torch.cuda.synchronize()
        what = f"fused_attention B={b} H={h} N={n} hd={hd}"
        ref, ref_grads = plain(), plain_bwd()
        fwd_errors.append(max_error(out, ref, ATTENTION_TOL, f"{what}: out"))
        first_err = max_error(first_out, ref, ATTENTION_TOL, f"{what}: first design")
        bwd_errors.append(max(max_error(got, want, ATTENTION_BWD_TOL, f"{what}: {name}")
                              for name, got, want in zip(("dq", "dk", "dv"), grads, ref_grads)))
        first_bwd_err = max(
            max_error(got, want, ATTENTION_BWD_TOL, f"{what}: backward first design, {name}")
            for name, got, want in zip(("dq", "dk", "dv"), first_grads, ref_grads))
        del ref_grads, first_grads
        if not torch.equal(out, again):
            fail(f"{what}: two forward runs gave different bits")
        if not all(torch.equal(a, g) for a, g in zip(grads_again, grads)):
            fail(f"{what}: two backward runs gave different bits")
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        library = lambda: F.scaled_dot_product_attention(q, k, v)  # noqa: E731
        lib_out = F.scaled_dot_product_attention(*leaves)
        library_bwd = lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True)  # noqa: E731
        fwd_times[i] = time_ms(run), time_ms(plain), time_ms(library), time_ms(first)
        bwd_times[i] = (time_ms(run_bwd), time_ms(plain_bwd), time_ms(library_bwd),
                        time_ms(first_bwd))
        elements, core = b * h * n * hd, b * h * n * n * hd
        print(f"{what}: out max |diff| {fwd_errors[-1]:.3e}, first design {first_err:.3e} (atol "
              f"{ATTENTION_TOL[0]}, rtol {ATTENTION_TOL[1]}), dq, dk, dv {bwd_errors[-1]:.3e}, "
              f"first design {first_bwd_err:.3e} (atol {ATTENTION_BWD_TOL[0]}, rtol "
              f"{ATTENTION_BWD_TOL[1]}); forward and backward reruns bit-identical")
        print(f"  forward kernel {fwd_times[i][0]:.4f} ms, first design {fwd_times[i][3]:.4f} ms, "
              f"plain {fwd_times[i][1]:.4f} ms, scaled_dot_product_attention {fwd_times[i][2]:.4f} "
              f"ms, {bound_text(2 * 4 * elements, 4 * core)}; backward kernel "
              f"{bwd_times[i][0]:.4f} ms, first design {bwd_times[i][3]:.4f} ms, plain "
              f"{bwd_times[i][1]:.4f} ms, scaled_dot_product_attention's backward "
              f"{bwd_times[i][2]:.4f} ms, {bound_text(2 * 7 * elements, 10 * core)}")
        print("  forward ablations (wrong results, timed only): "
              + ", ".join(f"{label} {time_ms(probe_run(probe)):.4f} ms"
                          for label, probe in fwd_ablations.items()))
        print("  backward ablations (timed only; all but the last give wrong results): "
              + ", ".join(f"{label} {time_ms(probe_bwd(probe)):.4f} ms"
                          for label, probe in bwd_ablations.items()))
        del leaves, lib_out
    b, h, n, hd = BATCH, 12, 197, 64
    elements, core = b * h * n * hd, b * h * n * n * hd
    report["fused_attention"] = entry(
        "attention.cu", "ssl4polyp_tpu/ops/attention.py:118", max(fwd_errors), *fwd_times[0][:2],
        bytes_moved=2 * 4 * elements, flops=4 * core, library_ms=fwd_times[0][2])
    report["fused_attention_backward"] = entry(
        "attention.cu", "ssl4polyp_tpu/ops/attention.py:142", max(bwd_errors), *bwd_times[0][:2],
        bytes_moved=2 * 7 * elements, flops=10 * core, library_ms=bwd_times[0][2])

    fwd_errors, bwd_errors, fwd_times, bwd_times = [], [], {}, {}
    cases = [(BATCH, 197, 768, 12, 64, True, None), (BATCH, 197, 512, 16, 32, False, None),
             (BATCH, 197, 768, 12, 64, False, 150), (BATCH, 197, 512, 16, 32, True, 150),
             (2, 50, 64, 3, 32, False, 40)]  # an odd head count at hd 32: 3D = 288
    qkvproj_ablations = {"without the softmax arithmetic": attention_block.PROBE_NO_SOFTMAX,
                         "without the projection's products": attention_block.PROBE_NO_PROJECTION,
                         "without the prefetch": attention_block.PROBE_NO_PREFETCH,
                         "the projection alone": attention_block.PROBE_PROJECTION_ONLY}
    for i, (b, n, d_in, h, hd, f32, valid_len) in enumerate(cases):
        d = h * hd
        x, dout = randn(b, n, d_in), randn(b, n, d)
        w, bias = randn(d_in, 3 * d, scale=d_in ** -0.5), randn(3 * d, scale=0.5)
        rows = n if valid_len is None else valid_len
        dout[:, rows:] = 0  # the pad rows' upstream gradient is zero

        def probe_run(probe, x=x, w=w, bias=bias, h=h, f32=f32, valid_len=valid_len):
            return lambda: attention_block._forward_kernel(x, w, bias, h, f32, valid_len, probe)

        run, first = probe_run(0), probe_run(attention_block.PROBE_FIRST_DESIGN)
        plain = lambda: attention_block.fused_qkvproj_attention_reference(  # noqa: E731
            x, w, bias, h, f32, valid_len)
        run_bwd = lambda: attention_block._backward_kernel(x, w, bias, dout, h, f32, valid_len)  # noqa: E731
        plain_bwd = lambda: attention_block.fused_qkvproj_attention_backward_reference(  # noqa: E731
            x, w, bias, dout, h, f32, valid_len)
        out, out_again, first_out = run(), run(), first()
        grads, again = run_bwd(), run_bwd()
        torch.cuda.synchronize()
        what = (f"fused_qkvproj_attention B={b} N={n} Din={d_in} H={h} hd={hd} f32={f32} "
                f"valid_len={valid_len}")
        ref = plain()[:, :rows]
        fwd_errors.append(max_error(out[:, :rows], ref, QKVPROJ_TOL, f"{what}: out"))
        first_err = max_error(first_out[:, :rows], ref, QKVPROJ_TOL, f"{what}: first design")
        if not torch.equal(out, out_again):
            fail(f"{what}: two forward runs gave different bits")
        line = (f"{what}: out max |diff| {fwd_errors[-1]:.3e}, first design {first_err:.3e} (atol "
                f"{QKVPROJ_TOL[0]}, rtol {QKVPROJ_TOL[1]})")
        worst = 0.0
        for name, got, want in zip(("dx", "dw", "db"), grads, plain_bwd()):
            tol = (QKVPROJ_GRAD_TOL[0] * want.float().abs().max().item(), QKVPROJ_GRAD_TOL[1])
            err = max_error(got, want, tol, f"{what}: {name}")
            worst = max(worst, err)
            line += f", {name} {err:.3e} (atol {tol[0]:.3e}, rtol {tol[1]})"
        bwd_errors.append(worst)
        if not all(torch.equal(a, g) for a, g in zip(again, grads)):
            fail(f"{what}: two backward runs gave different bits")
        print(line + "; forward and backward reruns bit-identical")
        if valid_len is not None:
            continue
        leaves = [t.clone().requires_grad_() for t in (x, w.t().contiguous(), bias)]

        def library(leaves=leaves):
            qkv = F.linear(leaves[0], leaves[1], leaves[2])
            out = F.scaled_dot_product_attention(*heads_of(qkv, h))
            return out.transpose(1, 2).reshape(b, n, d)

        lib_out = library()
        library_bwd = lambda: torch.autograd.grad(lib_out, leaves, dout, retain_graph=True)  # noqa: E731
        first_bwd = lambda: attention_block._backward_kernel(  # noqa: E731
            x, w, bias, dout, h, f32, valid_len, attention_block.BACKWARD_PROBE_FIRST_DESIGN)
        first_grads = first_bwd()
        first_bwd_err = max(
            max_error(got, want, (QKVPROJ_GRAD_TOL[0] * want.float().abs().max().item(),
                                  QKVPROJ_GRAD_TOL[1]), f"{what}: first design's {name}")
            for name, got, want in zip(("dx", "dw", "db"), first_grads, plain_bwd()))
        with torch.no_grad():
            fwd_times[i] = time_ms(run), time_ms(plain), time_ms(library), time_ms(first)
        bwd_times[i] = (time_ms(run_bwd), time_ms(plain_bwd), time_ms(library_bwd),
                        time_ms(first_bwd))
        fwd_cost, bwd_cost = qkvproj_cost(b, n, d_in, h, hd)
        print(f"  forward kernel {fwd_times[i][0]:.4f} ms, first design {fwd_times[i][3]:.4f} ms, "
              f"plain {fwd_times[i][1]:.4f} ms, F.linear + scaled_dot_product_attention "
              f"{fwd_times[i][2]:.4f} ms, {bound_text(**fwd_cost)}; backward kernels "
              f"{bwd_times[i][0]:.4f} ms, first design {bwd_times[i][3]:.4f} ms (max |diff| "
              f"{first_bwd_err:.3e}), plain {bwd_times[i][1]:.4f} ms, the library pair's "
              f"{bwd_times[i][2]:.4f} ms, {bound_text(**bwd_cost)}")
        for label, first_design in (("launches alone", False), ("first design's launches alone",
                                                                  True)):
            split = qkvproj_backward_split(x, w, bias, dout, h, f32, first_design)
            print(f"    backward's {label}: " + "; ".join(
                f"{step} {ms:.4f} ms, {text}" for step, (ms, text) in split.items()))
        print("  forward ablations (timed only; the projection alone is right, the rest "
              "wrong): " + ", ".join(f"{label} {time_ms(probe_run(probe)):.4f} ms"
                                     for label, probe in qkvproj_ablations.items()))
        del leaves, lib_out
    fwd_cost, bwd_cost = qkvproj_cost(*cases[0][:5])
    report["fused_qkvproj_attention"] = entry(
        "attention_block.cu", "ssl4polyp_tpu/ops/attention_block.py:187", max(fwd_errors),
        *fwd_times[0][:2], **fwd_cost, library_ms=fwd_times[0][2])
    report["fused_qkvproj_attention_backward"] = entry(
        "attention_block.cu", "ssl4polyp_tpu/ops/attention_block.py:224", max(bwd_errors),
        *bwd_times[0][:2], **bwd_cost, library_ms=bwd_times[0][2])
    return report


def adamw_kernel(gen: torch.Generator) -> dict[str, dict]:
    """The one-pass AdamW kernel against its plain version on the MAE's and
    the classifier's parameter lists, three steps each: per-tensor scales, a
    frozen tensor, bf16 copies of the matrices.  The parameters, moments and
    copies must be equal bit for bit after every step.  Beside it the library
    route: torch.optim.AdamW(fused=True) and the casts to bf16."""
    report = {}
    mae = MAE(model_config(PretrainSettings(batch_size=BATCH)), torch.Generator().manual_seed(SEED))
    mae_params = {n: p.detach() for n, p in mae.cuda().named_parameters()}
    vit = get_imagenet_or_random_vit(torch.Generator().manual_seed(SEED), num_classes=2,
                                     device="cuda")
    vit_params = {n: p.detach() for n, p in vit.model.named_parameters()}
    lists = [
        ("MAE ViT-B/16", mae_params, optim.pretrain_lr_scales(mae_params), 0.95),
        ("ViT-B/16 classifier", vit_params,
         optim.finetune_lr_scales(vit_params, "full", vit.cfg.depth, head_scale=2.5,
                                  freeze_pos_embed=True), 0.999),
    ]
    for label, params, lr_scale, b2 in lists:
        wd_scale = optim.no_weight_decay_scales(params)
        sides = []
        for _ in range(2):  # the kernel's tensors, then the plain version's
            own = {n: p.clone() for n, p in params.items()}
            sides.append((own, layers.compute_copy(own, torch.bfloat16), optim.adamw_init(own)))
        kwargs = dict(b1=0.9, b2=b2, weight_decay=0.05, lr_scale=lr_scale, wd_scale=wd_scale)
        launches = -(-len(params) // adamw.TENSORS_PER_LAUNCH)
        worst = 0.0
        for step in range(3):
            grads = {n: 0.01 * torch.randn(p.shape, generator=gen, device="cuda")
                     for n, p in params.items()}
            ops.reset_launch_counts()
            optim.adamw_update_fused(*sides[0][:2], grads, sides[0][2], lr=1e-3 * (step + 1), **kwargs)
            if ops.launch_counts()["adamw"] != launches:
                fail(f"adamw {label}: {ops.launch_counts()['adamw']} launches, expected {launches}")
            optim.adamw_update_fused_plain(*sides[1][:2], grads, sides[1][2], lr=1e-3 * (step + 1),
                                           **kwargs)
            torch.cuda.synchronize()
            groups = [(sides[0][0], sides[1][0]), (sides[0][1], sides[1][1]),
                      (sides[0][2].mu, sides[1][2].mu), (sides[0][2].nu, sides[1][2].nu)]
            for what, (got, want) in zip(("parameter", "copy", "mu", "nu"), groups):
                for name in params:
                    if not torch.equal(got[name], want[name]):
                        worst = (got[name].float() - want[name].float()).abs().max().item()
                        fail(f"adamw {label} step {step + 1}: {what} of {name} differs from the "
                             f"plain version's bits (max |diff| {worst})")
        frozen = [n for n, scale in lr_scale.items() if scale == 0.0]
        if not frozen or not all(torch.equal(sides[0][0][n], params[n]) for n in frozen):
            fail(f"adamw {label}: a frozen tensor moved")
        if not all(sides[0][2].mu[n].abs().sum() > 0 for n in frozen):
            fail(f"adamw {label}: a frozen tensor's moments did not move")
        grads = {n: 0.01 * torch.randn(p.shape, generator=gen, device="cuda")
                 for n, p in params.items()}
        run = lambda: optim.adamw_update_fused(*sides[0][:2], grads, sides[0][2], lr=1e-3, **kwargs)  # noqa: E731
        plain = lambda: optim.adamw_update_fused_plain(  # noqa: E731
            *sides[1][:2], grads, sides[1][2], lr=1e-3, **kwargs)
        # The library route, timed only: one fused AdamW step over the same
        # tensors (one learning rate) and the casts of the matrices to bf16.
        lib_params = [p.clone().requires_grad_() for p in params.values()]
        for p, g in zip(lib_params, grads.values()):
            p.grad = g
        lib_opt = torch.optim.AdamW(lib_params, lr=1e-3, betas=(0.9, b2), weight_decay=0.05,
                                    fused=True)
        masters = [p.detach() for p in lib_params if p.dim() >= 2]
        lib_copies = [p.to(torch.bfloat16) for p in masters]

        def library():
            lib_opt.step()
            torch._foreach_copy_(lib_copies, masters)

        ms, plain_ms, library_ms = time_ms(run), time_ms(plain), time_ms(library)
        n_all = sum(p.numel() for p in params.values())
        n_frozen = sum(params[n].numel() for n in frozen)
        n_copy = sum(p.numel() for n, p in params.items() if p.dim() >= 2 and n not in frozen)
        # Read p, g, mu, nu and write p, mu, nu in fp32 (a frozen tensor's p
        # is neither read nor written), and write the bf16 copies.
        moved = 28 * n_all - 8 * n_frozen + 2 * n_copy
        print(f"adamw {label}: {len(params)} tensors, {n_all / 1e6:.1f} M elements, {launches} "
              f"launches a step; parameters, copies and moments equal the plain version's bit "
              f"for bit over 3 steps; {len(frozen)} frozen kept their bits; kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, torch.optim.AdamW(fused=True) + casts {library_ms:.4f} "
              f"ms; {moved / 1e9:.2f} GB is {1e3 * moved / HBM_BYTES_PER_S:.4f} ms at the "
              f"card's memory rate")
        report.setdefault("adamw", entry(
            "adamw.cu", "ssl4polyp_tpu/ops/adamw.py:29", worst, ms, plain_ms,
            bytes_moved=moved, flops=15 * n_all, peak=FP32_FLOPS, library_ms=library_ms))
        del sides, grads, lib_params, lib_opt, masters, lib_copies
    return report


def _linear(rng, d_in, d_out, stack=None):
    lead = () if stack is None else (stack,)
    limit = np.sqrt(6.0 / (d_in + d_out))
    return {"kernel": rng.uniform(-limit, limit, lead + (d_in, d_out)).astype(np.float32),
            "bias": (0.02 * rng.standard_normal(lead + (d_out,))).astype(np.float32)}


def _norm(rng, dim, stack=None):
    shape = (dim,) if stack is None else (stack, dim)
    return {"scale": (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32),
            "bias": (0.02 * rng.standard_normal(shape)).astype(np.float32)}


def _blocks(rng, depth, dim, hidden):
    return {
        "ln1": _norm(rng, dim, depth),
        "attn": {"qkv": _linear(rng, dim, 3 * dim, depth), "proj": _linear(rng, dim, dim, depth)},
        "ln2": _norm(rng, dim, depth),
        "mlp": {"fc1": _linear(rng, dim, hidden, depth), "fc2": _linear(rng, hidden, dim, depth)},
    }


def jax_layout_tree(cfg: ViTConfig, rng: np.random.Generator) -> dict:
    """Random ViT classifier weights in the JAX package's pytree layout, as numpy."""
    D = cfg.embed_dim
    return {
        "patch_embed": _linear(rng, cfg.patch_dim, D),
        "cls_token": (0.02 * rng.standard_normal((1, 1, D))).astype(np.float32),
        "pos_embed": (0.02 * rng.standard_normal((1, cfg.num_patches + 1, D))).astype(np.float32),
        "blocks": _blocks(rng, cfg.depth, D, int(D * cfg.mlp_ratio)),
        "norm": _norm(rng, D),
        "head": _linear(rng, D, cfg.num_classes),
    }


def jax_layout_mae_tree(cfg: MAEConfig, rng: np.random.Generator) -> dict:
    """Random MAE weights, encoder and decoder, in the JAX package's layout,
    with the fixed sin-cos position tables, as numpy."""
    enc = cfg.encoder
    D, Dd = enc.embed_dim, cfg.decoder_embed_dim
    return {
        "patch_embed": _linear(rng, enc.patch_dim, D),
        "cls_token": (0.02 * rng.standard_normal((1, 1, D))).astype(np.float32),
        "pos_embed": sincos_2d(D, enc.grid_size, cls_token=True)[None],
        "blocks": _blocks(rng, enc.depth, D, int(D * enc.mlp_ratio)),
        "norm": _norm(rng, D),
        "decoder": {
            "embed": _linear(rng, D, Dd),
            "mask_token": (0.02 * rng.standard_normal((1, 1, Dd))).astype(np.float32),
            "pos_embed": sincos_2d(Dd, enc.grid_size, cls_token=True)[None],
            "blocks": _blocks(rng, cfg.decoder_depth, Dd, int(Dd * enc.mlp_ratio)),
            "norm": _norm(rng, Dd),
            "pred": _linear(rng, Dd, enc.patch_dim),
        },
    }


def check_counts(counts: dict[str, int], per_call: dict[str, int], calls: int, what: str) -> None:
    """Exactly ``calls`` times ``per_call`` launches of each kernel named
    there, and none of the others."""
    expected = {name: calls * per_call.get(name, 0) for name in ops.launch_counts()}
    print(f"kernel launches over {what}: {counts}")
    if counts != expected:
        fail(f"{what}: launch counts {counts}, expected {expected}")


def phase_eval(gen: torch.Generator) -> dict[str, int]:
    rng = np.random.default_rng(SEED)
    cfg = ViTConfig(pos_embed="learned", num_classes=2)  # ViT-B/16 at 224 px
    tree = jax_layout_tree(cfg, rng)
    requests = [rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)
                for _ in range(REQUESTS)]
    total: dict[str, int] = {}
    unfolded = None
    for fold in (False, True):
        what = "eval forward under BENCH_ATTN_PROJ=1" if fold else "eval forward"
        with projection_fold(fold):
            classifier = get_imagenet_or_random_vit(gen, jax_params=tree, num_classes=2,
                                                    device="cuda")
        if any(block.attn.proj_fold != fold for block in classifier.model.blocks):
            fail(f"{what}: the blocks' projection fold is not {fold}")
        forward = make_forward_fn(classifier, "cuda")()
        if any(p.dtype != torch.float32 for p in classifier.model.parameters()):
            fail(f"{what}: make_forward_fn cast the classifier's own parameters")

        forward(requests[0])  # warm-up
        ops.reset_launch_counts()
        logits = [forward(images) for images in requests]
        counts = ops.launch_counts()
        per_request = {"attn_proj" if fold else "fused_qkv_attention": cfg.depth,
                       "layernorm": 2 * cfg.depth + 1, "fc1_gelu": cfg.depth}
        check_counts(counts, per_request, REQUESTS, f"{REQUESTS} requests of the {what}")
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n

        rate = rates(lambda: forward(requests[0]), BATCH, REPEATS, REPEAT_CALLS)
        ops.reset_launch_counts()
        with plain_kernels():
            plain_logits = [forward(images) for images in requests]
            plain_rate = rates(lambda: forward(requests[0]), BATCH, REPEATS, REPEAT_CALLS)
        if any(ops.launch_counts().values()):
            fail(f"{what}: the plain forward launched a kernel")
        errors = []
        for got, ref in zip(logits, plain_logits):
            if got.shape != (BATCH, 2) or got.dtype != np.float32:
                fail(f"logits {got.shape} {got.dtype}, expected ({BATCH}, 2) float32")
            errors.append(max_error(torch.from_numpy(got), torch.from_numpy(ref), LOGITS_TOL,
                                    f"{what}: logits"))
        print(f"{what}: logits vs plain forward: max |diff| {max(errors):.3e} "
              f"(atol {LOGITS_TOL[0]}, rtol {LOGITS_TOL[1]}); logit range "
              f"[{min(l.min() for l in logits):.3f}, {max(l.max() for l in logits):.3f}]")
        if fold:  # the same function as the unfolded forward, other kernels
            err = max(max_error(torch.from_numpy(got), torch.from_numpy(ref), LOGITS_TOL,
                                f"{what}: logits against the unfolded forward's")
                      for got, ref in zip(logits, unfolded))
            print(f"{what}: logits vs the unfolded forward's: max |diff| {err:.3e}")
        unfolded = logits
        print(f"{what} ViT-B/16, batch {BATCH}, images/s over {REPEATS} repeats of "
              f"{REPEAT_CALLS} requests: kernels {spread(rate)}; plain {spread(plain_rate)}")
        del classifier, forward
    return total


def check_step_one(loss, grads, plain_loss, plain_grads, loss_rtol: float, grad_rtol: float,
                   what: str) -> None:
    """Step 1's loss (relative) and each gradient (relative L2 distance)
    against the plain step's.  The K slice of each qkv bias is left out: its
    exact gradient is zero (softmax is invariant to a shift of the scores
    along k), so both sides hold rounding noise there."""
    loss_err = abs(loss.item() - plain_loss.item()) / abs(plain_loss.item())
    print(f"{what} step 1 loss: kernels {loss.item():.6f}, plain {plain_loss.item():.6f} "
          f"(relative diff {loss_err:.3e}, limit {loss_rtol})")
    if not (np.isfinite(loss.item()) and loss_err <= loss_rtol):
        fail(f"{what}: step 1 loss disagrees with the plain step")
    worst = (0.0, "")
    for name, g in grads.items():
        ref = plain_grads[name]
        if name.endswith("attn.qkv.bias"):
            d = g.shape[0] // 3
            g, ref = torch.cat([g[:d], g[2 * d:]]), torch.cat([ref[:d], ref[2 * d:]])
        if not torch.isfinite(g).all():
            fail(f"{what}: gradient of {name} is not finite")
        rel = ((g - ref).norm() / ref.norm().clamp_min(1e-30)).item()
        worst = max(worst, (rel, name))
        if rel > grad_rtol:
            fail(f"{what}: gradient of {name}: relative L2 distance {rel:.3e} to the plain "
                 f"step's exceeds {grad_rtol}")
    print(f"{what} step 1 gradients of {len(grads)} parameters: worst relative L2 distance "
          f"{worst[0]:.3e} ({worst[1]}), limit {grad_rtol}")


def mae_train_flops_per_image(cfg: MAEConfig) -> float:
    """Matmul FLOPs of one image's MAE train step, forward and backward (the
    count of ``bench.py::_mae_train_flops_per_image``, without padding):
    24 N D^2 + 4 N^2 D per block forward, the embeddings and the pixel head,
    and twice the forward for the backward."""
    enc = cfg.encoder
    n_enc, n_dec = 1 + cfg.len_keep, 1 + enc.num_patches
    d_enc, d_dec = enc.embed_dim, cfg.decoder_embed_dim
    fwd = enc.depth * (24.0 * n_enc * d_enc ** 2 + 4.0 * n_enc ** 2 * d_enc)
    fwd += cfg.decoder_depth * (24.0 * n_dec * d_dec ** 2 + 4.0 * n_dec ** 2 * d_dec)
    fwd += 2.0 * enc.num_patches * enc.patch_dim * d_enc
    fwd += 2.0 * n_enc * d_enc * d_dec
    fwd += 2.0 * n_dec * d_dec * enc.patch_dim
    return 3.0 * fwd


def phase_pretrain() -> dict[str, int]:
    settings = PretrainSettings(batch_size=BATCH)
    cfg = model_config(settings)  # MAE ViT-B/16, bf16, bf16 scores
    rng = np.random.default_rng(SEED)
    tree = jax_layout_mae_tree(cfg, rng)
    batches = [torch.from_numpy(rng.integers(0, 256, (1, BATCH, 224, 224, 3), dtype=np.uint8)).cuda()
               for _ in range(STEPS)]
    noise_gen = torch.Generator(device="cuda").manual_seed(SEED)
    noise = [torch.rand((1, BATCH, cfg.encoder.num_patches), generator=noise_gen, device="cuda")
             for _ in range(STEPS)]
    schedule = warmup_cosine(settings.absolute_lr, STEPS, 2)
    train_step = make_pretrain_step(cfg, 1, settings.weight_decay)

    def fresh_state():
        model = MAE(cfg, torch.Generator().manual_seed(SEED))
        model.load_state_dict(mae_state_dict_from_jax(tree, cfg))
        return init_pretrain_state(model.cuda())

    # Step 1's loss and gradients, kernels against plain, from one state.
    with projection_fold(False):
        state = fresh_state()
    loss, grads = pretrain_loss_and_grads(state, batches[0], noise[0])
    with plain_kernels():
        plain_loss, plain_grads = pretrain_loss_and_grads(state, batches[0], noise[0])
    check_step_one(loss, grads, plain_loss, plain_grads, LOSS_RTOL, GRAD_RTOL, "pretrain")
    del grads, plain_grads

    def train(state) -> list[float]:
        losses = [train_step(state, batches[i], noise[i], schedule(i))["loss"]
                  for i in range(STEPS)]
        return [x.item() for x in losses]

    def rate(state) -> list[float]:  # after train(state): past the warm-up
        calls = iter(range(REPEATS * REPEAT_CALLS))

        def run():
            i = next(calls) % STEPS
            train_step(state, batches[i], noise[i], schedule(i))
        return rates(run, BATCH, REPEATS, REPEAT_CALLS)

    frozen = {n: state.params[n].clone() for n in ("pos_embed", "decoder_pos_embed")}
    ops.reset_launch_counts()
    losses = train(state)
    counts = ops.launch_counts()
    enc_depth, dec_depth = cfg.encoder.depth, cfg.decoder_depth
    per_step = {
        "fused_qkv_attention": enc_depth + dec_depth,
        "fused_qkv_attention_backward": enc_depth + dec_depth,
        "layernorm": 2 * (enc_depth + dec_depth) + 2,
        "layernorm_backward": 2 * (enc_depth + dec_depth) + 2,
        "fc1_gelu": enc_depth + dec_depth,
        "adamw": -(-len(state.params) // adamw.TENSORS_PER_LAUNCH),
    }
    check_counts(counts, per_step, STEPS, f"{STEPS} pretrain steps")
    if not all(np.isfinite(losses)):
        fail(f"non-finite pretrain loss: {losses}")
    if not all(torch.isfinite(p).all() for p in state.params.values()):
        fail("non-finite parameters after the pretrain steps")
    for name, table in frozen.items():
        if not torch.equal(table, state.params[name]):
            fail(f"{name} moved: it is frozen (learning rate 0)")
    print(f"pretrain losses, kernels: {[round(x, 6) for x in losses]}; sin-cos tables unchanged")

    kernel_rate = rate(state)
    del state
    with projection_fold(False):
        plain_state = fresh_state()
    ops.reset_launch_counts()
    with plain_kernels():
        plain_losses = train(plain_state)
        plain_rate = rate(plain_state)
    if any(ops.launch_counts().values()):
        fail("the plain pretrain step launched a kernel")
    print(f"pretrain losses, plain:   {[round(x, 6) for x in plain_losses]}")
    flops = mae_train_flops_per_image(cfg)
    print(f"pretrain step MAE ViT-B/16, batch {BATCH}, images/s over {REPEATS} repeats of "
          f"{REPEAT_CALLS} steps: kernels {spread(kernel_rate)} "
          f"({statistics.median(kernel_rate) * flops / 1e12:.1f} model TFLOP/s at the median); plain "
          f"{spread(plain_rate)} ({statistics.median(plain_rate) * flops / 1e12:.1f}); "
          f"{flops / 1e9:.2f} GFLOP per image; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    del plain_state

    # Under BENCH_ATTN_PROJ=1 the decoder (197 tokens, padded by the recipe)
    # folds its projection into the attention kernel; the encoder at 50
    # tokens keeps the attention kernel and the separate projection.
    with projection_fold(True):
        state = fresh_state()
    folds = [[b.attn.proj_fold for b in blocks]
             for blocks in (state.model.blocks, state.model.decoder_blocks)]
    if any(folds[0]) or not all(folds[1]):
        fail(f"pretrain under BENCH_ATTN_PROJ=1: encoder folds {folds[0]}, decoder {folds[1]}")
    loss, grads = pretrain_loss_and_grads(state, batches[0], noise[0])
    with plain_kernels():
        plain_loss, plain_grads = pretrain_loss_and_grads(state, batches[0], noise[0])
    check_step_one(loss, grads, plain_loss, plain_grads, LOSS_RTOL, GRAD_RTOL,
                   "pretrain under BENCH_ATTN_PROJ=1")
    del grads, plain_grads
    fold_steps = 2
    ops.reset_launch_counts()
    losses = [train_step(state, batches[i], noise[i], schedule(i))["loss"].item()
              for i in range(fold_steps)]
    fold_counts = ops.launch_counts()
    per_step = dict(per_step, fused_qkv_attention=enc_depth, fused_qkv_attention_backward=enc_depth,
                    attn_proj=dec_depth, attn_proj_backward=dec_depth)
    check_counts(fold_counts, per_step, fold_steps,
                 f"{fold_steps} pretrain steps under BENCH_ATTN_PROJ=1")
    if not all(np.isfinite(losses)):
        fail(f"non-finite pretrain loss under BENCH_ATTN_PROJ=1: {losses}")
    print(f"pretrain losses under BENCH_ATTN_PROJ=1: {[round(x, 6) for x in losses]}")
    return {name: counts[name] + fold_counts[name] for name in counts}


def phase_finetune() -> dict[str, int]:
    """The classifier's fine-tune step under each kernel configuration."""
    rng = np.random.default_rng(SEED)
    base = ViTConfig(pos_embed="learned", num_classes=2)
    tree = jax_layout_tree(base, rng)
    batches = [torch.from_numpy(rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)).cuda()
               for _ in range(STEPS)]
    labels = [torch.from_numpy(rng.integers(0, 2, BATCH)).cuda() for _ in range(STEPS)]
    valid = torch.arange(BATCH, device="cuda") < BATCH - 4  # the last rows are padding
    loss_mode, pos_weight, class_weights = loss_settings([3000, 1000])
    depth = base.depth
    total: dict[str, int] = {}
    for label, overrides, fold in FINETUNE_CONFIGS:
        def fresh_state():
            with projection_fold(fold):
                classifier = get_imagenet_or_random_vit(
                    torch.Generator().manual_seed(SEED), jax_params=tree, num_classes=2,
                    device="cuda", **overrides)
            return classifier, init_train_state(
                classifier, torch.Generator(device="cuda").manual_seed(SEED))

        classifier, state = fresh_state()
        ctx = TrainContext(classifier, loss_mode, pos_weight, class_weights, FT_WEIGHT_DECAY)
        step = make_train_step(ctx)
        full = optim.finetune_lr_scales(state.params, "full", depth)
        wd = optim.no_weight_decay_scales(state.params)
        what = f"fine-tune [{label}]"

        aug = draw_augment_params(BATCH, torch.Generator(device="cuda").manual_seed(SEED + 1))
        loss, grads = loss_and_grads(ctx, state, batches[0], labels[0], valid, aug)
        with plain_kernels():
            plain_loss, plain_grads = loss_and_grads(ctx, state, batches[0], labels[0], valid, aug)
        check_step_one(loss, grads, plain_loss, plain_grads, FT_LOSS_RTOL, FT_GRAD_RTOL, what)
        del grads, plain_grads

        def train(state) -> list[float]:
            return [step(state, batches[i], labels[i], valid, FT_LR, full, wd)["loss"].item()
                    for i in range(STEPS)]

        def rate(state) -> list[float]:  # after train(state): past the warm-up
            calls = iter(range(REPEATS * REPEAT_CALLS))

            def run():
                i = next(calls) % STEPS
                step(state, batches[i], labels[i], valid, FT_LR, full, wd)
            return rates(run, BATCH, REPEATS, REPEAT_CALLS)

        # An eval forward bound to the state's compute copy before training
        # must read the trained weights after it.
        bound_forward = make_forward_fn(classifier, "cuda")(state.params_c)
        probe = batches[0].cpu().numpy()
        untrained = bound_forward(probe)
        ops.reset_launch_counts()
        losses = train(state)
        counts = ops.launch_counts()
        trained = bound_forward(probe)
        fresh = make_forward_fn(classifier, "cuda")()(probe)  # a new copy of the masters
        err = max_error(torch.from_numpy(trained), torch.from_numpy(fresh), LOGITS_TOL,
                        f"{what}: the forward bound to the train state, after training")
        if np.array_equal(trained, untrained):
            fail(f"{what}: the forward bound to the train state did not follow training")
        print(f"{what}: the eval forward bound before training against one bound after it: max "
              f"|diff| {err:.3e} (atol {LOGITS_TOL[0]}, rtol {LOGITS_TOL[1]}); training moved "
              f"the logits by up to {np.abs(trained - untrained).max():.3e}")
        mlp_route, qkv_ln = classifier.model.blocks[0].mlp_route, classifier.model.blocks[0].qkv_ln
        if any(block.attn.proj_fold != fold for block in classifier.model.blocks):
            fail(f"{what}: the blocks' projection fold is not {fold}")
        # The final norm and each block's two: where a fused kernel folds a
        # LayerNorm in, its backward recomputes the normalised row and takes
        # the LayerNorm backward on the LayerNorm kernels, once each.
        # Under the fold the attention+projection kernel takes the attention
        # kernel's place, forward and backward (proj.weight's and proj.bias's
        # gradients come from it).  One AdamW pass over the 152 tensors.
        per_step = {
            "attn_proj" if fold else "fused_qkv_attention": depth,
            "attn_proj_backward" if fold else "fused_qkv_attention_backward": depth,
            "layernorm": 2 * depth + 1,
            "layernorm_backward": 2 * depth + 1,
            "ln_linear": depth if qkv_ln else 0,
            {"fc1": "fc1_gelu", "full": "mlp_fused", "full_ln": "mlp_ln_fused"}[mlp_route]: depth,
            "adamw": -(-len(state.params) // adamw.TENSORS_PER_LAUNCH),
        }
        check_counts(counts, per_step, STEPS, f"{STEPS} {what} steps")
        for name, n in counts.items():
            total[name] = total.get(name, 0) + n
        if not all(np.isfinite(losses)):
            fail(f"{what}: non-finite loss: {losses}")
        if not all(torch.isfinite(p).all() for p in state.params.values()):
            fail(f"{what}: non-finite parameters after the steps")
        print(f"{what} losses, kernels: {[round(x, 6) for x in losses]}")

        # head+1: the last block and the head train, everything else keeps its bits.
        head1 = optim.finetune_lr_scales(state.params, "head+1", depth)
        before = {n: p.clone() for n, p in state.params.items()}
        for i in range(2):
            step(state, batches[i], labels[i], valid, FT_LR, head1, wd)
        moved = {n for n, p in state.params.items() if not torch.equal(p, before[n])}
        trained = {n for n, scale in head1.items() if scale > 0}
        if not moved <= trained or not any(n.startswith("head.") for n in moved) or not any(
                n.startswith(f"blocks.{depth - 1}.") for n in moved):
            fail(f"{what}: head+1 moved {sorted(moved - trained)} (frozen) or left the head "
                 f"or block {depth - 1} in place")
        print(f"{what}: head+1 moved {len(moved)} of {len(trained)} trained parameters; the "
              f"{len(before) - len(trained)} frozen ones kept their bits")
        del before

        kernel_rate = rate(state)
        del state, classifier
        _, plain_state = fresh_state()
        ops.reset_launch_counts()
        with plain_kernels():
            plain_losses = train(plain_state)
            plain_rate = rate(plain_state)
        if any(ops.launch_counts().values()):
            fail(f"{what}: the plain step launched a kernel")
        del plain_state
        print(f"{what} losses, plain:   {[round(x, 6) for x in plain_losses]}")
        print(f"{what} ViT-B/16, batch {BATCH}, images/s over {REPEATS} repeats of "
              f"{REPEAT_CALLS} steps: kernels {spread(kernel_rate)}; plain {spread(plain_rate)}; "
              f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB")
    return total


def _route_gradients(route, a, weight, bias, dout):
    """(out, da, dweight, dbias) of one route of block 0's attention core."""
    leaves = [t.detach().clone().requires_grad_() for t in (a, weight, bias)]
    out = route(*leaves)
    out.backward(dout)
    return (out.detach(), *[leaf.grad for leaf in leaves])


def phase_attention_ops(gen: torch.Generator) -> dict[str, int]:
    """Block 0's attention core of the eval classifier, three ways, on a real
    activation: the path that launches ``fused_qkvproj_attention`` and
    ``fused_attention``, forward and backward."""
    rng = np.random.default_rng(SEED)
    cfg = ViTConfig(pos_embed="learned", num_classes=2)  # ViT-B/16 at 224 px
    tree = jax_layout_tree(cfg, rng)
    images = rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)
    with projection_fold(False):
        classifier = get_imagenet_or_random_vit(gen, jax_params=tree, num_classes=2, device="cuda")
    dtype, heads = cfg.compute_dtype, cfg.num_heads
    model = layers.cast_params_for_compute(classifier.model, dtype).eval()
    block = model.blocks[0]
    with torch.no_grad():
        x = model.patch_embed(normalize_batch(torch.from_numpy(images).cuda(), dtype))
        pos = model.pos_embed.to(dtype)
        cls = (model.cls_token.to(dtype) + pos[:, :1]).expand(BATCH, -1, -1)
        a = block.norm1(torch.cat([cls, x + pos[:, 1:]], dim=1))
    weight = block.attn.qkv.weight.detach()            # (3D, D): torch's (out, in)
    bias = block.attn.qkv.bias.detach().to(dtype)
    dout = (torch.randn(a.shape, generator=torch.Generator(device="cuda").manual_seed(SEED),
                        device="cuda") * 0.1).to(dtype)
    if a.shape != (BATCH, 197, 768) or not torch.isfinite(a.float()).all():
        fail(f"attention ops: activation {tuple(a.shape)} is not a finite (64, 197, 768) tensor")

    def split_heads(qkv):
        return [t.contiguous() for t in heads_of(qkv, heads)]

    def merge_heads(out):
        return out.transpose(1, 2).reshape(BATCH, 197, 768)

    def routes(core_qkv, core_proj, core_sep):
        return {
            # The model's route: the JAX package's bare dot, then the QKV kernel.
            "model": lambda a, w, b: core_qkv(torch.matmul(a, w.t()), heads, True, None, b),
            "fused_qkvproj_attention": lambda a, w, b: core_proj(
                a, w.t().contiguous(), b, heads, True),
            "fused_attention": lambda a, w, b: merge_heads(
                core_sep(*split_heads(layers.linear(a, w, b)))),
        }

    kernel_routes = routes(qkv_attention.fused_qkv_attention,
                           attention_block.fused_qkvproj_attention, attention.fused_attention)
    plain_routes = routes(qkv_attention.fused_qkv_attention_plain,
                          attention_block.fused_qkvproj_attention_plain,
                          attention.fused_attention_plain)
    launched = {"model": ("fused_qkv_attention", "fused_qkv_attention_backward"),
                "fused_qkvproj_attention": ("fused_qkvproj_attention",
                                            "fused_qkvproj_attention_backward"),
                "fused_attention": ("fused_attention", "fused_attention_backward")}
    total = {name: 0 for name in ops.launch_counts()}
    results = {}
    for name, route in kernel_routes.items():
        ops.reset_launch_counts()
        results[name] = _route_gradients(route, a, weight, bias, dout)
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        check_counts(counts, dict.fromkeys(launched[name], 1), 1,
                     f"one forward and backward pass of the {name} route")
        for kernel, n in counts.items():
            total[kernel] += n
    ops.reset_launch_counts()
    plain_results = {name: _route_gradients(route, a, weight, bias, dout)
                     for name, route in plain_routes.items()}
    torch.cuda.synchronize()
    if any(ops.launch_counts().values()):
        fail("attention ops: a plain route launched a kernel")

    d = 768

    def compare(got, want, what):
        err = max_error(got[0], want[0], ROUTE_OUT_TOL, f"{what}: out")
        line = f"{what}: out max |diff| {err:.3e} (atol {ROUTE_OUT_TOL[0]}, rtol {ROUTE_OUT_TOL[1]})"
        for label, g, ref in zip(("da", "dweight", "dbias"), got[1:], want[1:]):
            g, ref = g.float(), ref.float()
            if label == "dbias":  # the K slice is zero up to rounding on every route
                g, ref = torch.cat([g[:d], g[2 * d:]]), torch.cat([ref[:d], ref[2 * d:]])
            if not torch.isfinite(g).all():
                fail(f"{what}: {label} is not finite")
            rel = ((g - ref).norm() / ref.norm().clamp_min(1e-30)).item()
            if rel > ROUTE_GRAD_RTOL:
                fail(f"{what}: {label}: relative L2 distance {rel:.3e} exceeds {ROUTE_GRAD_RTOL}")
            line += f", {label} relative L2 distance {rel:.3e}"
        print(line + f" (limit {ROUTE_GRAD_RTOL})")

    for name in kernel_routes:
        compare(results[name], plain_results[name], f"attention ops [{name}] kernels vs plain")
    for name in ("fused_qkvproj_attention", "fused_attention"):
        compare(results[name], results["model"], f"attention ops [{name}] vs the model's route")
    return total


def phase_eval_cli() -> dict[str, int]:
    """The standalone eval CLI at full width, from files it reads itself."""
    rng = np.random.default_rng(SEED)
    cfg = ViTConfig(pos_embed="learned", num_classes=2)
    frames, tau = 128, 0.4375
    model_cfg = {"img_size": cfg.img_size, "patch_size": cfg.patch_size,
                 "embed_dim": cfg.embed_dim, "depth": cfg.depth, "num_heads": cfg.num_heads,
                 "pos_embed": cfg.pos_embed, "out_token": cfg.out_token, "num_classes": 2,
                 "pad_tokens_to": 0}
    meta = {"epoch": 7, "model_cfg": model_cfg,
            "thresholds": {"primary": {"tau": tau, "policy": "f1_opt_on_val",
                                       "split": "sun_full/val"},
                           "values": {"sun_full_val_f1_opt_on_val": tau}}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        start = time.perf_counter()
        build_synthetic_pack(tmp / "data_packs", name="sun_full", frames_per_split=frames,
                             image_size=224, seed=SEED)
        checkpoint = save_checkpoint(tmp / "run" / "SupImnet_SUNFull_s13_e07_valLoss.ckpt",
                                     {"params": jax_layout_tree(cfg, rng)}, meta)
        print(f"eval CLI: wrote a pack of 3 x {frames} JPEG frames of 224 px and a "
              f"{checkpoint.stat().st_size / 2**20:.0f} MiB checkpoint in "
              f"{time.perf_counter() - start:.1f} s")
        argv = ["--checkpoint-root", str(tmp / "run"), "--model-tag", "SupImnet", "--seed", "13",
                "--test-pack", "sun_full", "--pack-root", str(tmp / "data_packs"),
                "--batch-size", str(BATCH), "--output-dir", str(tmp / "eval"), "--export-outputs"]

        walls = []
        for _ in range(2):  # the second run finds the files in the page cache
            ops.reset_launch_counts()
            printed = io.StringIO()
            start = time.perf_counter()
            with contextlib.redirect_stdout(printed):
                eval_classification.cli_main(argv)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - start)
            counts = ops.launch_counts()
        summary = json.loads(printed.getvalue())
        batches = frames // BATCH
        check_counts(counts, {"fused_qkv_attention": cfg.depth, "layernorm": 2 * cfg.depth + 1,
                              "fc1_gelu": cfg.depth}, batches, f"the eval CLI's {batches} batches")
        numbers = {k: v for k, v in summary.items() if isinstance(v, (int, float))}
        if summary["n_frames"] != frames or summary["tau"] != tau or summary["checkpoint"] != str(
                checkpoint) or not all(np.isfinite(v) for v in numbers.values()):
            fail(f"eval CLI: summary {summary}")
        missing = [name for name in ("eval_results.txt", "logits.npz", "logits.pt",
                                     "metadata.jsonl", "tau.json")
                   if not (tmp / "eval" / name).exists()]
        if missing:
            fail(f"eval CLI: {missing} not written")
        stored = np.load(tmp / "eval" / "logits.npz")
        loaded = torch.load(tmp / "eval" / "logits.pt", weights_only=True)
        if not np.array_equal(loaded.numpy(), stored["logits"]) or json.loads(
                (tmp / "eval" / "tau.json").read_text())["tau"] != tau:
            fail("eval CLI: logits.pt or tau.json disagree with logits.npz and the stored tau")

        # The same frames through make_forward_fn, stage by stage on the clock.
        clock = {}
        start = time.perf_counter()
        restored = load_checkpoint(checkpoint)
        clock["checkpoint read"] = time.perf_counter() - start
        start = time.perf_counter()
        classifier = get_imagenet_or_random_vit(
            torch.Generator().manual_seed(0), jax_params=restored["payload"]["params"],
            num_classes=2, device="cuda", pad_tokens_to=0)
        forward = make_forward_fn(classifier, "cuda")()
        torch.cuda.synchronize()
        clock["model build"] = time.perf_counter() - start
        index = create_classification_datasets(test_spec="sun_full", pack_root=tmp / "data_packs",
                                               image_size=224)["test"]
        loader = HostDataLoader(index, batch_size=BATCH, shuffle=False, drop_last=False)
        start = time.perf_counter()
        decoded = list(loader)
        clock["decode"] = time.perf_counter() - start
        start = time.perf_counter()
        for batch in decoded:
            torch.from_numpy(batch["image"]).cuda()
        torch.cuda.synchronize()
        clock["host to device copy"] = time.perf_counter() - start
        forward(decoded[0]["image"])  # warm-up
        start = time.perf_counter()
        logits = np.concatenate([forward(batch["image"]) for batch in decoded])
        clock["forward (copies included)"] = time.perf_counter() - start
        start = time.perf_counter()
        again = evaluate_split(lambda part: part,
                               [dict(batch, image=part)
                                for batch, part in zip(decoded, np.split(logits, batches))],
                               index, split_name="test", tau=tau)
        clock["metrics"] = time.perf_counter() - start
        err = max_error(torch.from_numpy(stored["logits"]), torch.from_numpy(logits), LOGITS_TOL,
                        "eval CLI: logits.npz against make_forward_fn on the same frames")
        if again["auroc"] != summary["auroc"] and err == 0.0:
            fail("eval CLI: the same logits gave another AUROC")
        forward_s = clock["forward (copies included)"]
        print(f"eval CLI: n_frames {summary['n_frames']}, tau {summary['tau']}, auroc "
              f"{summary['auroc']:.4f}, loss {summary['loss']:.4f}; logits.npz vs make_forward_fn "
              f"on the same decoded frames: max |diff| {err:.3e} (atol {LOGITS_TOL[0]}, rtol "
              f"{LOGITS_TOL[1]}); eval_results.txt, logits.pt, metadata.jsonl, tau.json written")
        print(f"eval CLI ViT-B/16, {frames} frames in {batches} batches of {BATCH}: end to end "
              f"{frames / walls[0]:.1f} frames/s cold, {frames / walls[1]:.1f} frames/s with the "
              f"files cached ({walls[1]:.3f} s); forward alone {frames / forward_s:.1f} frames/s; "
              "stages alone, s: " + ", ".join(f"{k} {v:.3f}" for k, v in clock.items()))
    return counts


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="stop after phase 2 (each kernel against its plain version, with "
                             "its times): no path is driven and no result line is printed")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    print(smi.stdout.strip().splitlines()[0])
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    start = time.perf_counter()
    _build.library()
    print(f"kernels built and loaded in {time.perf_counter() - start:.1f} s "
          f"({_build.library_path()})")

    report = phase_kernels(torch.Generator(device="cuda").manual_seed(SEED))
    if args.kernels_only:
        print(json.dumps({"kernels": [{"name": name, **fields} for name, fields in report.items()]}))
        return
    # Each path's launches, counted from 0 before it and read after it.
    runs = [phase_eval(torch.Generator().manual_seed(SEED)), phase_pretrain(), phase_finetune(),
            phase_attention_ops(torch.Generator().manual_seed(SEED)), phase_eval_cli()]
    counts = {name: sum(run.get(name, 0) for run in runs) for name in report}
    missing = [name for name, n in counts.items() if n == 0]
    if missing:
        fail(f"no path launched {missing}")
    kernels = [{"name": name, **fields, "launches": counts[name]}
               for name, fields in report.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
