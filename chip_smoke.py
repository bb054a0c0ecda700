#!/usr/bin/env python3
"""Drive the PyTorch port's eval forward, MAE pretrain step and classifier
fine-tune step on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases:

1. Device and build: requires CUDA, prints the card's name and power limit,
   builds the CUDA kernels from ``ssl4polyp_tpu_torch/ops/csrc``.
2. Each kernel against its plain torch version on the card, in bf16, at the
   eval and pretrain paths' shapes, forward and backward: max error against
   the stated tolerance, and the kernel's and the plain version's times from
   CUDA events.
3. The eval forward: a full-width ViT-B/16 2-class classifier, weights from
   a numpy-seeded tree in the JAX package's layout, answers 8 requests of 64
   uint8 224x224 images through ``make_forward_fn``.  Per request, attention
   and fc1+GELU must launch exactly 12 times and LayerNorm 25 (no backward
   kernel); the logits must be finite and match the same forward with every
   kernel swapped for its plain version.  Prints images/s for both, median
   and range over 5 repeats of 10 requests.
4. The MAE ViT-B/16 pretrain step at full width, batch 64: weights from a
   numpy-seeded JAX-layout tree through ``mae_state_dict_from_jax``; step 1's
   loss and every parameter's gradient against the plain step's; then 6
   steps through ``make_pretrain_step`` with exact launch counts per step,
   finite losses and parameters and both sin-cos tables unchanged; then the
   same 6 steps from the same state with every kernel swapped for its plain
   version.  Prints images/s for both, median and range over 5 repeats of
   10 further steps, and the model TFLOP/s at the median.
5. The ViT-B/16 classifier's fine-tune step at full width, batch 64 (on-device
   augmentation, BCE, backward, AdamW with fine-tune scales), weights from a
   numpy-seeded JAX-layout tree, under its three kernel configurations: the
   default (fc1+GELU), ``mlp_fusion="full_ln"`` with ``qkv_ln_fusion`` (the
   LN+MLP and LN+QKV kernels) and ``mlp_fusion="full"`` (the fused MLP).
   For each: step 1's loss and every gradient against the plain step's; 6
   steps with exact launch counts per step, finite losses and parameters;
   2 steps under the ``head+1`` regime, after which every frozen parameter
   keeps its bits; images/s for the kernels and the plain path, median and
   range over 5 repeats of 10 steps.

The last two lines of standard output are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero,
and without a CUDA device the script exits non-zero before printing a result.
"""

from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from ssl4polyp_tpu_torch import ops
from ssl4polyp_tpu_torch.models import layers
from ssl4polyp_tpu_torch.models.factory import get_imagenet_or_random_vit
from ssl4polyp_tpu_torch.models.mae import MAE, MAEConfig
from ssl4polyp_tpu_torch.models.pos_embed import sincos_2d
from ssl4polyp_tpu_torch.models.vit import ViTConfig
from ssl4polyp_tpu_torch.models.weights import mae_state_dict_from_jax
from ssl4polyp_tpu_torch.ops import _build, layernorm, ln_linear, mlp, qkv_attention
from ssl4polyp_tpu_torch.profiling import FINETUNE_CONFIGS, REPEAT_CALLS, REPEATS, rates, spread
from ssl4polyp_tpu_torch.training import optim
from ssl4polyp_tpu_torch.training.classification import (
    TrainContext,
    init_train_state,
    loss_and_grads,
    loss_settings,
    make_forward_fn,
    make_train_step,
)
from ssl4polyp_tpu_torch.data.augment import draw_augment_params
from ssl4polyp_tpu_torch.training.pretrain import loss_and_grads as pretrain_loss_and_grads
from ssl4polyp_tpu_torch.training.pretrain import (
    PretrainSettings,
    init_pretrain_state,
    make_pretrain_step,
    model_config,
)
from ssl4polyp_tpu_torch.training.schedules import warmup_cosine

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


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


@contextlib.contextmanager
def plain_kernels():
    """Swap every kernel of the models' paths, forward and backward, for its
    plain torch version."""
    plain = {
        "fused_qkv_attention": qkv_attention.fused_qkv_attention_plain,
        "fc1_gelu": mlp.fc1_gelu_plain,
        "layernorm": layernorm.layernorm_reference,
        "ln_linear": ln_linear.ln_linear_plain,
        "mlp_fused": mlp.mlp_fused_plain,
        "mlp_ln_fused": mlp.mlp_ln_fused_plain,
    }
    saved = {name: getattr(layers, name) for name in plain}
    for name, fn in plain.items():
        setattr(layers, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(layers, name, fn)


def entry(source: str, replaces: str, err: float, ms: float, plain_ms: float) -> dict:
    return {"route": "cuda", "source": f"ssl4polyp_tpu_torch/ops/csrc/{source}",
            "replaces": replaces, "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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
    for i, (b, n, h, hd, f32, valid_len, with_bias) in enumerate(cases):
        qkv = randn(b, n, 3 * h * hd)
        bias = randn(3 * h * hd, scale=0.5) if with_bias else None
        run = lambda: qkv_attention.fused_qkv_attention(qkv, h, f32, valid_len, bias)  # noqa: E731
        plain = lambda: qkv_attention.fused_qkv_attention_reference(qkv, h, f32, valid_len, bias)  # noqa: E731
        out = run()
        torch.cuda.synchronize()
        what = f"attention B={b} N={n} H={h} hd={hd} f32={f32} valid_len={valid_len} bias={with_bias}"
        errors.append(max_error(out, plain(), ATTENTION_TOL, what))
        print(f"{what}: max |diff| {errors[-1]:.3e} (atol {ATTENTION_TOL[0]}, rtol {ATTENTION_TOL[1]})")
        if i in (2, 5, 6):
            times[i] = time_ms(run), time_ms(plain)
            print(f"  kernel {times[i][0]:.4f} ms, plain {times[i][1]:.4f} ms")
    report["fused_qkv_attention"] = entry(
        "qkv_attention.cu", "ssl4polyp_tpu/ops/qkv_attention.py:91", max(errors), *times[2])

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
    for i, (b, n, h, hd, f32, valid_len, with_bias) in enumerate(cases):
        qkv, dout = randn(b, n, 3 * h * hd), randn(b, n, h * hd)
        bias = randn(3 * h * hd, scale=0.5) if with_bias else None
        run = lambda: qkv_attention._backward_kernel(qkv, dout, h, f32, valid_len, bias)  # noqa: E731
        plain = lambda: qkv_attention.fused_qkv_attention_backward_reference(  # noqa: E731
            qkv, dout, h, f32, valid_len, bias)
        (dqkv, dbias), again = run(), run()
        torch.cuda.synchronize()
        ref_dqkv, ref_dbias = plain()
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
        print(line + "; rerun bit-identical")
        if i in (0, 1, 6):
            times[i] = time_ms(run), time_ms(plain)
            print(f"  kernel {times[i][0]:.4f} ms, plain {times[i][1]:.4f} ms")
    report["fused_qkv_attention_backward"] = entry(
        "qkv_attention.cu", "ssl4polyp_tpu/ops/qkv_attention.py:108", max(errors), *times[1])

    # LayerNorm forward and backward: the pretrain encoder's and decoder's
    # rows, then the eval forward's.  The plain backward is autograd's of the
    # plain forward, timed alone.
    fwd_errors, bwd_errors, fwd_times, bwd_times = [], [], {}, {}
    for i, (m, d) in enumerate([(BATCH * 50, 768), (BATCH * 197, 512), (BATCH * 197, 768)]):
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
        print(f"{what}: y max |diff| {fwd_errors[-1]:.3e}, dx {bwd_errors[-1]:.3e} (atol "
              f"{LN_TOL[0]}, rtol {LN_TOL[1]}); dweight, dbias {param_err:.3e} (atol "
              f"{LN_PARAM_TOL[0]}, rtol {LN_PARAM_TOL[1]}); rerun bit-identical")
        fwd_times[i] = time_ms(run), time_ms(plain)
        bwd_times[i] = time_ms(run_bwd), time_ms(plain_bwd)
        print(f"  forward kernel {fwd_times[i][0]:.4f} ms, plain {fwd_times[i][1]:.4f} ms; "
              f"backward kernel {bwd_times[i][0]:.4f} ms, plain {bwd_times[i][1]:.4f} ms")
    report["layernorm"] = entry(
        "layernorm.cu", "ssl4polyp_tpu/ops/layernorm.py:32", max(fwd_errors), *fwd_times[1])
    report["layernorm_backward"] = entry(
        "layernorm.cu", "ssl4polyp_tpu/ops/layernorm.py:69", max(bwd_errors), *bwd_times[1])

    # fc1+GELU: the pretrain calls write h for the backward; the eval call
    # writes y only.
    errors, times = [], {}
    for i, (m, k, nf, write_h) in enumerate([(BATCH * 50, 768, 3072, True),
                                             (BATCH * 197, 512, 2048, True),
                                             (BATCH * 197, 768, 3072, False)]):
        x, w, bias = randn(m, k), randn(nf, k, scale=k ** -0.5), randn(nf, scale=0.5)
        run = lambda: mlp._kernel(x, w, bias, write_h)  # noqa: E731
        plain = lambda: mlp.fc1_gelu_reference(x, w, bias)  # noqa: E731
        h, y = run()
        torch.cuda.synchronize()
        what = f"fc1_gelu ({m}, {k}) -> {nf}, h written: {write_h}"
        errors.append(max_error(y, plain(), FC1_TOL, f"{what}: y"))
        if write_h:
            errors.append(max_error(h, torch.matmul(x, w.t()) + bias, FC1_TOL, f"{what}: h"))
        times[i] = time_ms(run), time_ms(plain)
        print(f"{what}: max |diff| {max(errors[-2:]):.3e} (atol {FC1_TOL[0]}, rtol {FC1_TOL[1]}); "
              f"kernel {times[i][0]:.4f} ms, plain {times[i][1]:.4f} ms")
    report["fc1_gelu"] = entry("mlp.cu", "ssl4polyp_tpu/ops/mlp.py:73", max(errors), *times[1])

    # The fine-tune path's fused kernels at its shapes, then the MAE
    # decoder's.  Beside the plain version (fp32 products of the rounded
    # operands, the kernels' roundings) is timed the fastest unfused bf16
    # chain: the LayerNorm kernel, cuBLAS products, bias adds and GELU.
    def affine(d):
        return 1.0 + 0.1 * randn(d, dtype=torch.float32), 0.1 * randn(d, dtype=torch.float32)

    errors, times = [], {}
    for i, (m, k, n) in enumerate([(BATCH * 197, 768, 2304), (BATCH * 197, 512, 1536)]):
        x, (s, t) = randn(m, k), affine(k)
        w, bias = randn(n, k, scale=k ** -0.5), randn(n, scale=0.5)
        run = lambda: ln_linear._kernel(x, s, t, w, bias, 1e-6)  # noqa: E731
        plain = lambda: ln_linear.ln_linear_reference(x, s, t, w, bias, 1e-6)  # noqa: E731
        unfused = lambda: layers.linear(layernorm._forward_kernel(x, s, t, 1e-6), w, bias)  # noqa: E731
        out, again = run(), run()
        torch.cuda.synchronize()
        what = f"ln_linear ({m}, {k}) -> {n}"
        errors.append(max_error(out, plain(), FUSED_TOL, what))
        if not torch.equal(out, again):
            fail(f"{what}: two runs gave different bits")
        times[i] = time_ms(run), time_ms(plain), time_ms(unfused)
        print(f"{what}: max |diff| {errors[-1]:.3e} (atol {FUSED_TOL[0]}, rtol {FUSED_TOL[1]}); "
              f"kernel {times[i][0]:.4f} ms, plain {times[i][1]:.4f} ms, unfused bf16 chain "
              f"{times[i][2]:.4f} ms")
    report["ln_linear"] = entry("ln_linear.cu", "ssl4polyp_tpu/ops/ln_linear.py:28", max(errors),
                                *times[0][:2])

    for name, with_ln, line in (("mlp_fused", False, 188), ("mlp_ln_fused", True, 332)):
        errors, times = [], {}
        for i, (m, k, nf) in enumerate([(BATCH * 197, 768, 3072), (BATCH * 197, 512, 2048)]):
            x = randn(m, k)
            s, t = affine(k) if with_ln else (None, None)
            w1, b1 = randn(nf, k, scale=k ** -0.5), randn(nf, scale=0.5)
            w2, b2 = randn(k, nf, scale=nf ** -0.5), randn(k, scale=0.5)
            run = lambda: mlp._fused_kernel(x, s, t, w1, b1, w2, b2, 1e-6, True)  # noqa: E731
            plain = lambda: mlp._mlp_forward_plain(x, s, t, w1, b1, w2, b2, 1e-6)  # noqa: E731

            def unfused():
                a = x if s is None else layernorm._forward_kernel(x, s, t, 1e-6)
                out = layers.linear(mlp.fc1_gelu_reference(a, w1, b1), w2, b2)
                return out if s is None else x + out

            (h, out), (h2, out2) = run(), run()
            torch.cuda.synchronize()
            what = f"{name} ({m}, {k}) -> {nf} -> {k}, h written"
            ref_h, ref_out = plain()
            errors.append(max(max_error(h, ref_h, FUSED_TOL, f"{what}: h"),
                              max_error(out, ref_out, FUSED_TOL, f"{what}: out")))
            if not (torch.equal(h, h2) and torch.equal(out, out2)):
                fail(f"{what}: two runs gave different bits")
            times[i] = time_ms(run), time_ms(plain), time_ms(unfused)
            print(f"{what}: max |diff| {errors[-1]:.3e} (atol {FUSED_TOL[0]}, rtol "
                  f"{FUSED_TOL[1]}); kernel {times[i][0]:.4f} ms, plain {times[i][1]:.4f} ms, "
                  f"unfused bf16 chain {times[i][2]:.4f} ms")
        report[name] = entry("mlp.cu", f"ssl4polyp_tpu/ops/mlp.py:{line}", max(errors),
                             *times[0][:2])
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
    classifier = get_imagenet_or_random_vit(
        gen, jax_params=jax_layout_tree(cfg, rng), num_classes=2, device="cuda"
    )
    forward = make_forward_fn(classifier, "cuda")
    requests = [rng.integers(0, 256, (BATCH, 224, 224, 3), dtype=np.uint8)
                for _ in range(REQUESTS)]

    forward(requests[0])  # warm-up
    ops.reset_launch_counts()
    logits = [forward(images) for images in requests]
    counts = ops.launch_counts()
    per_request = {"fused_qkv_attention": cfg.depth, "layernorm": 2 * cfg.depth + 1,
                   "fc1_gelu": cfg.depth}
    check_counts(counts, per_request, REQUESTS, f"{REQUESTS} eval requests")

    rate = rates(lambda: forward(requests[0]), BATCH, REPEATS, REPEAT_CALLS)
    ops.reset_launch_counts()
    with plain_kernels():
        plain_logits = [forward(images) for images in requests]
        plain_rate = rates(lambda: forward(requests[0]), BATCH, REPEATS, REPEAT_CALLS)
    if any(ops.launch_counts().values()):
        fail("the plain forward launched a kernel")
    errors = []
    for got, ref in zip(logits, plain_logits):
        if got.shape != (BATCH, 2) or got.dtype != np.float32:
            fail(f"logits {got.shape} {got.dtype}, expected ({BATCH}, 2) float32")
        errors.append(max_error(torch.from_numpy(got), torch.from_numpy(ref), LOGITS_TOL, "logits"))
    print(f"logits vs plain forward: max |diff| {max(errors):.3e} "
          f"(atol {LOGITS_TOL[0]}, rtol {LOGITS_TOL[1]}); logit range "
          f"[{min(l.min() for l in logits):.3f}, {max(l.max() for l in logits):.3f}]")
    print(f"eval forward ViT-B/16, batch {BATCH}, images/s over {REPEATS} repeats of "
          f"{REPEAT_CALLS} requests: kernels {spread(rate)}; plain {spread(plain_rate)}")
    return counts


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
    return counts


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
    for label, overrides in FINETUNE_CONFIGS:
        def fresh_state():
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

        ops.reset_launch_counts()
        losses = train(state)
        counts = ops.launch_counts()
        mlp_route, qkv_ln = classifier.model.blocks[0].mlp_route, classifier.model.blocks[0].qkv_ln
        # The final norm and each block's two: where a fused kernel folds a
        # LayerNorm in, its backward recomputes the normalised row and takes
        # the LayerNorm backward on the LayerNorm kernels, once each.
        per_step = {
            "fused_qkv_attention": depth,
            "fused_qkv_attention_backward": depth,
            "layernorm": 2 * depth + 1,
            "layernorm_backward": 2 * depth + 1,
            "ln_linear": depth if qkv_ln else 0,
            {"fc1": "fc1_gelu", "full": "mlp_fused", "full_ln": "mlp_ln_fused"}[mlp_route]: depth,
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


def main() -> None:
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
    # Each path's launches, counted from 0 before it and read after it.
    runs = [phase_eval(torch.Generator().manual_seed(SEED)), phase_pretrain(), phase_finetune()]
    counts = {name: sum(run[name] for run in runs) for name in report}
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
