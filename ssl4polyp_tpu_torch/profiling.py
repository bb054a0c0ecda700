"""Where the time goes: the MAE pretrain step, the classifier's fine-tune
step and the eval forward on one CUDA card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python -m ssl4polyp_tpu_torch.profiling [--table PATH]

For each path, at full width (MAE ViT-B/16 at batch 64, accum 1, bf16; the
ViT-B/16 2-class classifier's fine-tune step at batch 64, bf16 with fp32
scores, full fine-tuning, under each of its four kernel configurations, the
last with ``BENCH_ATTN_PROJ=1``; its eval forward at batch 64) with random
weights from a seed:

1. the rate without the profiler: images/s over 5 repeats of 10 steps (or
   requests) after warm-up, median and range;
2. ``torch.profiler`` over 5 more steps: device time per step by
   category (each hand-written kernel, cuBLAS, the foreach ops,
   elementwise, copies, reductions, the rest) with launches per step, and
   the device's idle share against the unprofiled median wall time and
   against the wall time under the profiler.

``--table`` writes the profiler's full per-kernel tables there.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import os
import statistics
import subprocess
import time

import numpy as np
import torch

__all__ = ["FINETUNE_CONFIGS", "category", "main", "projection_fold", "rates", "spread"]

REPEATS, REPEAT_CALLS, PROFILE_CALLS = 5, 10, 5
# The classifier's kernel configurations: (label, model overrides, whether
# the model is built under BENCH_ATTN_PROJ=1).
FINETUNE_CONFIGS = (
    ("fc1", {}, False),
    ("full_ln+qkv_ln", {"mlp_fusion": "full_ln", "qkv_ln_fusion": True}, False),
    ("full", {"mlp_fusion": "full"}, False),
    ("fc1+attn_proj", {}, True),
)

# (substring of the kernel's name, category), first match wins.
_CATEGORIES = (
    ("dw_product_kernel", "attention+projection backward: dW kernel"),
    ("dw_slice_sum_kernel", "column sums of the kernels' parameter gradients"),
    ("dy_column_partial_kernel", "column sums of the kernels' parameter gradients"),
    ("attn_proj_kernel", "attention+projection kernel (forward, and the backward's O and dO)"),
    ("attn_proj_transpose_kernel",
     "attention+projection kernel (forward, and the backward's O and dO)"),
    ("adamw_kernel", "AdamW kernel (one pass, with the compute copy)"),
    ("qkv_attention_bwd_kernel", "attention backward kernel"),
    ("qkv_attention_kernel", "attention forward kernel"),
    ("layernorm_bwd_kernel", "LayerNorm backward kernel"),
    ("layernorm_fwd_kernel", "LayerNorm forward kernel"),
    ("column_sum_kernel", "column sums of the kernels' parameter gradients"),
    ("fc1_gelu_kernel", "fc1+GELU kernel"),
    ("mlp_fused_kernel", "fused MLP kernel (fc1+GELU+fc2, with or without LN)"),
    ("ln_linear_kernel", "LN+QKV kernel"),
    ("ln_linear_stats_kernel", "LN+QKV kernel"),
    ("multi_tensor_apply", "foreach ops (gradient norm and sums)"),
    ("gemm", "cuBLAS GEMM"),
    ("nvjet", "cuBLAS GEMM"),
    ("cutlass", "cuBLAS GEMM"),
    ("xmma", "cuBLAS GEMM"),
    ("reduce", "reductions"),
    ("sort", "gathers, scatters and sorts"),
    ("gather", "gathers, scatters and sorts"),
    ("scatter", "gathers, scatters and sorts"),
    ("index", "gathers, scatters and sorts"),
    ("memcpy", "copies and casts"),
    ("copy", "copies and casts"),
    ("elementwise", "elementwise"),
)


def category(kernel: str) -> str:
    """The category of a device kernel, from its name."""
    low = kernel.lower()
    for key, name in _CATEGORIES:
        if key.lower() in low:
            return name
    return "the rest"


@contextlib.contextmanager
def projection_fold(on: bool):
    """``BENCH_ATTN_PROJ`` set to 1 or 0 for the models built inside: the
    knob is read where a model is built (``models/layers.py::block_route``)."""
    saved = os.environ.get("BENCH_ATTN_PROJ")
    os.environ["BENCH_ATTN_PROJ"] = "1" if on else "0"
    try:
        yield
    finally:
        if saved is None:
            del os.environ["BENCH_ATTN_PROJ"]
        else:
            os.environ["BENCH_ATTN_PROJ"] = saved


def rates(run, images_per_call: int, repeats: int, calls: int) -> list[float]:
    """Images/s of ``calls`` calls of ``run``, host clock, once per repeat."""
    out = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        out.append(calls * images_per_call / (time.perf_counter() - start))
    return out


def spread(values: list[float]) -> str:
    return (f"median {statistics.median(values):.1f}, range "
            f"{min(values):.1f}-{max(values):.1f}")


def _profile(run, what: str, calls: int, unprofiled_ms: float, tables: list[str]) -> None:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(calls):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3 / calls
    events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    times, launches = collections.defaultdict(float), collections.defaultdict(int)
    for e in events:
        times[category(e.key)] += e.self_device_time_total / 1e3 / calls
        launches[category(e.key)] += e.count
    total = sum(times.values())
    if total == 0.0:
        raise RuntimeError(f"{what}: the profiler recorded no device time")
    # The profiler slows the host, so the idle share is given against both
    # the wall time under it and the unprofiled median.
    print(f"== {what}: device {total:.3f} ms; wall {unprofiled_ms:.3f} ms unprofiled (median), "
          f"{wall_ms:.3f} ms under the profiler; device idle "
          f"{100 * (1 - total / unprofiled_ms):.1f} % unprofiled, "
          f"{100 * (1 - total / wall_ms):.1f} % under the profiler; "
          f"{sum(launches.values()) / calls:.0f} launches")
    for name, ms in sorted(times.items(), key=lambda kv: -kv[1]):
        print(f"  {100 * ms / total:5.1f} %  {ms:8.3f} ms  {launches[name] / calls:6.0f} launches  {name}")
    tables.append(f"== {what}\n" + prof.key_averages().table(
        sort_by="self_device_time_total", row_limit=60))


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--table", default=None, help="write the full per-kernel tables here")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profiling: no CUDA device")

    from .models.factory import get_imagenet_or_random_vit
    from .models.mae import MAE
    from .ops import _build
    from .training.classification import (TrainContext, init_train_state, loss_settings,
                                          make_forward_fn, make_train_step)
    from .training.optim import finetune_lr_scales, no_weight_decay_scales
    from .training.pretrain import (PretrainSettings, init_pretrain_state, make_pretrain_step,
                                    model_config)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.library()
    tables: list[str] = []

    settings = PretrainSettings()
    cfg = model_config(settings)
    batch = settings.batch_size
    state = init_pretrain_state(MAE(cfg, torch.Generator().manual_seed(0)).cuda())
    step = make_pretrain_step(cfg, 1, settings.weight_decay)
    gen = torch.Generator(device="cuda").manual_seed(0)
    images = torch.randint(0, 256, (1, batch, cfg.encoder.img_size, cfg.encoder.img_size, 3),
                           dtype=torch.uint8, device="cuda", generator=gen)
    noise = torch.rand((1, batch, cfg.encoder.num_patches), device="cuda", generator=gen)
    run = lambda: step(state, images, noise, 1e-4)  # noqa: E731
    for _ in range(3):
        run()
    measured = rates(run, batch, REPEATS, REPEAT_CALLS)
    print(f"pretrain step MAE ViT-B/16, batch {batch}, images/s over {REPEATS} repeats of "
          f"{REPEAT_CALLS} steps: {spread(measured)}")
    _profile(run, f"pretrain step (per step, {PROFILE_CALLS} steps)", PROFILE_CALLS,
             1e3 * batch / statistics.median(measured), tables)
    del state, run

    mode, pos_weight, class_weights = loss_settings([3000, 1000])
    images = images[0]
    labels = torch.randint(0, 2, (batch,), device="cuda", generator=gen)
    valid = torch.ones(batch, dtype=torch.bool, device="cuda")
    for label, overrides, fold in FINETUNE_CONFIGS:
        with projection_fold(fold):
            classifier = get_imagenet_or_random_vit(torch.Generator().manual_seed(0),
                                                    num_classes=2, device="cuda", **overrides)
        state = init_train_state(classifier, torch.Generator(device="cuda").manual_seed(0))
        step = make_train_step(TrainContext(classifier, mode, pos_weight, class_weights, 0.05))
        scales = finetune_lr_scales(state.params, "full", classifier.cfg.depth)
        wd_scales = no_weight_decay_scales(state.params)
        run = lambda: step(state, images, labels, valid, 1e-4, scales, wd_scales)  # noqa: E731
        for _ in range(3):
            run()
        measured = rates(run, batch, REPEATS, REPEAT_CALLS)
        print(f"fine-tune step ViT-B/16 [{label}], batch {batch}, images/s over {REPEATS} "
              f"repeats of {REPEAT_CALLS} steps: {spread(measured)}")
        _profile(run, f"fine-tune step [{label}] (per step, {PROFILE_CALLS} steps)",
                 PROFILE_CALLS, 1e3 * batch / statistics.median(measured), tables)
        del state, run, classifier

    classifier = get_imagenet_or_random_vit(torch.Generator().manual_seed(0), num_classes=2,
                                            device="cuda")
    forward = make_forward_fn(classifier, "cuda")()
    request = np.random.default_rng(0).integers(0, 256, (batch, 224, 224, 3), dtype=np.uint8)
    run = lambda: forward(request)  # noqa: E731
    for _ in range(3):
        run()
    measured = rates(run, batch, REPEATS, REPEAT_CALLS)
    print(f"eval forward ViT-B/16, batch {batch}, uint8 on the host to logits on the host, "
          f"images/s over {REPEATS} repeats of {REPEAT_CALLS} requests: {spread(measured)}")
    _profile(run, f"eval forward (per request, {PROFILE_CALLS} requests)", PROFILE_CALLS,
             1e3 * batch / statistics.median(measured), tables)
    if args.table:
        with open(args.table, "w") as f:
            f.write("\n\n".join(tables))


if __name__ == "__main__":
    main()
