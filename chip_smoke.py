#!/usr/bin/env python3
"""Drive the PyTorch port's eval forward once on one NVIDIA GPU.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases:

1. Device and build: requires CUDA, prints the card's name and power limit,
   builds the CUDA kernels from ``ssl4polyp_tpu_torch/ops/csrc``.
2. Each kernel against its plain torch version on the card, in bf16, at the
   eval path's shapes: max error against the stated tolerance, and the
   kernel's and the plain version's times from CUDA events.
3. The slice: a full-width ViT-B/16 2-class classifier, weights from a
   numpy-seeded tree in the JAX package's layout, answers 8 requests of 64
   uint8 224x224 images through ``make_forward_fn``.  Each kernel must launch
   exactly 12 times per request (once per block), and the logits must be
   finite and match the same forward with every kernel swapped for its plain
   version.  Prints images/s for both.

The last two lines of standard output are a JSON summary of the kernels and
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero,
and without a CUDA device the script exits non-zero before printing a result.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import time

import numpy as np
import torch

from ssl4polyp_tpu_torch import ops
from ssl4polyp_tpu_torch.models import layers
from ssl4polyp_tpu_torch.models.factory import get_imagenet_or_random_vit
from ssl4polyp_tpu_torch.models.vit import ViTConfig
from ssl4polyp_tpu_torch.ops import _build, mlp, qkv_attention
from ssl4polyp_tpu_torch.training.classification import make_forward_fn

SEED = 0
BATCH = 64
REQUESTS = 8
# |kernel - plain| <= atol + rtol * |plain|, elementwise, in bf16.  The plain
# attention makes the same roundings, so only fp32 summation order and expf
# differ: a flipped bf16 rounding of the output is 1 ulp, 2^-8 relative.  The
# plain fc1 rounds h to bf16 before the GELU and the kernel does not, so
# they may differ by up to 2 bf16 ulps (2^-6 relative).
ATTENTION_TOL = (1e-2, 1e-2)
FC1_TOL = (1e-2, 1.6e-2)
# Logits after 12 blocks of such 1-ulp differences in the residual stream.
LOGITS_TOL = (5e-2, 5e-2)


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
    """Swap every kernel of the model's path for its plain torch version."""
    saved = layers.fused_qkv_attention, layers.fc1_gelu
    layers.fused_qkv_attention = qkv_attention.fused_qkv_attention_reference
    layers.fc1_gelu = mlp.fc1_gelu_reference
    try:
        yield
    finally:
        layers.fused_qkv_attention, layers.fc1_gelu = saved


def phase_kernels(gen: torch.Generator) -> dict[str, dict]:
    dev = "cuda"

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    report = {}
    # (batch, tokens, heads, head dim, fp32 scores, valid_len, bias); the
    # third case is the eval path's own call.
    cases = [
        (BATCH, 197, 12, 64, True, None, False),
        (BATCH, 197, 12, 64, True, 150, False),
        (BATCH, 197, 12, 64, True, None, True),
        (BATCH, 197, 12, 64, True, 150, True),
        (BATCH, 197, 16, 32, False, None, False),
    ]
    errors = []
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
        if i == 2:
            ms, plain_ms = time_ms(run), time_ms(plain)
            print(f"  kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    report["fused_qkv_attention"] = {
        "route": "cuda",
        "source": "ssl4polyp_tpu_torch/ops/csrc/qkv_attention.cu",
        "replaces": "ssl4polyp_tpu/ops/qkv_attention.py:91",
        "max_abs_err": max(errors), "ms": ms, "plain_ms": plain_ms,
    }

    m, k, nf = BATCH * 197, 768, 3072
    x, w, bias = randn(m, k), randn(nf, k, scale=k ** -0.5), randn(nf, scale=0.5)
    run = lambda: mlp.fc1_gelu(x, w, bias)  # noqa: E731
    plain = lambda: mlp.fc1_gelu_reference(x, w, bias)  # noqa: E731
    out = run()
    torch.cuda.synchronize()
    err = max_error(out, plain(), FC1_TOL, f"fc1_gelu ({m}, {k}) -> {nf}")
    ms, plain_ms = time_ms(run), time_ms(plain)
    print(f"fc1_gelu ({m}, {k}) -> {nf}: max |diff| {err:.3e} (atol {FC1_TOL[0]}, "
          f"rtol {FC1_TOL[1]}); kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    report["fc1_gelu"] = {
        "route": "cuda",
        "source": "ssl4polyp_tpu_torch/ops/csrc/mlp.cu",
        "replaces": "ssl4polyp_tpu/ops/mlp.py:73",
        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
    }
    return report


def jax_layout_tree(cfg: ViTConfig, rng: np.random.Generator) -> dict:
    """Random ViT weights in the JAX package's pytree layout, as numpy."""
    D, depth, hidden = cfg.embed_dim, cfg.depth, int(cfg.embed_dim * cfg.mlp_ratio)

    def linear(d_in, d_out, stack=None):
        lead = () if stack is None else (stack,)
        limit = np.sqrt(6.0 / (d_in + d_out))
        return {"kernel": rng.uniform(-limit, limit, lead + (d_in, d_out)).astype(np.float32),
                "bias": (0.02 * rng.standard_normal(lead + (d_out,))).astype(np.float32)}

    def norm(stack=None):
        shape = (D,) if stack is None else (stack, D)
        return {"scale": (1.0 + 0.1 * rng.standard_normal(shape)).astype(np.float32),
                "bias": (0.02 * rng.standard_normal(shape)).astype(np.float32)}

    return {
        "patch_embed": linear(cfg.patch_dim, D),
        "cls_token": (0.02 * rng.standard_normal((1, 1, D))).astype(np.float32),
        "pos_embed": (0.02 * rng.standard_normal((1, cfg.num_patches + 1, D))).astype(np.float32),
        "blocks": {
            "ln1": norm(depth),
            "attn": {"qkv": linear(D, 3 * D, depth), "proj": linear(D, D, depth)},
            "ln2": norm(depth),
            "mlp": {"fc1": linear(D, hidden, depth), "fc2": linear(hidden, D, depth)},
        },
        "norm": norm(),
        "head": linear(D, cfg.num_classes),
    }


def serve(forward, requests) -> tuple[list[np.ndarray], float]:
    start = time.perf_counter()
    logits = [forward(images) for images in requests]
    return logits, len(requests) * BATCH / (time.perf_counter() - start)


def phase_slice(gen: torch.Generator) -> dict[str, int]:
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
    logits, rate = serve(forward, requests)
    counts = ops.launch_counts()
    expected = REQUESTS * cfg.depth
    print(f"kernel launches over {REQUESTS} requests: {counts} "
          f"(expected {cfg.depth} per kernel per request)")
    if any(count != expected for count in counts.values()):
        fail(f"launch counts {counts}, expected {expected} each")

    with plain_kernels():
        forward(requests[0])  # warm-up
        plain_logits, plain_rate = serve(forward, requests)
    if ops.launch_counts() != counts:
        fail("the plain forward launched a kernel")
    errors = []
    for got, ref in zip(logits, plain_logits):
        if got.shape != (BATCH, 2) or got.dtype != np.float32:
            fail(f"logits {got.shape} {got.dtype}, expected ({BATCH}, 2) float32")
        errors.append(max_error(torch.from_numpy(got), torch.from_numpy(ref), LOGITS_TOL, "logits"))
    print(f"logits vs plain forward: max |diff| {max(errors):.3e} "
          f"(atol {LOGITS_TOL[0]}, rtol {LOGITS_TOL[1]}); logit range "
          f"[{min(l.min() for l in logits):.3f}, {max(l.max() for l in logits):.3f}]")
    print(f"eval forward ViT-B/16, batch {BATCH}: kernels {rate:.1f} images/s, "
          f"plain {plain_rate:.1f} images/s")
    return counts


def main() -> None:
    if not torch.cuda.is_available():
        fail("no CUDA device: this script measures the port on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    with torch.inference_mode():
        report = phase_kernels(gen)
    counts = phase_slice(torch.Generator().manual_seed(SEED))
    kernels = [{"name": name, **entry, "launches": counts[name]}
               for name, entry in report.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
