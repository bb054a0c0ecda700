"""How close the eval forward of a ViT-B/16 at 384 px (577 tokens) comes to
``chip_smoke.py``'s logits limits, seed by seed, on the card: the port's
kernels against the plain path, unfolded and under ``BENCH_ATTN_PROJ=1``,
and every bf16 path (the kernels and the plain versions, unfolded and
folded) against one fp32 forward of the same weights through the plain
path, with TF32 off for matrix products and convolutions.

For each seed the weights (``chip_smoke.py``'s numpy-seeded JAX-layout
tree) and two batches of 64 uint8 images are drawn as phase 16 draws them
for seed 0.  Each line gives, for each comparison, the worst |diff|, the
logits' largest magnitude, the worst share of the limit ``atol + rtol *
|ref|`` (``chip_smoke.LOGITS_TOL``) that an element used, and whether the
folded logits equal the unfolded kernels' bit for bit; then phase 16's
577-token check (``chip_smoke.long_logits_check``) on the kernels, unfolded
and folded, and on deliberately wrong attentions swapped into the plain
unfolded path (``FAULTS``), to show what the check's limit catches.  First,
once, each wrong attention and the kernels against the plain attention at
phase 2's shape (B 64, N 577, 12 heads of 64, a bias), as a share of
``chip_smoke.ATTENTION_TOL``'s limit.

Run from the repo root on a machine with a CUDA card:
  python3 scripts/torch/logits_margin_384.py [--seeds 0 1 2 3 4 5 6 7]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from ssl4polyp_tpu_torch.models import layers  # noqa: E402
from ssl4polyp_tpu_torch.models.factory import get_imagenet_or_random_vit  # noqa: E402
from ssl4polyp_tpu_torch.ops import qkv_attention  # noqa: E402
from ssl4polyp_tpu_torch.models.vit import ViTConfig  # noqa: E402
from ssl4polyp_tpu_torch.profiling import projection_fold  # noqa: E402
from ssl4polyp_tpu_torch.training.classification import make_forward_fn  # noqa: E402


def margin(got: list[np.ndarray], ref: list[np.ndarray]) -> dict:
    """The worst |diff|, max |ref| and worst share of LOGITS_TOL's limit."""
    got, ref = torch.from_numpy(np.concatenate(got)), torch.from_numpy(np.concatenate(ref))
    return {"max_abs_diff": (got - ref).abs().max().item(),
            "max_abs_logit": ref.abs().max().item(),
            "limit_share": cs.limit_share(got, ref, cs.LOGITS_TOL)}


def bf16_scores(qkv, num_heads, softmax_f32=True, valid_len=None, bias=None):
    """The plain attention with its fp32 scores rounded to bf16 before the
    softmax, where the classifier states fp32 scores: a wrong result."""
    return qkv_attention.fused_qkv_attention_reference(qkv, num_heads, False, valid_len, bias)


def unnormalised_weights(qkv, num_heads, softmax_f32=True, valid_len=None, bias=None):
    """The plain attention with exp(s - max) rounded to bf16 before the
    product with v and the division by the sum after it (an online
    softmax's rounding), where the TPU kernel rounds the normalised weights:
    a wrong result."""
    if valid_len is not None:
        raise ValueError("every key weighted")
    dtype = qkv.dtype
    if bias is not None:
        qkv = qkv + bias
    B, N, three_d = qkv.shape
    D = three_d // 3
    head_dim = D // num_heads
    q, k, v = qkv.reshape(B, N, 3, num_heads, head_dim).permute(2, 0, 3, 1, 4)
    q = q * torch.tensor(qkv_attention._scale(head_dim, dtype), dtype=dtype, device=qkv.device)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    out = torch.matmul(e.to(dtype).float(), v.float()) / e.sum(dim=-1, keepdim=True)
    return out.to(dtype).permute(0, 2, 1, 3).reshape(B, N, D)


def last_tile_dropped(qkv, num_heads, softmax_f32=True, valid_len=None, bias=None):
    """The plain attention with keys 512 .. N - 1 left out (at 577 tokens the
    ragged last of the forward's 128-key tiles): a wrong result."""
    return qkv_attention.fused_qkv_attention_reference(qkv, num_heads, softmax_f32, 512, bias)


def last_key_dropped(qkv, num_heads, softmax_f32=True, valid_len=None, bias=None):
    """The plain attention with key N - 1 left out: a wrong result."""
    return qkv_attention.fused_qkv_attention_reference(qkv, num_heads, softmax_f32,
                                                       qkv.shape[1] - 1, bias)


FAULTS = {"bf16_scores": bf16_scores, "unnormalised_weights": unnormalised_weights,
          "last_tile_dropped": last_tile_dropped, "last_key_dropped": last_key_dropped}


def attention_shares() -> dict:
    """The kernels and each of ``FAULTS`` against the plain attention on one
    random bf16 qkv and bias at phase 2's shape, as the worst share of
    ATTENTION_TOL's limit atol + rtol * |ref|."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    heads, width = 12, 768
    qkv = torch.randn(cs.BATCH, 577, 3 * width, generator=gen, device="cuda").to(torch.bfloat16)
    bias = (torch.randn(3 * width, generator=gen, device="cuda") * 0.5).to(torch.bfloat16)
    ref = qkv_attention.fused_qkv_attention_reference(qkv, heads, True, None, bias).float()
    paths = {"kernels": qkv_attention._forward_kernel, **FAULTS}
    return {name: cs.limit_share(fn(qkv, heads, True, None, bias).float(), ref, cs.ATTENTION_TOL)
            for name, fn in paths.items()}


def one_seed(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    base = ViTConfig(pos_embed="learned", num_classes=2, img_size=cs.LONG_IMAGE)
    tree = cs.jax_layout_tree(base, rng)
    requests = [rng.integers(0, 256, (cs.BATCH, cs.LONG_IMAGE, cs.LONG_IMAGE, 3),
                             dtype=np.uint8) for _ in range(2)]
    result: dict = {"seed": seed}
    logits, plain, faulty = {}, {}, {}
    for fold in (False, True):
        with projection_fold(fold):
            clf = get_imagenet_or_random_vit(
                torch.Generator().manual_seed(seed), jax_params=tree, num_classes=2,
                device="cuda", img_size=cs.LONG_IMAGE)
        forward = make_forward_fn(clf, "cuda")()
        logits[fold] = [forward(images) for images in requests]
        with cs.plain_kernels():
            plain[fold] = [forward(images) for images in requests]
            if not fold:  # plain_kernels() puts the kernels back after
                for name, attention in FAULTS.items():
                    layers.fused_qkv_attention = attention
                    faulty[name] = [forward(images) for images in requests]
        result["fold" if fold else "unfolded"] = margin(logits[fold], plain[fold])
        del clf, forward
        torch.cuda.empty_cache()
    result["fold_equals_unfolded"] = all(
        np.array_equal(a, b) for a, b in zip(logits[True], logits[False]))
    ref32 = cs.plain_fp32_logits(seed, tree, requests, cs.LONG_IMAGE)
    paths = {"kernels": logits[False], "kernels_fold": logits[True], "plain": plain[False],
             "plain_fold": plain[True]}
    result["against_fp32"] = {name: margin(got, ref32) for name, got in paths.items()}
    result["check"] = {
        name: cs.long_logits_check(np.concatenate(logits[fold]), np.concatenate(plain[False]),
                                   np.concatenate(plain[True]), np.concatenate(ref32))
        for name, fold in (("kernels", False), ("kernels_fold", True))}
    result["faults"] = {
        name: cs.long_logits_check(np.concatenate(got), np.concatenate(plain[False]),
                                   np.concatenate(plain[True]), np.concatenate(ref32))
        for name, got in faulty.items()}
    return result


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5, 6, 7])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("logits_margin_384.py: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"limit atol {cs.LOGITS_TOL[0]} + rtol {cs.LOGITS_TOL[1]} * |ref|; batch {cs.BATCH}, "
          f"2 requests a seed, {cs.LONG_IMAGE} px")
    print(json.dumps({"attention_tol_shares": attention_shares()}), flush=True)
    for seed in args.seeds:
        print(json.dumps(one_seed(seed)), flush=True)


if __name__ == "__main__":
    main()
