"""How close the eval forward of a ViT-B/16 at 384 px (577 tokens) comes to
``chip_smoke.py``'s logits limit, seed by seed: the port's kernels against
the plain path, unfolded and under ``BENCH_ATTN_PROJ=1``, on the card.

For each seed the weights (``chip_smoke.py``'s numpy-seeded JAX-layout
tree) and two batches of 64 uint8 images are drawn as phase 16 draws them
for seed 0.  Each line gives the worst |diff|, the logits' largest
magnitude, the worst share of the limit ``atol + rtol * |ref|``
(``chip_smoke.LOGITS_TOL``) that an element used, and whether the folded
logits equal the unfolded kernels' bit for bit.

Run from the repo root on a machine with a CUDA card:
  python3 scripts/torch/logits_margin_384.py [--seeds 0 1 2 3]
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
from ssl4polyp_tpu_torch.models.factory import get_imagenet_or_random_vit  # noqa: E402
from ssl4polyp_tpu_torch.models.vit import ViTConfig  # noqa: E402
from ssl4polyp_tpu_torch.profiling import projection_fold  # noqa: E402
from ssl4polyp_tpu_torch.training.classification import make_forward_fn  # noqa: E402


def margin(got: list[np.ndarray], ref: list[np.ndarray]) -> dict:
    """The worst |diff|, max |ref| and worst share of LOGITS_TOL's limit."""
    got, ref = torch.from_numpy(np.concatenate(got)), torch.from_numpy(np.concatenate(ref))
    return {"max_abs_diff": (got - ref).abs().max().item(),
            "max_abs_logit": ref.abs().max().item(),
            "limit_share": cs.limit_share(got, ref, cs.LOGITS_TOL)}


def one_seed(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    base = ViTConfig(pos_embed="learned", num_classes=2, img_size=cs.LONG_IMAGE)
    tree = cs.jax_layout_tree(base, rng)
    requests = [rng.integers(0, 256, (cs.BATCH, cs.LONG_IMAGE, cs.LONG_IMAGE, 3),
                             dtype=np.uint8) for _ in range(2)]
    result: dict = {"seed": seed}
    logits = {}
    for fold in (False, True):
        with projection_fold(fold):
            clf = get_imagenet_or_random_vit(
                torch.Generator().manual_seed(seed), jax_params=tree, num_classes=2,
                device="cuda", img_size=cs.LONG_IMAGE)
        forward = make_forward_fn(clf, "cuda")()
        logits[fold] = [forward(images) for images in requests]
        with cs.plain_kernels():
            plain = [forward(images) for images in requests]
        result["fold" if fold else "unfolded"] = margin(logits[fold], plain)
        del clf, forward
        torch.cuda.empty_cache()
    result["fold_equals_unfolded"] = all(
        np.array_equal(a, b) for a, b in zip(logits[True], logits[False]))
    return result


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("logits_margin_384.py: no CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(f"limit atol {cs.LOGITS_TOL[0]} + rtol {cs.LOGITS_TOL[1]} * |ref|; batch {cs.BATCH}, "
          f"2 requests a seed, {cs.LONG_IMAGE} px")
    for seed in args.seeds:
        print(json.dumps(one_seed(seed)), flush=True)


if __name__ == "__main__":
    main()
