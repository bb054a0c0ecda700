"""The port's eval forward and split evaluation against the JAX ones.

The same fp32 weights on both sides; the JAX forward runs over the virtual
8-device CPU mesh, the port's on the CPU.  The port's split evaluation is
its own numpy code: nothing of the JAX package is imported by it.
"""

import warnings
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.data import HostDataLoader, create_classification_datasets
from ssl4polyp_tpu.evaluation.evaluate import evaluate_split as jax_evaluate_split
from ssl4polyp_tpu.models.factory import get_imagenet_or_random_vit as jax_vit_factory
from ssl4polyp_tpu.parallel.mesh import build_mesh
from ssl4polyp_tpu.training.classification import make_forward_fn as jax_make_forward_fn
from ssl4polyp_tpu_torch.evaluation.evaluate import evaluate_split
from ssl4polyp_tpu_torch.models.factory import get_imagenet_or_random_vit
from ssl4polyp_tpu_torch.training.classification import make_forward_fn

TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)
# fp32 logits through two blocks: only summation order and fusion differ.
# The metrics are functions of those logits; with 8 distinct scores no
# ranking or threshold decision moves, so they agree to the same tolerance.
TOL = 1e-4


def _assert_close(ours, ref, path="results", tol=TOL):
    if isinstance(ref, dict):
        assert sorted(ours) == sorted(ref), path
        for key in ref:
            _assert_close(ours[key], ref[key], f"{path}.{key}", tol)
    elif isinstance(ref, np.ndarray) and ref.dtype.kind == "f":
        np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol, err_msg=path)
    elif isinstance(ref, float):
        np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol, err_msg=path)
    elif isinstance(ref, np.ndarray):
        np.testing.assert_array_equal(ours, ref, err_msg=path)
    else:
        assert ours == ref, path


def test_forward_and_metrics_match_jax(image_pack):
    jax_classifier = jax_vit_factory(jax.random.PRNGKey(0), None, num_classes=2,
                                     compute_dtype=jnp.float32, **TINY)
    params = jax.tree_util.tree_map(np.asarray, jax_classifier.params)
    classifier = get_imagenet_or_random_vit(
        torch.Generator().manual_seed(0), jax_params=params, num_classes=2,
        device="cpu", compute_dtype=torch.float32, **TINY,
    )
    index = create_classification_datasets(test_spec=image_pack, image_size=32)["test"]
    loader = HostDataLoader(index, batch_size=5, num_workers=1)
    jax_forward = jax_make_forward_fn(jax_classifier, build_mesh())(jax_classifier.params)
    forward = make_forward_fn(classifier, "cpu")()

    batch = next(iter(loader))["image"]
    np.testing.assert_allclose(forward(batch), jax_forward(batch), rtol=TOL, atol=TOL)
    # The binder given the parameters by name is the same function.
    named = dict(classifier.model.named_parameters())
    np.testing.assert_array_equal(make_forward_fn(classifier, "cpu")(named)(batch), forward(batch))

    kwargs = dict(split_name="test", morphology_eval=("polypoid", "flat"),
                  perturbation_eval=True, pos_weight=1.5)
    ours = evaluate_split(forward, loader, index, **kwargs)
    ref = jax_evaluate_split(jax_forward, loader, index, **kwargs)
    assert len(ref["logits"]) == len(index) == 8
    _assert_close(ours, ref)


def _metadata_rows(n, rng):
    """Rows whose morphology, perturbation fields and cases vary
    independently of the label, placeholders included."""
    rows = []
    for i in range(n):
        kind = i % 4
        rows.append({
            "case_id": f"case_{rng.integers(0, 3)}" if i % 7 else "",
            "morphology": ["Polypoid", "flat ", "unknown"][int(rng.integers(0, 3))],
            "perturbation_id": "-1" if kind else "",
            "blur_sigma": "1.5" if kind == 1 else "-1.0",
            "jpeg_q": "30" if kind == 2 else "-1",
            "brightness": "0.7" if kind == 2 else "-1.0",
            "contrast": "-1.0",
            "bbox_area_frac": -1.0,
            "variant": "occ_a0p2" if kind == 3 else "",
        })
    return rows


@pytest.mark.parametrize("num_classes", [2, 3])
def test_breakdowns_match_jax_on_the_same_logits(num_classes):
    # The same logits through both metric halves, in three batches with an
    # invalid padded tail: every key, and every metric to 1e-9 (the port
    # computes what the JAX package asks scikit-learn for).  Tied logits,
    # single-class strata and cases, composed and raw perturbation tags.
    rng = np.random.default_rng(3)
    n = 48
    logits = (rng.integers(-4, 5, (n, num_classes)) / 2.0).astype(np.float32)
    labels = rng.integers(0, num_classes, n)
    labels[:num_classes] = np.arange(num_classes)
    valid = np.ones(n, bool)
    valid[-3:] = False
    index = SimpleNamespace(meta=_metadata_rows(n - 3, rng))
    batches = [{"image": logits[lo:lo + 16], "label": labels[lo:lo + 16],
                "index": np.arange(lo, lo + 16), "valid": valid[lo:lo + 16]}
               for lo in range(0, n, 16)]
    kwargs = dict(split_name="test", num_classes=num_classes, tau=0.4,
                  loss_mode="binary_bce" if num_classes == 2 else "multiclass_ce",
                  pos_weight=2.0, class_weights=None if num_classes == 2 else [0.5, 1.0, 2.0],
                  morphology_eval=("polypoid", "flat", "sessile") if num_classes == 2 else None,
                  perturbation_eval=num_classes == 2)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ours = evaluate_split(lambda x: x, batches, index, **kwargs)
        ref = jax_evaluate_split(lambda x: x, batches, index, **kwargs)
    if num_classes == 2:
        assert set(ref["morphology_metrics"]) == {"polypoid", "flat"}  # no "sessile" row
        assert "ALL-perturbed" in ref["perturbation_metrics"]
        assert "blur_sigma=1.5" in ref["perturbation_case_metrics"]
    assert len(ref["logits"]) == n - 3
    _assert_close(ours, ref, tol=1e-9)
    assert list(ours) == list(ref)


_RANK_SCRIPT = """
import json, sys
from types import SimpleNamespace
import numpy as np
import torch.distributed as dist
from ssl4polyp_tpu_torch.evaluation.evaluate import evaluate_split

rank = int(sys.argv[1])
dist.init_process_group("gloo", init_method=sys.argv[2], world_size=2, rank=rank)
logits = np.array([[0.0, rank + 1.0], [0.0, -rank - 1.0]], np.float32)
batch = {"image": np.zeros((2, 4, 4, 3), np.uint8), "label": np.array([1, 0]),
         "index": np.array([2 * rank, 2 * rank + 1]), "valid": np.array([True, True])}
out = evaluate_split(lambda images: logits, [batch], SimpleNamespace(meta=[{}] * 4),
                     split_name="test")
dist.destroy_process_group()
print(json.dumps({"logits": out["logits"].tolist(), "positions": out["positions"].tolist()}))
"""


def test_ranks_gather_their_stripes():
    # Two ranks on gloo each evaluate a stripe; both see the whole split.
    import json
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    root = Path(__file__).resolve().parents[1]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(root)}
    ranks = [
        subprocess.Popen([sys.executable, "-c", _RANK_SCRIPT, str(rank), f"tcp://localhost:{port}"],
                         cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for rank in range(2)
    ]
    outputs = [rank.communicate(timeout=180) for rank in ranks]
    for rank, (out, err) in zip(ranks, outputs):
        assert rank.returncode == 0, err
    for out, _ in outputs:
        result = json.loads(out.strip().splitlines()[-1])
        assert result == {"logits": [[0, 1], [0, -1], [0, 2], [0, -2]], "positions": [0, 1, 2, 3]}
