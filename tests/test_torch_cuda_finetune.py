"""The fine-tune engine on the card: ``build_run`` and
``run_classification_training`` through the kernels.

Needs an NVIDIA GPU and nvcc; without a GPU it skips.  Run it on the card with
``python -m pytest --noconftest tests/test_torch_cuda_finetune.py -q``.  A
ViT-B-wide, two-block classifier in bf16 at 64 px (17 tokens) on a synthetic
pack of 64-px JPEG frames: two epochs with their checkpoints (fp32 masters
and both moments, in the JAX package's layout), then ``--resume`` with a
third epoch, from the best checkpoint's bits.
"""

import json

import numpy as np
import pytest
import torch

from ssl4polyp_tpu_torch import ops
from ssl4polyp_tpu_torch.models.weights import state_dict_from_jax
from ssl4polyp_tpu_torch.ops import adamw
from ssl4polyp_tpu_torch.polypdb.synth import build_synthetic_pack
from ssl4polyp_tpu_torch.training import classification
from ssl4polyp_tpu_torch.training import protocol as proto
from ssl4polyp_tpu_torch.utils.checkpoint import load_checkpoint

pytestmark = pytest.mark.cuda

MODEL = {"embed_dim": 768, "depth": 2, "num_heads": 12, "patch_size": 16}


def _cfg(epochs):
    return {
        "lr": 1e-4, "weight_decay": 0.05, "batch_size": 8, "epochs": epochs, "seeds": [13],
        "image_size": 64, "num_workers": 4, "log_interval": 1,
        "scheduler": {"name": "cosine", "warmup_epochs": 1},
        "early_stop": {"monitor": "val_loss", "patience": 8},
        "dataset": {"name": "sun_full", "pack": "sun_full",
                    "splits": {"train": "train", "val": "val", "test": "test"}},
        "models": [{"model": {"key": "ssl_colon", "arch": "vit_b", "ss_framework": "mae"}}],
        "protocol": {"finetune": "full",
                     "thresholds": {"primary": "f1_opt_on_val", "sensitivity": "youden_on_val"}},
        "threshold_policy": "f1_opt_on_val",
    }


@pytest.fixture(scope="module")
def packs(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root = tmp_path_factory.mktemp("packs") / "data_packs"
    build_synthetic_pack(root, name="sun_full", frames_per_split=32, image_size=64)
    return root


def _run(packs, out, epochs, resume=False):
    plan = proto.resolve_run_plan(_cfg(epochs), model_key="ssl_colon", seed=13)
    ctx = classification.build_run(plan, output_dir=out, pack_root=packs, model_overrides=MODEL)
    return ctx, classification.run_classification_training(
        ctx, thresholds_root=out / "thresholds", resume=resume)


def test_finetune_engine_runs_saves_and_resumes_on_the_card(packs, tmp_path, monkeypatch):
    ops.reset_launch_counts()
    ctx, first = _run(packs, tmp_path / "out", 2)
    counts = ops.launch_counts()
    assert ctx.device.type == "cuda" and ctx.classifier.cfg.compute_dtype == torch.bfloat16
    assert first["epochs_run"] == 2 and np.isfinite(first["payload"]["train_loss"])
    steps = 2 * 4  # 32 frames in batches of 8, two epochs
    evals = 2 * 4 + 4  # validation after each epoch, then the test split
    n_tensors = len(ctx.params)  # 32: 12 a block, 8 outside them
    assert counts["adamw"] == steps * -(-n_tensors // adamw.TENSORS_PER_LAUNCH)
    assert counts["fused_qkv_attention_backward"] == steps * 2
    assert counts["fused_qkv_attention"] == (steps + evals) * 2
    assert counts["layernorm"] == (steps + evals) * 5
    run_dir, stem = ctx.layout.output_dir, ctx.layout.stem
    best = load_checkpoint(ctx.layout.checkpoint_path)
    assert best["meta"]["model_cfg"]["pad_tokens_to"] == 24
    assert best["meta"]["thresholds"]["primary"]["tau"] == first["tau"]
    payload = json.loads((run_dir / f"{stem}.metrics.json").read_text())
    assert {"val", "test_primary", "test_sensitivity"} <= set(payload)

    seen = {}
    build = classification.make_train_step

    def recording_make_step(step_ctx):
        step = build(step_ctx)

        def wrapped(state, *args):
            if not seen:
                seen.update(params={n: t.cpu() for n, t in state.params.items()},
                            mu={n: t.cpu() for n, t in state.opt.mu.items()},
                            step=state.opt.step)
            return step(state, *args)
        return wrapped

    monkeypatch.setattr(classification, "make_train_step", recording_make_step)
    resumed_ctx, resumed = _run(packs, tmp_path / "out", 3, resume=True)
    start = best["meta"]["epoch"] + 1
    assert f"resumed from {stem}.ckpt at epoch {start}" in (run_dir / f"{stem}.log").read_text()
    assert resumed["epochs_run"] == 3
    want = state_dict_from_jax(best["payload"]["params"], resumed_ctx.classifier.cfg)
    assert all(torch.equal(seen["params"][n], t) for n, t in want.items())
    want_mu = state_dict_from_jax(best["payload"]["opt"]["mu"], resumed_ctx.classifier.cfg)
    assert all(torch.equal(seen["mu"][n], t) for n, t in want_mu.items())
    assert seen["step"] == int(best["payload"]["opt"]["step"])
    last = load_checkpoint(run_dir / f"{stem}_last.ckpt")
    assert last["meta"]["epoch"] == 2
    assert all(np.isfinite(np.asarray(leaf)).all() for leaf in
               last["payload"]["params"]["blocks"]["mlp"]["fc1"].values())
