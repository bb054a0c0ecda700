"""The pretrain epoch loop on the card: ``run_pretraining`` at full width.

Needs an NVIDIA GPU, nvcc and PIL; without a GPU it skips.  Run it on the
card with ``python -m pytest --noconftest tests/test_torch_cuda_pretrain.py
-q``.  MAE ViT-B/16 in bf16 at batch 64 reads 130 JPEG frames (two steps an
epoch, the short batch dropped) for two epochs through the port's loader.
"""

import json

import numpy as np
import pytest
import torch

from ssl4polyp_tpu_torch import ops
from ssl4polyp_tpu_torch.training import pretrain

pytestmark = pytest.mark.cuda


def test_run_pretraining_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from PIL import Image

    frames = tmp_path / "frames" / "train" / "unlabelled"
    frames.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(130):
        pixels = rng.integers(0, 256, (240 + i % 3 * 16, 300, 3), dtype=np.uint8)
        Image.fromarray(pixels).save(frames / f"{i:03d}.jpg", quality=90)
    settings = pretrain.PretrainSettings(
        data_root=str(tmp_path / "frames"), output_dir=str(tmp_path / "out"), epochs=2,
        warmup_epochs=1, num_workers=8, log_interval=1,
    )
    ops.reset_launch_counts()
    record = pretrain.run_pretraining(settings)
    lines = (tmp_path / "out" / "pretrain_log.jsonl").read_text().splitlines()
    assert [json.loads(line)["epoch"] for line in lines] == [0, 1]
    assert record == json.loads(lines[-1]) and np.isfinite(record["train_loss"])
    # Four steps, each through every kernel of the step (20 blocks).
    assert ops.launch_counts()["fused_qkv_attention_backward"] == 4 * 20
