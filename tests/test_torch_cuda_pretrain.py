"""The pretraining engine on the card: ``run_pretraining`` at full width.

Needs an NVIDIA GPU, nvcc and PIL; without a GPU it skips.  Run it on the
card with ``python -m pytest --noconftest tests/test_torch_cuda_pretrain.py
-q``.  MAE ViT-B/16 in bf16 at batch 64 reads 130 JPEG frames (two steps an
epoch, the short batch dropped) through the port's loader: two epochs with
the last one's checkpoint (fp32 masters and both moments, in the JAX
package's layout), then a child process that a real SIGTERM stops after its
first step, saving, and an auto-resume that completes the run.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from ssl4polyp_tpu_torch import ops
from ssl4polyp_tpu_torch.training import pretrain
from ssl4polyp_tpu_torch.utils.checkpoint import load_checkpoint

pytestmark = pytest.mark.cuda

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from PIL import Image

    root = tmp_path_factory.mktemp("frames")
    folder = root / "train" / "unlabelled"
    folder.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(130):
        pixels = rng.integers(0, 256, (240 + i % 3 * 16, 300, 3), dtype=np.uint8)
        Image.fromarray(pixels).save(folder / f"{i:03d}.jpg", quality=90)
    return root


def _settings(frames, out, **overrides):
    return pretrain.PretrainSettings(
        data_root=str(frames), output_dir=str(out), warmup_epochs=1, num_workers=8,
        log_interval=1, **overrides)


def test_run_pretraining_on_the_card(frames, tmp_path):
    settings = _settings(frames, tmp_path / "out", epochs=2)
    ops.reset_launch_counts()
    record = pretrain.run_pretraining(settings)
    lines = (tmp_path / "out" / "pretrain.jsonl").read_text().splitlines()
    assert [json.loads(line)["epoch"] for line in lines] == [0, 1]
    assert record == json.loads(lines[-1]) and np.isfinite(record["train_loss"])
    # Four steps, each through every kernel of the step (20 blocks).
    assert ops.launch_counts()["fused_qkv_attention_backward"] == 4 * 20
    # The last epoch's save at full width, behind the pointer.
    ckpts = tmp_path / "out" / "ckpts"
    assert sorted(p.name for p in ckpts.glob("checkpoint-*.ckpt")) == ["checkpoint-1.ckpt"]
    restored = load_checkpoint(ckpts / "last.ckpt")
    payload = restored["payload"]
    assert restored["meta"]["epoch"] == 1 and int(payload["opt"]["step"]) == 4
    assert payload["params"]["blocks"]["attn"]["qkv"]["kernel"].shape == (12, 768, 2304)
    assert payload["opt"]["nu"]["decoder"]["pred"]["kernel"].dtype == np.float32
    assert np.isfinite(payload["params"]["decoder"]["pred"]["kernel"]).all()


_CHILD = """
import json, sys
from ssl4polyp_tpu_torch.training import pretrain
from ssl4polyp_tpu_torch.utils.logging import RunLogger

scalar = RunLogger.scalar
def stepped(self, tag, value, step):
    scalar(self, tag, value, step)
    if tag == "train/loss":
        print("STEPPED", step, flush=True)
RunLogger.scalar = stepped
summary = pretrain.cli_main(sys.argv[1:])
print("SUMMARY " + json.dumps(summary), flush=True)
"""


def test_sigterm_saves_and_auto_resume_completes_on_the_card(frames, tmp_path):
    out = tmp_path / "out"
    argv = ["--data-root", str(frames), "--output-dir", str(out), "--epochs", "3",
            "--warmup-epochs", "1", "--num-workers", "8", "--log-interval", "1",
            "--save-freq-epochs", "1000"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.Popen([sys.executable, "-c", _CHILD, *argv], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    lines, deadline = [], time.time() + 120
    try:
        while time.time() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("STEPPED"):
                proc.send_signal(signal.SIGTERM)
                break
        rest, _ = proc.communicate(timeout=120)
    finally:
        proc.kill()
    output = "".join(lines) + rest
    assert proc.returncode == 0, output
    summary = json.loads([l for l in output.splitlines() if l.startswith("SUMMARY ")][-1][8:])
    # The signal lands within a step or two of the first one.
    assert summary["interrupted"] is True and summary["epoch"] in (0, 1), output
    epoch = summary["epoch"]
    saved = load_checkpoint(out / "ckpts" / "last.ckpt")
    steps_saved = int(saved["payload"]["opt"]["step"])
    assert saved["meta"]["epoch"] == epoch and 1 <= steps_saved <= 2 * (epoch + 1)
    assert "Signal received" in (out / "pretrain.log").read_text()

    # Auto-resume in this process: the epochs after the interrupted one,
    # two steps each.
    resumed = pretrain.run_pretraining(_settings(frames, out, epochs=3, resume="auto",
                                                 save_freq_epochs=1000))
    assert resumed["epoch"] == 2 and np.isfinite(resumed["train_loss"])
    final = load_checkpoint(out / "ckpts" / "last.ckpt")
    assert final["meta"]["epoch"] == 2
    assert int(final["payload"]["opt"]["step"]) == steps_saved + 2 * (2 - epoch)
    lines = (out / "pretrain.jsonl").read_text().splitlines()
    assert [json.loads(line)["epoch"] for line in lines] == [*range(epoch), *range(epoch + 1, 3)]
