"""The port's pretraining engine against the JAX engine, on the CPU.

A tiny MAE (the sizes of ``tests/test_torch_pretrain.py``) in fp32 on
``device="cpu"`` reads JPEG frames written here: 24 frames at batch 8 are
three steps an epoch.  Checkpoints cross between the packages both ways
(the port's file resumed by the JAX engine and loaded by the JAX factory, the
JAX engine's file restored into the port's state), a signalled and resumed
run equals the uninterrupted one bit for bit, ``steps_per_call`` 2 equals 1,
retention, asynchronous writes, a kill between the ``.tmp`` write and the
rename, a real SIGTERM to a child process, the ``finally`` that survives a
failing join, the flag surface, the Hyperkvasir wrapper, the SSL-colon
classifier built from a ``.ckpt`` and the leaf modules (the TensorBoard
event writer, ``RunLogger``'s fallbacks, the determinism helpers).
"""

import json
import os
import random
import re
import signal
import subprocess
import sys
import time
from dataclasses import asdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.models import mae as jax_mae
from ssl4polyp_tpu.models import vit as jax_vit
from ssl4polyp_tpu.models.factory import get_mae_backbone as jax_get_mae_backbone
from ssl4polyp_tpu.training import hyperkvasir as jax_hyperkvasir
from ssl4polyp_tpu.training import pretrain as jax_pretrain
from ssl4polyp_tpu.utils import checkpoint as jax_checkpoint
from ssl4polyp_tpu.utils import determinism as jax_determinism
from ssl4polyp_tpu.utils import logging as jax_logging
from ssl4polyp_tpu.utils import tb_events as jax_tb_events
from ssl4polyp_tpu_torch.models.factory import build_classifier
from ssl4polyp_tpu_torch.models.layers import compute_copy
from ssl4polyp_tpu_torch.models.mae import MAE, MAEConfig, encoder_only
from ssl4polyp_tpu_torch.models.vit import ViTConfig
from ssl4polyp_tpu_torch.models.weights import (
    jax_from_mae_state_dict,
    mae_state_dict_from_jax,
    state_dict_from_jax,
)
from ssl4polyp_tpu_torch.training import hyperkvasir, pretrain
from ssl4polyp_tpu_torch.utils import checkpoint, cli, determinism, tb_events
from ssl4polyp_tpu_torch.utils import logging as run_logging

ROOT = Path(__file__).resolve().parents[1]
# The tiny MAE of tests/test_torch_pretrain.py (and of the JAX engine's own
# tests, tests/test_pretrain.py::patch_tiny_model).
ENCODER = dict(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2)
DECODER = dict(decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2)
FRAMES, BATCH = 24, 8
STEPS_PER_EPOCH = FRAMES // BATCH
TINY = MAEConfig(encoder=ViTConfig(compute_dtype=torch.float32, **ENCODER), **DECODER)
JAX_TINY = jax_mae.MAEConfig(encoder=jax_vit.ViTConfig(compute_dtype=jnp.float32, **ENCODER),
                             **DECODER)
# The child processes' model patch, and TensorBoard's import (seconds of
# TensorFlow) replaced by the scalar event writer RunLogger falls back to.
CHILD_PRELUDE = f"""
import json, sys
sys.modules["torch.utils.tensorboard"] = None
import torch
from ssl4polyp_tpu_torch.models.mae import MAEConfig
from ssl4polyp_tpu_torch.models.vit import ViTConfig
from ssl4polyp_tpu_torch.training import pretrain
from ssl4polyp_tpu_torch.utils import checkpoint
from ssl4polyp_tpu_torch.utils.logging import RunLogger

TINY = MAEConfig(encoder=ViTConfig(compute_dtype=torch.float32, **{ENCODER!r}), **{DECODER!r})
pretrain.model_config = lambda settings: TINY
"""


@pytest.fixture(autouse=True)
def tiny_models(monkeypatch):
    monkeypatch.setattr(pretrain, "model_config", lambda settings: TINY)
    monkeypatch.setattr(jax_pretrain, "model_config", lambda settings: JAX_TINY)
    # Both loggers try torch.utils.tensorboard first, whose import costs
    # seconds of TensorFlow here; the scalar event writer stands in.
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(0)
    for i in range(FRAMES):
        array = rng.integers(0, 255, (48, 48, 3), dtype=np.uint8)
        Image.fromarray(array).save(root / f"frame_{i:03d}.jpg", quality=90)
    return root


COMMON = dict(epochs=2, warmup_epochs=1, batch_size=BATCH, accum_iter=1, image_size=32,
              num_workers=2, log_interval=1, save_freq_epochs=1, keep_last=3,
              keep_every_n_epochs=None, no_train_dir=True, precision="fp32", seed=5)


def port_settings(frames, out, **overrides):
    return pretrain.PretrainSettings(data_root=str(frames), output_dir=str(out),
                                     **{**COMMON, "device": "cpu", **overrides})


def jax_settings(frames, out, **overrides):
    return jax_pretrain.PretrainSettings(data_root=str(frames), output_dir=str(out),
                                         **{**COMMON, **overrides})


def epochs_logged(out) -> list:
    return [json.loads(line)["epoch"] for line in (Path(out) / "pretrain.jsonl").read_text().splitlines()]


def leaves(tree, prefix=""):
    """{path: numpy array} of a nested payload."""
    if isinstance(tree, dict):
        return {k: v for key in tree for k, v in leaves(tree[key], f"{prefix}/{key}").items()}
    return {prefix: np.asarray(tree)}


def assert_bit_equal(a, b):
    a, b = leaves(a), leaves(b)
    assert sorted(a) == sorted(b)
    for name in a:
        assert a[name].dtype == b[name].dtype and a[name].shape == b[name].shape, name
        assert a[name].tobytes() == b[name].tobytes(), name


def capture_states(monkeypatch) -> list:
    """The port engine's PretrainStates, in the order its runs make them."""
    states, init = [], pretrain.init_pretrain_state
    monkeypatch.setattr(pretrain, "init_pretrain_state",
                        lambda model: states.append(init(model)) or states[-1])
    return states


def test_port_checkpoint_is_resumed_by_the_jax_engine_and_loaded_by_its_factory(
        frames, tmp_path, monkeypatch):
    states = capture_states(monkeypatch)
    pretrain.run_pretraining(port_settings(frames, tmp_path, epochs=1))
    masters = jax_from_mae_state_dict(states[0].params, TINY)

    # The JAX reader sees the JAX engine's own tree, and the port's masters.
    written = jax_checkpoint.load_checkpoint(tmp_path / "ckpts" / "checkpoint-0.ckpt")
    payload = written["payload"]
    reference = jax_mae.init_mae(jax.random.PRNGKey(0), JAX_TINY)
    assert jax.tree_util.tree_structure(payload["params"]) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(np.asarray, reference))
    assert_bit_equal(payload["params"], masters)
    assert_bit_equal(payload["opt"]["mu"], jax_from_mae_state_dict(states[0].opt.mu, TINY))
    assert payload["opt"]["step"].dtype == np.int32 and int(payload["opt"]["step"]) == 3
    assert written["meta"]["epoch"] == 0 and written["meta"]["model"] == "mae_vit_base_patch16"

    # The JAX engine resumes it: epoch 1, three more optimizer steps.
    summary = jax_pretrain.run_pretraining(jax_settings(frames, tmp_path, resume="auto"))
    assert summary["epoch"] == 1 and np.isfinite(summary["train_loss"])
    assert epochs_logged(tmp_path) == [0, 1]
    after = jax_checkpoint.load_checkpoint(tmp_path / "ckpts" / "checkpoint-1.ckpt")
    assert int(after["payload"]["opt"]["step"]) == 2 * STEPS_PER_EPOCH

    # The JAX factory builds its MAE-lineage classifier from the port's file.
    classifier = jax_get_mae_backbone(jax.random.PRNGKey(1),
                                      weight_path=tmp_path / "ckpts" / "checkpoint-0.ckpt",
                                      pos_embed="sincos", **ENCODER)
    encoder = {k: v for k, v in classifier.params.items() if k != "head"}
    assert_bit_equal(jax.tree_util.tree_map(np.asarray, encoder), encoder_only(masters))


def test_jax_checkpoint_is_restored_into_the_port(frames, tmp_path):
    jax_pretrain.run_pretraining(jax_settings(frames, tmp_path, epochs=1))
    path = tmp_path / "ckpts" / "checkpoint-0.ckpt"
    tree = jax_checkpoint.load_checkpoint(path)["payload"]

    state = pretrain.init_pretrain_state(MAE(TINY, torch.Generator().manual_seed(3)))
    pretrain.restore_state(state, checkpoint.load_checkpoint(path)["payload"])
    # The restored state is the JAX tree, in either direction of the map.
    for ours, theirs in ((state.params, tree["params"]), (state.opt.mu, tree["opt"]["mu"]),
                         (state.opt.nu, tree["opt"]["nu"])):
        want = mae_state_dict_from_jax(theirs, TINY)
        assert sorted(ours) == sorted(want)
        assert all(torch.equal(ours[name], want[name]) for name in want)
        assert_bit_equal(jax_from_mae_state_dict(ours, TINY),
                         jax.tree_util.tree_map(np.asarray, theirs))
    assert state.opt.step == int(tree["opt"]["step"]) == STEPS_PER_EPOCH

    # The port's engine resumes the JAX file and goes on.
    summary = pretrain.run_pretraining(port_settings(frames, tmp_path, resume=str(path)))
    assert summary["epoch"] == 1 and np.isfinite(summary["train_loss"])
    assert epochs_logged(tmp_path) == [0, 1]
    resumed = checkpoint.load_checkpoint(tmp_path / "ckpts" / "checkpoint-1.ckpt")
    assert int(resumed["payload"]["opt"]["step"]) == 2 * STEPS_PER_EPOCH


def test_restore_writes_into_the_live_tensors_and_refreshes_the_compute_copy():
    # bf16 compute: the compute copy is a tensor of its own for each matrix.
    cfg = MAEConfig(encoder=ViTConfig(compute_dtype=torch.bfloat16, **ENCODER), **DECODER)
    source = pretrain.init_pretrain_state(MAE(cfg, torch.Generator().manual_seed(1)))
    for name, p in source.params.items():  # moments and a step of their own
        source.opt.mu[name].copy_(p * 0.5)
        source.opt.nu[name].copy_(p.square())
    source.opt.step = 7
    state = pretrain.init_pretrain_state(MAE(cfg, torch.Generator().manual_seed(2)))
    addresses = {what: {n: t.data_ptr() for n, t in tensors.items()} for what, tensors in (
        ("params", state.params), ("params_c", state.params_c), ("mu", state.opt.mu),
        ("nu", state.opt.nu))}
    own = dict(state.model.named_parameters())
    pretrain.restore_state(state, pretrain.checkpoint_payload(source))
    for what, tensors in (("params", state.params), ("params_c", state.params_c),
                          ("mu", state.opt.mu), ("nu", state.opt.nu)):
        assert {n: t.data_ptr() for n, t in tensors.items()} == addresses[what]
    assert all(own[n].data_ptr() == p.data_ptr() for n, p in state.params.items())
    for mine, theirs in ((state.params, source.params), (state.opt.mu, source.opt.mu),
                         (state.opt.nu, source.opt.nu)):
        assert all(torch.equal(mine[n], theirs[n]) for n in theirs)
    recast = compute_copy(state.params, torch.bfloat16)
    assert all(torch.equal(state.params_c[n], recast[n]) for n in recast)
    assert state.opt.step == 7
    wrong = pretrain.checkpoint_payload(source)
    del wrong["params"]["decoder"]
    with pytest.raises(KeyError):
        pretrain.restore_state(state, wrong)


@pytest.mark.parametrize("signal_step, resumed_steps", [
    (2 * STEPS_PER_EPOCH, 2 * STEPS_PER_EPOCH + STEPS_PER_EPOCH),  # epoch 1's last step
    (STEPS_PER_EPOCH + 2, STEPS_PER_EPOCH + 2 + STEPS_PER_EPOCH),  # mid-epoch: its rest dropped
])
def test_signalled_and_resumed_run(frames, tmp_path, monkeypatch, signal_step, resumed_steps):
    # Run A goes through three epochs; run B gets SIGTERM at the step named,
    # saves checkpoint-1 and returns, then resumes at epoch 2 (epoch + 1, as
    # the JAX engine does).  Signalled in an epoch's last step, B ends bit
    # for bit where A ends.
    settings = dict(epochs=3, save_freq_epochs=1000)
    pretrain.run_pretraining(port_settings(frames, tmp_path / "A", **settings))

    scalar = run_logging.RunLogger.scalar

    def scalar_then_signal(self, tag, value, step):
        scalar(self, tag, value, step)
        if tag == "train/loss" and step == signal_step:
            assert callable(signal.getsignal(signal.SIGTERM)), "the engine installed no handler"
            os.kill(os.getpid(), signal.SIGTERM)

    monkeypatch.setattr(run_logging.RunLogger, "scalar", scalar_then_signal)
    summary = pretrain.run_pretraining(port_settings(frames, tmp_path / "B", **settings))
    monkeypatch.setattr(run_logging.RunLogger, "scalar", scalar)
    assert summary == {"interrupted": True, "epoch": 1}
    saved = checkpoint.load_checkpoint(tmp_path / "B" / "ckpts" / "last.ckpt")
    assert saved["meta"]["epoch"] == 1 and int(saved["payload"]["opt"]["step"]) == signal_step
    assert "Signal received" in (tmp_path / "B" / "pretrain.log").read_text()

    resumed = pretrain.run_pretraining(port_settings(frames, tmp_path / "B", resume="auto",
                                                     **settings))
    assert resumed["epoch"] == 2 and np.isfinite(resumed["train_loss"])
    assert "at epoch 2" in (tmp_path / "B" / "pretrain.log").read_text()
    assert epochs_logged(tmp_path / "A") == [0, 1, 2] and epochs_logged(tmp_path / "B") == [0, 2]
    a = checkpoint.load_checkpoint(tmp_path / "A" / "ckpts" / "checkpoint-2.ckpt")["payload"]
    b = checkpoint.load_checkpoint(tmp_path / "B" / "ckpts" / "checkpoint-2.ckpt")["payload"]
    assert int(b["opt"]["step"]) == resumed_steps
    if signal_step == 2 * STEPS_PER_EPOCH:
        assert_bit_equal(a, b)
    else:
        assert a["params"]["norm"]["scale"].tobytes() != b["params"]["norm"]["scale"].tobytes()


def test_steps_per_call_two_equals_one_bit_for_bit(frames, tmp_path):
    # Three steps an epoch: one round of two calls, then the tail's one.
    for k in (1, 2):
        summary = pretrain.run_pretraining(port_settings(frames, tmp_path / f"k{k}",
                                                         steps_per_call=k))
        assert summary["epoch"] == 1 and np.isfinite(summary["train_loss"])
    for epoch in (0, 1):
        one, two = (checkpoint.load_checkpoint(tmp_path / f"k{k}" / "ckpts" /
                                               f"checkpoint-{epoch}.ckpt")["payload"]
                    for k in (1, 2))
        assert_bit_equal(one, two)
    assert int(two["opt"]["step"]) == 2 * STEPS_PER_EPOCH


def test_limit_steps_per_epoch_cuts_the_epoch_and_the_schedule(frames, tmp_path):
    pretrain.run_pretraining(port_settings(frames, tmp_path, limit_steps_per_epoch=2))
    restored = checkpoint.load_checkpoint(tmp_path / "ckpts" / "last.ckpt")
    assert int(restored["payload"]["opt"]["step"]) == 4 and restored["meta"]["epoch"] == 1
    # The cosine reached its end at the last step of the cut run.
    assert json.loads((tmp_path / "pretrain.jsonl").read_text().splitlines()[-1])["lr"] == 0.0


@pytest.mark.parametrize("epochs, keep_last, keep_every, kept", [
    (2, 3, None, [0, 1]),     # tests/test_pretrain.py::test_pretrain_smoke
    (4, 2, 2, [1, 2, 3]),     # last 2, and milestones where 2 epochs completed
    (5, 1, 4, [3, 4]),        # tests/test_checkpoint.py::test_retention's rule
])
def test_retention(frames, tmp_path, epochs, keep_last, keep_every, kept):
    summary = pretrain.run_pretraining(port_settings(
        frames, tmp_path, epochs=epochs, keep_last=keep_last, keep_every_n_epochs=keep_every,
        limit_steps_per_epoch=1))
    assert summary["epoch"] == epochs - 1 and np.isfinite(summary["train_loss"])
    ckpts = tmp_path / "ckpts"
    assert sorted(int(p.stem.split("-")[1]) for p in ckpts.glob("checkpoint-*.ckpt")) == kept
    assert sorted(p.name for p in ckpts.glob("*.json")) == [
        f"checkpoint-{e}.ckpt.json" for e in kept]
    assert os.path.realpath(ckpts / "last.ckpt") == os.path.realpath(
        ckpts / f"checkpoint-{epochs - 1}.ckpt")
    assert epochs_logged(tmp_path) == list(range(epochs))


def test_async_and_sync_checkpoints_write_the_same_documents(frames, tmp_path):
    for mode in (True, False):
        pretrain.run_pretraining(port_settings(frames, tmp_path / str(mode), epochs=1,
                                               async_checkpoint=mode))
    a, b = (checkpoint.load_checkpoint(tmp_path / str(mode) / "ckpts" / "checkpoint-0.ckpt")
            for mode in (True, False))
    assert_bit_equal(a["payload"], b["payload"])
    for meta in (a["meta"], b["meta"]):
        del meta["settings"]["output_dir"], meta["settings"]["async_checkpoint"]
    assert a["meta"] == b["meta"]


def _child(source: str, *args: str) -> subprocess.Popen:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.Popen([sys.executable, "-c", CHILD_PRELUDE + source, *args], cwd=ROOT,
                            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_a_kill_between_the_tmp_write_and_the_rename_keeps_the_old_checkpoint(frames, tmp_path):
    # The child saves epoch 0, then parks epoch 1's writer between the .tmp
    # file and the rename; it is killed there.
    child = _child("""
settings = pretrain.PretrainSettings(**json.loads(sys.argv[1]))
pretrain.run_pretraining(settings)
checkpoint._WRITE_DELAY_S = 60.0
settings.epochs, settings.resume = 2, "auto"
pretrain.run_pretraining(settings)
""", json.dumps(asdict(port_settings(frames, tmp_path, epochs=1))))
    tmp = tmp_path / "ckpts" / "checkpoint-1.ckpt.tmp"
    deadline = time.time() + 120
    try:
        while not tmp.exists() and child.poll() is None and time.time() < deadline:
            time.sleep(0.05)
        assert tmp.exists(), child.communicate(timeout=10)[0] if child.poll() is not None else ""
    finally:
        child.kill()
        child.communicate(timeout=60)
    assert not (tmp_path / "ckpts" / "checkpoint-1.ckpt").exists()
    old = checkpoint.load_checkpoint(tmp_path / "ckpts" / "last.ckpt")
    assert old["meta"]["epoch"] == 0 and int(old["payload"]["opt"]["step"]) == STEPS_PER_EPOCH
    summary = pretrain.run_pretraining(port_settings(frames, tmp_path, resume="auto"))
    assert summary["epoch"] == 1
    assert "at epoch 1" in (tmp_path / "pretrain.log").read_text()


def test_a_real_sigterm_to_a_child_saves_exits_0_and_resumes(frames, tmp_path):
    # Port of tests/test_pretrain.py::test_sigterm_save_and_resume.
    child = _child("""
scalar = RunLogger.scalar
def stepped(self, *args, **kwargs):
    print("STEPPED", flush=True)
    return scalar(self, *args, **kwargs)
RunLogger.scalar = stepped
summary = pretrain.run_pretraining(pretrain.PretrainSettings(**json.loads(sys.argv[1])))
print("SUMMARY " + json.dumps(summary), flush=True)
""", json.dumps(asdict(port_settings(frames, tmp_path, epochs=50, save_freq_epochs=1000))))
    lines, deadline = [], time.time() + 120
    try:
        while time.time() < deadline:
            line = child.stdout.readline()
            if not line:
                break
            lines.append(line)
            if line.startswith("STEPPED"):
                child.send_signal(signal.SIGTERM)
                break
        rest, _ = child.communicate(timeout=120)
    finally:
        child.kill()
    output = "".join(lines) + rest
    assert child.returncode == 0, output
    summary = json.loads([l for l in output.splitlines() if l.startswith("SUMMARY ")][-1][8:])
    assert summary["interrupted"] is True, output
    epoch = int(summary["epoch"])
    ckpts = tmp_path / "ckpts"
    assert (ckpts / f"checkpoint-{epoch}.ckpt").exists() and (ckpts / "last.ckpt").exists()
    assert "Signal received" in (tmp_path / "pretrain.log").read_text()
    resumed = pretrain.run_pretraining(port_settings(frames, tmp_path, epochs=epoch + 2,
                                                     resume="auto"))
    assert resumed["epoch"] == epoch + 1
    assert epochs_logged(tmp_path)[-1] == epoch + 1


def test_a_join_that_raises_still_restores_the_handlers_and_closes_the_logger(
        frames, tmp_path, monkeypatch):
    # The JAX engine's finally skips both when checkpointer.wait() raises.
    class FailingJoin(checkpoint.AsyncCheckpointer):
        saving = False

        def wait(self):
            super().wait()
            if not self.saving:
                raise OSError("the disk went away")

        def save(self, *args, **kwargs):
            self.saving = True
            try:
                return super().save(*args, **kwargs)
            finally:
                self.saving = False

    closed = []
    close = run_logging.RunLogger.close
    monkeypatch.setattr(pretrain, "AsyncCheckpointer", FailingJoin)
    monkeypatch.setattr(run_logging.RunLogger, "close",
                        lambda self: closed.append(self.stem) or close(self))

    def mine(signum, frame):
        pass

    saved = {sig: signal.signal(sig, mine) for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        with pytest.raises(OSError, match="the disk went away"):
            pretrain.run_pretraining(port_settings(frames, tmp_path, epochs=1))
        assert signal.getsignal(signal.SIGTERM) is mine and signal.getsignal(signal.SIGINT) is mine
    finally:
        for sig, handler in saved.items():
            signal.signal(sig, handler)
    assert closed == ["pretrain"]
    assert (tmp_path / "ckpts" / "checkpoint-0.ckpt").exists()


def test_save_freq_mins_saves_after_every_step_of_an_overdue_epoch(frames, tmp_path,
                                                                   monkeypatch):
    saved = []

    class Counting(checkpoint.AsyncCheckpointer):
        def save(self, path, payload, meta=None, **kwargs):
            saved.append((Path(path).name, int(payload["opt"]["step"])))
            return super().save(path, payload, meta, **kwargs)

    monkeypatch.setattr(pretrain, "AsyncCheckpointer", Counting)
    pretrain.run_pretraining(port_settings(frames, tmp_path, epochs=1, save_freq_epochs=1000,
                                           save_freq_mins=1e-9))
    # Three mid-epoch saves (after each step), then the last epoch's.
    assert saved == [("checkpoint-0.ckpt", 1), ("checkpoint-0.ckpt", 2),
                     ("checkpoint-0.ckpt", 3), ("checkpoint-0.ckpt", 3)]


@pytest.mark.parametrize("bad", ["loss", "grad_norm"])
def test_a_non_finite_loss_saves_then_raises_and_a_non_finite_norm_warns(
        frames, tmp_path, monkeypatch, bad):
    build = pretrain.make_pretrain_step

    def poisoned(*args, **kwargs):
        step = build(*args, **kwargs)

        def run(state, images, noise, lr):
            metrics = step(state, images, noise, lr)
            return dict(metrics, **{bad: torch.tensor(float("nan"))}) if state.opt.step == 2 \
                else metrics
        return run

    monkeypatch.setattr(pretrain, "make_pretrain_step", poisoned)
    settings = port_settings(frames, tmp_path, epochs=1)
    log = tmp_path / "pretrain.log"
    if bad == "loss":
        with pytest.raises(FloatingPointError, match="Loss is nan"):
            pretrain.run_pretraining(settings)
        restored = checkpoint.load_checkpoint(tmp_path / "ckpts" / "last.ckpt")
        assert int(restored["payload"]["opt"]["step"]) == 2 and restored["meta"]["epoch"] == 0
        assert "FATAL: non-finite loss nan at step 2" in log.read_text()
    else:
        assert pretrain.run_pretraining(settings)["epoch"] == 0
        assert "WARNING: non-finite grad norm at step 2" in log.read_text()


def test_cli_flag_surface_round_trips_types():
    # Port of tests/test_pretrain.py::test_cli_roundtrip_types.
    settings = cli.parse_into_dataclass(pretrain.PretrainSettings, [
        "--data-root", "/tmp/x",
        "--save-freq-mins", "5",
        "--keep-every-n-epochs", "50",
        "--limit-steps-per-epoch", "3",
        "--use-pallas-attention", "false",
        "--norm-pix-loss",
        "--no-train-dir", "true",
        "--blr", "2e-4",
        "--steps-per-call", "2",
        "--async-checkpoint", "off",
        "--device", "cpu",
    ])
    assert settings.save_freq_mins == 5.0
    assert isinstance(settings.save_freq_mins, float)
    assert settings.keep_every_n_epochs == 50
    assert settings.limit_steps_per_epoch == 3
    assert settings.use_pallas_attention is False
    assert settings.norm_pix_loss is True
    assert settings.no_train_dir is True
    assert settings.blr == 2e-4
    assert settings.steps_per_call == 2 and settings.async_checkpoint is False
    assert settings.device == "cpu"
    # defaults survive
    assert settings.resume is None
    assert settings.save_freq_epochs == 20
    # Every JAX flag exists in the port with the JAX default; the port adds
    # only the device, which defaults to the card.
    ours, theirs = asdict(pretrain.PretrainSettings()), asdict(jax_pretrain.PretrainSettings())
    assert {k: v for k, v in ours.items() if k != "device"} == theirs
    assert ours["device"] == "cuda"


def test_cli_main_runs_an_epoch(frames, tmp_path):
    summary = pretrain.cli_main(["--data-root", str(frames), "--output-dir", str(tmp_path),
                                 "--epochs", "1", "--batch-size", str(BATCH), "--image-size",
                                 "32", "--no-train-dir", "--device", "cpu",
                                 "--num-workers", "2"])
    assert summary["epoch"] == 0 and np.isfinite(summary["train_loss"])
    assert (tmp_path / "ckpts" / "checkpoint-0.ckpt").exists()


def test_model_config_refuses_unknown_presets_and_honours_precision(monkeypatch):
    monkeypatch.undo()  # the real presets
    with pytest.raises(ValueError, match="Unknown model preset"):
        pretrain.model_config(pretrain.PretrainSettings(model="mae_vit_huge_patch14"))
    fp32 = pretrain.model_config(pretrain.PretrainSettings(precision="fp32"))
    assert fp32.encoder.compute_dtype == torch.float32 and fp32.encoder.attention_softmax_f32
    bf16 = pretrain.model_config(pretrain.PretrainSettings(use_pallas_attention=False))
    assert bf16 == pretrain.model_config(pretrain.PretrainSettings(use_pallas_attention=True))
    assert bf16.encoder.compute_dtype == torch.bfloat16 and not bf16.encoder.attention_softmax_f32


def test_hyperkvasir_wrapper_matches_the_jax_wrapper(monkeypatch):
    ours = asdict(hyperkvasir.hyperkvasir_settings("/data/hk", epochs=3))
    assert ours.pop("device") == "cuda"
    assert ours == asdict(jax_hyperkvasir.hyperkvasir_settings("/data/hk", epochs=3))
    seen = []
    monkeypatch.setattr(hyperkvasir, "run_pretraining", seen.append)
    hyperkvasir.main(["--data-root", "/data/hk", "--epochs", "2"])
    hyperkvasir.main(["--data-root", "/data/hk", "--device", "cpu", "--batch-size", "8"])
    assert [(s.device, s.epochs, s.batch_size, s.resume) for s in seen] == [
        ("cuda", 2, 64, "auto"), ("cpu", 400, 8, "auto")]


def test_build_classifier_loads_the_encoder_of_an_mae_ckpt(tmp_path):
    state = pretrain.init_pretrain_state(MAE(TINY, torch.Generator().manual_seed(4)))
    payload = pretrain.checkpoint_payload(state)
    path = checkpoint.save_checkpoint(tmp_path / "checkpoint-3.ckpt", payload, {"epoch": 3})
    checkpoint.update_pointer(tmp_path / "last.ckpt", path)
    (tmp_path / "bare").write_bytes(path.read_bytes())  # msgpack without the suffix
    want = state_dict_from_jax(encoder_only(payload["params"]), TINY.encoder)
    fresh = build_classifier(torch.Generator().manual_seed(7), {"ss_framework": "mae"},
                             device="cpu", **ENCODER)
    for name in ("checkpoint-3.ckpt", "checkpoint-3.ckpt.json", "last.ckpt", "bare"):
        built = build_classifier(torch.Generator().manual_seed(7),
                                 {"ss_framework": "mae", "key": "ssl_colon", "checkpoint": name},
                                 checkpoint_root=tmp_path, device="cpu", **ENCODER)
        got = built.model.state_dict()
        assert built.scheme == "ssl_colon" and built.cfg.pos_embed == "sincos"
        assert sorted(set(got) - set(want)) == ["head.bias", "head.weight"]
        assert all(torch.equal(got[n], want[n]) for n in want), name
        assert all(torch.equal(got[n], state.params[n]) for n in want if n in state.params)
        # The head is fresh from the generator, as without a checkpoint.
        head = fresh.model.state_dict()
        assert all(torch.equal(got[n], head[n]) for n in ("head.weight", "head.bias"))

    # The same MAE as an upstream-layout torch .pth (timm's MAE names under
    # "model"), by its name, without its suffix, and by an absolute path:
    # the same encoder, the sin-cos table the file's.
    torch.save({"model": {n: t.detach() for n, t in state.params.items()}},
               tmp_path / "mae.pth")
    (tmp_path / "torch_pickle").write_bytes((tmp_path / "mae.pth").read_bytes())
    for name in ("mae.pth", "torch_pickle", str(tmp_path / "torch_pickle")):
        built = build_classifier(torch.Generator().manual_seed(7),
                                 {"ss_framework": "mae", "key": "ssl_imnet", "checkpoint": name},
                                 checkpoint_root=tmp_path, device="cpu", **ENCODER)
        got = built.model.state_dict()
        assert built.scheme == "ssl_imnet" and built.cfg.pos_embed == "sincos"
        assert all(torch.equal(got[n], want[n]) for n in want), name
    # An empty .pth model and a .ckpt named as an AugReg file fail as the
    # JAX factory fails on them.
    torch.save({"model": {}}, tmp_path / "empty.pth")
    for model_cfg in ({"ss_framework": "mae", "checkpoint": "empty.pth"},
                      {"pretraining": "ImageNet_class", "checkpoint": "checkpoint-3.ckpt"}):
        with pytest.raises(Exception) as theirs:
            from ssl4polyp_tpu.models.factory import build_classifier as jax_build_classifier
            jax_build_classifier(jax.random.PRNGKey(0), model_cfg, checkpoint_root=tmp_path,
                                 **ENCODER)
        with pytest.raises(type(theirs.value), match=re.escape(str(theirs.value))):
            build_classifier(torch.Generator(), model_cfg, checkpoint_root=tmp_path,
                             device="cpu", **ENCODER)


@pytest.mark.parametrize("scalars", [
    [("train/loss", 0.5, 1), ("train/loss", 0.25, 2), ("val/auroc", 0.975, 2)],
    [("x", -1e30, 0), ("lr", 3.0e-6, 2 ** 40), ("tag with space", float("inf"), 7)],
])
def test_scalar_event_files_are_the_jax_writers_bytes(tmp_path, monkeypatch, scalars):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    files = []
    for module, where in ((tb_events, "port"), (jax_tb_events, "jax")):
        writer = module.ScalarEventWriter(tmp_path / where)
        for tag, value, step in scalars:
            writer.add_scalar(tag, value, step)
        writer.close()
        files.append(writer._path)
    assert files[0].name == files[1].name
    assert files[0].read_bytes() == files[1].read_bytes()


@pytest.mark.parametrize("data", [b"", b"123456789", bytes(range(256)) * 3])
def test_crc32c_matches_the_jax_writer(data):
    assert tb_events._crc32c(data) == jax_tb_events._crc32c(data)
    assert tb_events._masked_crc(data) == jax_tb_events._masked_crc(data)
    assert tb_events._crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("blocked, writer", [
    (("torch.utils.tensorboard",), tb_events.ScalarEventWriter),
    (("torch.utils.tensorboard", "ssl4polyp_tpu_torch.utils.tb_events"), run_logging._NoOpWriter),
])
def test_run_logger_falls_back_when_tensorboard_does_not_import(tmp_path, monkeypatch, blocked,
                                                                writer):
    for name in blocked:
        monkeypatch.setitem(sys.modules, name, None)
    logger = run_logging.RunLogger(tmp_path, "run", echo=False)
    assert type(logger.tb) is writer
    logger.scalar("loss", 1.0, 0)
    logger.json_line({"epoch": 0, "loss": 1.0})
    logger.close()
    events = list((tmp_path / "tb" / "run").glob("events.out.tfevents.*"))
    assert len(events) == (1 if writer is tb_events.ScalarEventWriter else 0)
    reference = jax_logging.RunLogger(tmp_path / "jax", "run", echo=False, primary=True)
    reference.json_line({"epoch": 0, "loss": 1.0})
    reference.close()
    assert (tmp_path / "run.jsonl").read_text() == (tmp_path / "jax" / "run.jsonl").read_text()
    silent = run_logging.RunLogger(tmp_path / "rank1", "run", primary=False)
    silent.text("nothing")
    silent.json_line({"epoch": 0})
    assert not (tmp_path / "rank1").exists()


@pytest.mark.parametrize("seed", [0, 13, 2 ** 40 + 3])
def test_determinism_helpers_match_the_jax_ones(seed):
    draws = []
    for module in (determinism, jax_determinism):
        rng = module.set_determinism(seed)
        draws.append((random.random(), np.random.rand(3).tolist(), rng.random(3).tolist()))
    assert draws[0] == draws[1]
    for rank, epoch in ((0, 0), (3, 7), (10 ** 6, 10 ** 9)):
        assert determinism.worker_seed(seed, rank, epoch) == jax_determinism.worker_seed(
            seed, rank, epoch)
    # torch's global generator is seeded too.
    determinism.set_determinism(seed)
    first = torch.rand(2)
    determinism.set_determinism(seed)
    assert torch.equal(first, torch.rand(2))
