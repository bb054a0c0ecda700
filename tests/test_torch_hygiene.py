"""The port imports and runs (an eval forward, a pretrain step, a fine-tune
step, a split evaluation, the standalone eval CLI's ``evaluate``, the
pretraining CLI for an epoch and a resume, and the fine-tune CLI through a
tiny exp2 flow from an MAE checkpoint, the pack tools' CLI from a
synthetic SUN root to its perturbation grid, and the reporting tools' two
CLIs from exp1's runs to its report) without jax, flax, msgpack,
scikit-learn or the JAX package itself (the GPU machine lacks jax and flax),
and imports without PyYAML and PIL (which only the
manifest and frame readers import, where they open a file, and the native
JPEG decoder, where it finds and checks PIL's libjpeg); the loaders of the
eval CLI, the MAE fine-tune and probe and both engines read their JPEGs
through that decoder, no frame through PIL; no source of the
port imports the forbidden ones, no line of the port's sweep scripts
(``scripts/torch``) runs them, every ``device`` parameter defaults to the
card, and chip_smoke.py refuses to run without CUDA."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_BLOCKED_SCRIPT = """
import sys
for name in ("jax", "flax", "msgpack", "yaml", "PIL", "sklearn", "ssl4polyp_tpu", "ml_dtypes"):
    sys.modules[name] = None  # any import of them raises ImportError

import importlib, pkgutil
import numpy as np, torch
import ssl4polyp_tpu_torch

modules = [m.name for m in pkgutil.walk_packages(ssl4polyp_tpu_torch.__path__, "ssl4polyp_tpu_torch.")]
for name in modules:
    importlib.import_module(name)
assert {"ssl4polyp_tpu_torch.training.pretrain", "ssl4polyp_tpu_torch.training.hyperkvasir",
        "ssl4polyp_tpu_torch.utils.logging", "ssl4polyp_tpu_torch.utils.tb_events",
        "ssl4polyp_tpu_torch.utils.cli", "ssl4polyp_tpu_torch.utils.determinism",
        "ssl4polyp_tpu_torch.configs.layered", "ssl4polyp_tpu_torch.training.layout",
        "ssl4polyp_tpu_torch.training.protocol", "ssl4polyp_tpu_torch.training.schedules",
        "ssl4polyp_tpu_torch.metrics.threshold_store",
        "ssl4polyp_tpu_torch.evaluation.exports",
        "ssl4polyp_tpu_torch.training.mae_finetune",
        "ssl4polyp_tpu_torch.utils.reporting_inputs",
        "ssl4polyp_tpu_torch.parallel", "ssl4polyp_tpu_torch.parallel.mesh",
        "ssl4polyp_tpu_torch.parallel.multihost",
        "ssl4polyp_tpu_torch.native", "ssl4polyp_tpu_torch.native.reference",
        *("ssl4polyp_tpu_torch.analysis." + name for name in (
            "bootstrapper", "common", "display", "exp5a_domain_shift", "exp_reports",
            "frame_bootstrap", "guardrails", "report_core", "seed_checks"))} <= set(modules)
import chip_smoke  # noqa: F401  (main() is not run)

from ssl4polyp_tpu_torch.models.factory import get_mae_backbone
from ssl4polyp_tpu_torch.training.classification import make_forward_fn

classifier = get_mae_backbone(torch.Generator().manual_seed(0), device="cpu", img_size=32,
                              patch_size=8, embed_dim=64, depth=2, num_heads=4, pad_tokens_to=24)
images = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
logits = make_forward_fn(classifier, "cpu")()(images)
assert logits.shape == (2, 2) and logits.dtype == np.float32 and np.isfinite(logits).all()

# One pretrain step of a tiny MAE in bf16, the pretrain recipe's dtype.
from ssl4polyp_tpu_torch.models.mae import MAE, MAEConfig
from ssl4polyp_tpu_torch.models.vit import ViTConfig
from ssl4polyp_tpu_torch.training.pretrain import init_pretrain_state, make_pretrain_step

cfg = MAEConfig(encoder=ViTConfig(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4,
                                  attention_softmax_f32=False),
                decoder_embed_dim=32, decoder_depth=1, decoder_num_heads=2)
state = init_pretrain_state(MAE(cfg, torch.Generator().manual_seed(0)))
gen = torch.Generator().manual_seed(1)
batch = torch.randint(0, 256, (1, 2, 32, 32, 3), dtype=torch.uint8, generator=gen)
metrics = make_pretrain_step(cfg, 1, 0.05)(state, batch, torch.rand((1, 2, 16), generator=gen), 1e-3)
assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics

# One fine-tune step of a tiny classifier in bf16 through the LN+QKV and
# LN+MLP routes.
from ssl4polyp_tpu_torch.models.factory import build_classifier
from ssl4polyp_tpu_torch.training import classification, optim

clf = build_classifier(torch.Generator().manual_seed(0), {}, device="cpu", img_size=32,
                       patch_size=8, embed_dim=128, depth=2, num_heads=4, mlp_fusion="full_ln",
                       qkv_ln_fusion=True)
assert {(b.mlp_route, b.qkv_ln) for b in clf.model.blocks} == {("full_ln", True)}
ctx = classification.step_context(clf, *classification.loss_settings([3, 1]), weight_decay=0.05)
state = classification.init_train_state(clf, torch.Generator().manual_seed(2))
scales = optim.finetune_lr_scales(state.params, "head+1", 2)
metrics = classification.make_train_step(ctx)(
    state, batch[0], torch.tensor([0, 1]), torch.tensor([True, True]), 1e-4, scales,
    optim.no_weight_decay_scales(state.params))
assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics

# The weight-file readers and the dense model: an upstream-layout MAE .pth
# and an AugReg .npz written here, each read by build_classifier, the .pth
# into the dense classifier, whose logits come out of make_forward_fn.
import tempfile
from pathlib import Path
from ssl4polyp_tpu_torch.models.dpt import TAP_BLOCKS
from ssl4polyp_tpu_torch.models.factory import DenseClassifier

tiny = dict(img_size=32, patch_size=16, embed_dim=64, depth=12, num_heads=4)
with tempfile.TemporaryDirectory() as tmp:
    mae_cfg = MAEConfig(encoder=ViTConfig(**tiny), decoder_embed_dim=32, decoder_depth=1,
                        decoder_num_heads=2)
    chip_smoke.write_mae_pth(Path(tmp) / "mae.pth", mae_cfg, np.random.default_rng(0))
    chip_smoke.write_augreg_npz(Path(tmp) / "augreg.npz", ViTConfig(**tiny, num_classes=2),
                                np.random.default_rng(1))
    sup = build_classifier(torch.Generator().manual_seed(0),
                           {"pretraining": "ImageNet_class", "checkpoint": "augreg.npz"},
                           checkpoint_root=Path(tmp), device="cpu", **tiny)
    assert sup.scheme == "sup_imnet"
    dense = build_classifier(torch.Generator().manual_seed(0),
                             {"ss_framework": "mae", "key": "ssl_imnet", "checkpoint": "mae.pth",
                              "dense": True, "dense_readout": "add"},
                             checkpoint_root=Path(tmp), device="cpu", **tiny)
    assert isinstance(dense, DenseClassifier) and dense.scheme == "ssl_imnet"
    dense_logits = make_forward_fn(dense, "cpu")()(images)
    assert dense_logits.shape == (2, 16, 16, 2) and np.isfinite(dense_logits).all()

# A split evaluation over two in-memory batches, with its breakdowns.
from types import SimpleNamespace
from ssl4polyp_tpu_torch.evaluation.evaluate import evaluate_split

rng = np.random.default_rng(1)
batches = [{"image": rng.standard_normal((4, 2)).astype(np.float32),
            "label": np.array([0, 1, 1, 0]), "index": np.arange(4) + 4 * i,
            "valid": np.array([True, True, True, i == 0])} for i in range(2)]
meta = [{"case_id": f"c{i % 2}", "morphology": "flat" if i % 3 else "polypoid",
         "variant": "clean" if i % 2 else "blur"} for i in range(8)]
out = evaluate_split(lambda logits: logits, batches, SimpleNamespace(meta=meta),
                     split_name="test", morphology_eval=("flat", "polypoid"),
                     perturbation_eval=True)
assert out["n_total"] == 7 and 0.0 <= out["auroc"] <= 1.0 and np.isfinite(out["loss"])
assert set(out["morphology_metrics"]) == {"flat", "polypoid"}
assert set(out["perturbation_metrics"]) == {"clean", "blur", "ALL-perturbed"}
assert set(out["case_metrics"]) == {"c0", "c1"}

# The standalone eval on a tiny pack and checkpoint.  PyYAML and PIL come
# back only now: every module imported without them, and only the manifest
# and frame readers (and the synthetic pack's writer) import them.
import tempfile
from pathlib import Path
del sys.modules["yaml"], sys.modules["PIL"]
from ssl4polyp_tpu_torch import native
from ssl4polyp_tpu_torch.evaluation.eval_classification import evaluate
from ssl4polyp_tpu_torch.polypdb.synth import build_synthetic_pack
from ssl4polyp_tpu_torch.utils.checkpoint import save_checkpoint

with tempfile.TemporaryDirectory() as tmp:
    pack = build_synthetic_pack(Path(tmp), name="tiny", splits=("test",), frames_per_split=6,
                                image_size=32)
    model_cfg = dict(img_size=32, patch_size=8, embed_dim=32, depth=1, num_heads=2,
                     pos_embed="learned", out_token="cls", num_classes=2, pad_tokens_to=0)
    tree = chip_smoke.jax_layout_tree(
        ViTConfig(**{k: v for k, v in model_cfg.items() if k != "out_token"}),
        np.random.default_rng(0))
    ckpt = save_checkpoint(Path(tmp) / "Tiny_Synth_s1.ckpt", {"params": tree},
                           {"model_cfg": model_cfg, "thresholds": {"primary": {"tau": 0.25}}})
    native.reset_decode_counts()
    summary = evaluate(ckpt, pack, batch_size=4, image_size=32, num_workers=1, device="cpu",
                       output_dir=Path(tmp) / "eval", export_outputs=True)
    # The loader read the JPEG pack through the native decoder, no frame through PIL.
    assert native.decode_counts() == {"decoded": 6, "failed": 0}, native.decode_counts()
    assert summary["n_frames"] == 6 and summary["tau"] == 0.25 and np.isfinite(summary["loss"])
    assert (Path(tmp) / "eval" / "logits.pt").exists()

# The upstream MAE fine-tune (Mixup/CutMix, erasing, layer decay) and the
# linear probe (LARS) on a tiny pack.
from ssl4polyp_tpu_torch.data.packs import create_classification_datasets
from ssl4polyp_tpu_torch.training.mae_finetune import (MAEFinetuneSettings, run_linear_probe,
                                                       run_mae_finetune)

with tempfile.TemporaryDirectory() as tmp:
    pack = build_synthetic_pack(Path(tmp), name="tiny", splits=("train",), frames_per_split=8,
                                image_size=32)
    train = create_classification_datasets(train_spec=pack, image_size=32)["train"]
    settings = MAEFinetuneSettings(epochs=1, warmup_epochs=0, batch_size=4, num_workers=1,
                                   mixup_alpha=0.8, cutmix_alpha=1.0)
    native.reset_decode_counts()
    tuned = run_mae_finetune(classifier, train, settings, device="cpu")
    probed = run_linear_probe(classifier, train, MAEFinetuneSettings(
        epochs=1, warmup_epochs=0, batch_size=4, num_workers=1, base_lr=0.1, weight_decay=0.0,
        smoothing=0.0), device="cpu")
    assert native.decode_counts() == {"decoded": 16, "failed": 0}, native.decode_counts()
    assert np.isfinite(tuned["train_loss"]) and np.isfinite(probed["train_loss"])
    assert set(tuned["params"]) == set(probed["params"]) == set(
        dict(classifier.model.named_parameters()))

leaked = sorted(m for m in sys.modules
                if (m == "ssl4polyp_tpu" or m.startswith("ssl4polyp_tpu."))
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok", len(modules))
"""


# The pretraining engine's CLI on the CPU with the JAX stack blocked (PIL
# allowed: the native decoder links its libjpeg): one epoch, then an
# auto-resume for a second.  TensorBoard's import is blocked too, so RunLogger takes the
# port's own event writer, as on a host without the tensorboard package.
_ENGINE_SCRIPT = """
import sys
for name in ("jax", "flax", "msgpack", "yaml", "sklearn", "ssl4polyp_tpu",
             "torch.utils.tensorboard"):
    sys.modules[name] = None

import json, tempfile
from pathlib import Path
import numpy as np, torch
from PIL import Image
from ssl4polyp_tpu_torch import native
from ssl4polyp_tpu_torch.models.mae import MAEConfig
from ssl4polyp_tpu_torch.models.vit import ViTConfig
from ssl4polyp_tpu_torch.training import pretrain
from ssl4polyp_tpu_torch.utils.checkpoint import load_checkpoint
from ssl4polyp_tpu_torch.utils.tb_events import ScalarEventWriter

pretrain.model_config = lambda settings: MAEConfig(
    encoder=ViTConfig(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2,
                      compute_dtype=torch.float32),
    decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2)
with tempfile.TemporaryDirectory() as tmp:
    tmp = Path(tmp)
    (tmp / "frames").mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        Image.fromarray(rng.integers(0, 256, (40, 40, 3), dtype=np.uint8)).save(
            tmp / "frames" / f"{i}.jpg")
    argv = ["--data-root", str(tmp / "frames"), "--output-dir", str(tmp / "out"),
            "--no-train-dir", "--batch-size", "4", "--image-size", "32", "--num-workers", "2",
            "--warmup-epochs", "1", "--log-interval", "1", "--device", "cpu"]
    first = pretrain.cli_main(argv + ["--epochs", "1"])
    second = pretrain.cli_main(argv + ["--epochs", "2", "--resume", "auto"])
    # Both epochs cropped every JPEG through the native decoder.
    assert native.decode_counts() == {"decoded": 16, "failed": 0}, native.decode_counts()
    assert first["epoch"] == 0 and second["epoch"] == 1, (first, second)
    restored = load_checkpoint(tmp / "out" / "ckpts" / "last.ckpt")
    assert restored["meta"]["epoch"] == 1 and int(restored["payload"]["opt"]["step"]) == 4
    lines = (tmp / "out" / "pretrain.jsonl").read_text().splitlines()
    assert [json.loads(line)["epoch"] for line in lines] == [0, 1]
    assert "Resumed from" in (tmp / "out" / "pretrain.log").read_text()
    assert list((tmp / "out" / "tb" / "pretrain").glob("events.out.tfevents.*"))

leaked = sorted(m for m in sys.modules
                if (m == "ssl4polyp_tpu" or m.startswith("ssl4polyp_tpu."))
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


# The fine-tune CLI on the CPU with the JAX stack blocked (PyYAML and PIL
# allowed: the configs and the frames need them), as ``python -m
# ssl4polyp_tpu_torch.training.classification`` runs: exp2's SSL-colon arm at
# a tiny width, from an MAE checkpoint the port writes where
# config/model/ssl_colon.yaml names it.  The output stays in argv[1] for the
# JAX guardrails.
_FINETUNE_SCRIPT = """
import sys
for name in ("jax", "flax", "msgpack", "sklearn", "ssl4polyp_tpu", "torch.utils.tensorboard"):
    sys.modules[name] = None

import json, runpy
from pathlib import Path
import torch
from ssl4polyp_tpu_torch.models import factory
from ssl4polyp_tpu_torch.models.mae import MAE, MAEConfig
from ssl4polyp_tpu_torch.models.vit import ViTConfig
from ssl4polyp_tpu_torch.models.weights import jax_from_mae_state_dict
from ssl4polyp_tpu_torch.polypdb.synth import build_synthetic_pack
from ssl4polyp_tpu_torch.utils.checkpoint import save_checkpoint

tmp = Path(sys.argv[1])
build_synthetic_pack(tmp / "data_packs", name="sun_full", frames_per_split=8, image_size=32)
cfg = MAEConfig(encoder=ViTConfig(img_size=32, patch_size=8, embed_dim=32, depth=2, num_heads=2),
                decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2)
mae = MAE(cfg, torch.Generator().manual_seed(0))
save_checkpoint(tmp / "ckpts" / "checkpoints/pretrained/vit_b/mae_hyperkvasir.ckpt",
                {"params": jax_from_mae_state_dict(dict(mae.named_parameters()), cfg)},
                {"epoch": 0})
# The CLI has no width flag: the fresh module that runpy executes imports
# build_classifier by name, so a tiny width goes in through the factory.
build_classifier = factory.build_classifier
factory.build_classifier = lambda *a, **kw: build_classifier(
    *a, **{**kw, "embed_dim": 32, "depth": 2, "num_heads": 2, "patch_size": 8})
sys.argv = ["classification", "--exp-config", "exp/exp2", "--model-key", "ssl_colon",
            "--seed", "47", "--pack-root", str(tmp / "data_packs"),
            "--checkpoint-root", str(tmp / "ckpts"), "--thresholds-root", str(tmp / "th"),
            "--output-dir", str(tmp / "out"), "--device", "cpu",
            "--override", "epochs=2", "--override", "batch_size=4",
            "--override", "image_size=32", "--override", "num_workers=2"]
runpy.run_module("ssl4polyp_tpu_torch.training.classification", run_name="__main__")
# Every split's JPEGs went through the native decoder, none through PIL.
from ssl4polyp_tpu_torch import native
counts = native.decode_counts()
assert counts["decoded"] > 0 and counts["failed"] == 0, counts

leaked = sorted(m for m in sys.modules
                if (m == "ssl4polyp_tpu" or m.startswith("ssl4polyp_tpu."))
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


# The pack tools with the JAX stack blocked, OpenCV too (a GPU host may lack
# it): the polypdb package and its four modules import without PyYAML and
# PIL, and then, with both back, the port's CLI writes a SUN root, its
# sun_full pack and the perturbation grid, as ``python -m
# ssl4polyp_tpu_torch.polypdb.cli`` runs.
_POLYPDB_SCRIPT = """
import sys
for name in ("jax", "flax", "msgpack", "yaml", "PIL", "sklearn", "ssl4polyp_tpu", "cv2"):
    sys.modules[name] = None

import importlib, runpy
from pathlib import Path
for name in ("__init__", "synth", "builders", "robustness", "cli"):
    importlib.import_module("ssl4polyp_tpu_torch.polypdb" + ("" if name == "__init__" else "." + name))
del sys.modules["yaml"], sys.modules["PIL"]

tmp = Path(sys.argv[1])
for argv in (["synth-root", "--layout", "sun", "--out", str(tmp / "root"), "--image-size", "16",
              "--scale", "0.5"],
             ["sun", "build", "--root", str(tmp / "root"), "--out", str(tmp / "sun_full"),
              "--frames-per-case", "6", "--cases-per-split", "2", "1", "1"],
             ["sun", "perturbations", "--pack", str(tmp / "sun_full"), "--out",
              str(tmp / "sun_test_perturbations")]):
    sys.argv = ["polypdb", *argv]
    runpy.run_module("ssl4polyp_tpu_torch.polypdb.cli", run_name="__main__")

leaked = sorted(m for m in sys.modules
                if (m == "ssl4polyp_tpu" or m.startswith("ssl4polyp_tpu.") or m == "cv2")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


# The reporting tools with the JAX stack blocked, scikit-learn too (scipy
# stays: the card's machine has it): ``python -m
# ssl4polyp_tpu_torch.utils.reporting_inputs`` stages exp1's runs under
# argv[1], then ``python -m ssl4polyp_tpu_torch.analysis.exp_reports exp1``
# reports the staged tree with the seed check on.
_REPORTING_SCRIPT = """
import sys
for name in ("jax", "flax", "msgpack", "sklearn", "ssl4polyp_tpu"):
    sys.modules[name] = None

import runpy
from pathlib import Path

tmp = Path(sys.argv[1])
for module, argv in (
        ("ssl4polyp_tpu_torch.utils.reporting_inputs",
         ["--exp-config", "exp/exp1", "--runs-root", str(tmp / "runs"),
          "--results-root", str(tmp / "results")]),
        ("ssl4polyp_tpu_torch.analysis.exp_reports",
         ["exp1", "--runs-root",
          str(tmp / "results" / "reporting_inputs" / "exp1_sun_baselines_sup_vs_ssl"),
          "--output-dir", str(tmp / "report"), "--resamples", "20"])):
    sys.argv = [module, *argv]
    runpy.run_module(module, run_name="__main__")

leaked = sorted(m for m in sys.modules
                if (m == "ssl4polyp_tpu" or m.startswith("ssl4polyp_tpu.") or m == "sklearn")
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok")
"""


def _run(args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_and_runs_with_the_jax_stack_blocked():
    result = _run(["-c", _BLOCKED_SCRIPT])
    assert result.returncode == 0, result.stderr
    assert result.stdout.startswith("ok")
    assert int(result.stdout.split()[1]) >= 47  # every slice module was imported


# The data-parallel layer alone: importing it and initialising one process
# (no group to join) pulls in nothing blocked, and nothing of the JAX package.
_PARALLEL_SCRIPT = """
import sys
for name in ("jax", "flax", "msgpack", "yaml", "PIL", "sklearn", "ssl4polyp_tpu", "ml_dtypes"):
    sys.modules[name] = None
import os
for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE"):
    os.environ.pop(name, None)
from ssl4polyp_tpu_torch.parallel import initialize_multihost, is_distributed, is_primary, process_info
initialize_multihost()
assert not is_distributed() and is_primary() and process_info()["process_count"] == 1
loaded = sorted(m for m in sys.modules if m.split(".")[0] in (
    "jax", "flax", "msgpack", "yaml", "PIL", "sklearn", "ssl4polyp_tpu", "ml_dtypes")
    and sys.modules[m] is not None)
assert not loaded, loaded
print("ok")
"""


def test_parallel_layer_imports_and_initializes_with_the_jax_stack_blocked():
    result = _run(["-c", _PARALLEL_SCRIPT])
    assert result.returncode == 0, result.stderr
    assert result.stdout.splitlines()[-1] == "ok"


def test_pretraining_cli_runs_and_resumes_with_the_jax_stack_blocked():
    result = _run(["-c", _ENGINE_SCRIPT])
    assert result.returncode == 0, result.stderr
    assert result.stdout.splitlines()[-1] == "ok"


def test_finetune_cli_runs_an_exp2_flow_with_the_jax_stack_blocked(tmp_path):
    from ssl4polyp_tpu.analysis.guardrails import ResultLoader

    result = _run(["-c", _FINETUNE_SCRIPT, str(tmp_path)])
    assert result.returncode == 0, result.stderr
    lines = result.stdout.splitlines()
    assert lines[-1] == "ok"
    summary = json.loads(lines[-2])
    assert summary["stem"] == "SslColon_SUNFull_s47" and summary["epochs_run"] == 2
    assert summary["timings"]["build_s"] > 0
    metrics_path = Path(summary["metrics_path"])
    payload = json.loads(metrics_path.read_text())
    assert payload["run"]["experiment"] == "exp2" and payload["provenance"]["model"] == "ssl_colon"
    ResultLoader(exp_id="exp2", strict=True).validate(metrics_path, payload)
    run_dir = metrics_path.parent
    assert (run_dir / "SslColon_SUNFull_s47.config.yaml").exists()
    assert list((tmp_path / "th").rglob("policy-f1_opt_on_val.json"))
    assert "resumed" not in (run_dir / "SslColon_SUNFull_s47.log").read_text()


def test_pack_tools_import_and_build_with_the_jax_stack_blocked(tmp_path):
    import yaml

    from ssl4polyp_tpu.configs.manifests import load_pack

    result = _run(["-c", _POLYPDB_SCRIPT, str(tmp_path)])
    assert result.returncode == 0, result.stderr
    lines = result.stdout.splitlines()
    assert lines[-1] == "ok" and len(lines) == 4, lines
    assert lines[0] == f"wrote synthetic sun root to {tmp_path / 'root'}"
    grid = tmp_path / "sun_test_perturbations"
    manifest = yaml.safe_load((grid / "manifest.yaml").read_text())
    assert manifest["assertions"]["rows_per_clean_frame"] == 16
    # The JAX package's strict loader reads the port's packs, hashes checked.
    full = load_pack(**{s: tmp_path / "sun_full" / f"{s}.csv" for s in ("train", "val", "test")},
                     manifest_yaml=tmp_path / "sun_full" / "manifest.yaml")
    assert {s: len(full[s].rows) for s in ("train", "val", "test")} == {
        "train": 24, "val": 12, "test": 12}
    perturbed = load_pack(test=grid / "test.csv", manifest_yaml=grid / "manifest.yaml")
    assert len(perturbed["test"].rows) == 16 * 12 == manifest["assertions"]["rows"]


def test_reporting_tools_stage_and_report_with_the_jax_stack_blocked(tmp_path):
    from tests.test_analysis import synth_run

    for model in ("SupImnet", "SslImnet"):
        for seed in (13, 29, 47):
            synth_run(tmp_path / "runs" / "sun_baselines", model=model, seed=seed)
    result = _run(["-c", _REPORTING_SCRIPT, str(tmp_path)])
    assert result.returncode == 0, result.stderr
    assert result.stdout.splitlines() == [
        "staged 24 files into reporting_inputs/exp1_sun_baselines_sup_vs_ssl",
        f"wrote {tmp_path / 'report' / 'exp1_report.md'}", "ok"]
    manifest = json.loads((tmp_path / "report" / "exp1_manifest.json").read_text())
    assert manifest["n_runs"] == 6 and set(manifest["deltas"]) == {"SupImnet->SslImnet"}


def _forbidden_import(line: str):
    """The forbidden module an ``import`` / ``from`` line names, or None.
    Lines inside functions and ``TYPE_CHECKING`` blocks count: any
    indentation.  The JAX package is matched as the name followed by a dot
    or white space, so the port's own ``ssl4polyp_tpu_torch`` passes."""
    words = line.split()
    if words[:1] not in (["import"], ["from"]) or len(words) < 2:
        return None
    if re.search(r"\bssl4polyp_tpu(\.|\s|,|$)", line):
        return "ssl4polyp_tpu"
    names = [words[1]] if words[0] == "from" else line.split("import", 1)[1].split(",")
    for name in names:
        root = name.strip().split(" ")[0].split(".")[0]
        if root in {"jax", "flax", "sklearn", "msgpack"}:
            return root
    return None


def test_no_jax_import_in_the_port_sources():
    sources = [*(ROOT / "ssl4polyp_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py",
               *(ROOT / "scripts" / "torch").glob("*.py")]
    assert len(sources) > 45
    names = {path.relative_to(ROOT).as_posix() for path in sources}
    assert {"ssl4polyp_tpu_torch/utils/msgpack.py", "ssl4polyp_tpu_torch/utils/checkpoint.py",
            "ssl4polyp_tpu_torch/evaluation/eval_classification.py",
            "ssl4polyp_tpu_torch/ops/attention.py",
            "ssl4polyp_tpu_torch/ops/attention_block.py",
            *WEIGHT_FILE_MODULES, *POLYPDB_MODULES, *REPORTING_MODULES,
            *PARALLEL_MODULES, *NATIVE_MODULES} <= names
    for path in sources:
        for line in path.read_text().splitlines():
            assert _forbidden_import(line) is None, f"{path}: {line}"


# The weight-file readers and the dense model, with the modules they change.
WEIGHT_FILE_MODULES = {f"ssl4polyp_tpu_torch/models/{name}.py" for name in (
    "pth_reader", "import_torch", "augreg_cache", "dpt", "factory", "weights", "vit", "layers")}


# The pack tools: PyYAML, PIL and OpenCV only inside the functions that use them.
POLYPDB_MODULES = {f"ssl4polyp_tpu_torch/polypdb/{name}.py" for name in (
    "__init__", "synth", "builders", "robustness", "cli")}


# The native JPEG decoder: PIL only inside the functions that find and check
# its libjpeg.
NATIVE_MODULES = {f"ssl4polyp_tpu_torch/native/{name}.py" for name in ("__init__", "reference")}


# The data-parallel layer.
PARALLEL_MODULES = {f"ssl4polyp_tpu_torch/parallel/{name}.py"
                    for name in ("__init__", "mesh", "multihost")}


# The reporting tools and the sweep scripts' Python helpers.
REPORTING_MODULES = {
    "ssl4polyp_tpu_torch/utils/reporting_inputs.py",
    *(f"ssl4polyp_tpu_torch/analysis/{name}.py" for name in (
        "__init__", "bootstrapper", "common", "display", "exp5a_domain_shift", "exp_reports",
        "frame_bootstrap", "guardrails", "report_core", "seed_checks")),
    *(f"scripts/torch/{name}.py" for name in (
        "print_config_seeds", "print_config_models", "check_paths", "aggregate_metrics"))}


def _forbidden_in_script(line: str):
    """What a shell line of the port's scripts must not run: a module or a
    helper script of the JAX package, or jax, flax or scikit-learn."""
    if re.search(r"\bssl4polyp_tpu(\.|\s|$)", line):
        return "ssl4polyp_tpu"
    found = re.search(r"scripts/(?!torch/)[\w/]*\.py", line)
    if found:
        return found.group(0)
    found = re.search(r"\b(jax|flax|sklearn|scikit-learn)\b", line)
    return found.group(1) if found else None


def test_the_ports_sweep_scripts_run_only_the_port():
    scripts = sorted((ROOT / "scripts" / "torch").glob("*.sh"))
    assert {path.name for path in scripts} == {
        "run_exp_common.sh", "run_exp1.sh", "run_exp2.sh", "run_exp3.sh", "run_exp4.sh",
        "run_exp5a.sh", "run_exp5b.sh", "run_exp5c.sh", "run_exps.sh", "run_exp1_smoke.sh",
        "build_data_packs.sh"}
    calls = 0
    for path in scripts:
        for line in path.read_text().splitlines():
            assert _forbidden_in_script(line) is None, f"{path}: {line}"
            calls += "ssl4polyp_tpu_torch." in line
    assert calls >= 15


@pytest.mark.parametrize("line, found", [
    ("python -m ssl4polyp_tpu.training.classification \\", "ssl4polyp_tpu"),
    ("SEEDS=$(python scripts/print_config_seeds.py \"$EXP_CONFIG\")",
     "scripts/print_config_seeds.py"),
    ("pip install jax", "jax"),
    ("python -m ssl4polyp_tpu_torch.training.classification \\", None),
    ("SEEDS=$(python scripts/torch/print_config_seeds.py \"$EXP_CONFIG\")", None),
    ('bash "$(dirname "$0")/run_exp_common.sh" exp/exp1 "$@"', None),
])
def test_the_script_check_finds_what_it_should(line, found):
    assert _forbidden_in_script(line) == found


def test_only_the_msgpack_codec_imports_ml_dtypes_and_lazily():
    """numpy's bfloat16 comes from ``ml_dtypes``, which the card's machine
    may lack: the readers keep bf16 tensors as torch tensors, and only the
    ``.ckpt`` codec imports it, inside the function that decodes a bf16
    array."""
    importers = {}
    for path in [*(ROOT / "ssl4polyp_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1 \
                    and words[1].split(".")[0] == "ml_dtypes":
                importers.setdefault(path.relative_to(ROOT).as_posix(), []).append(line)
    assert set(importers) == {"ssl4polyp_tpu_torch/utils/msgpack.py"}, importers
    assert all(line.startswith(" ") for line in importers["ssl4polyp_tpu_torch/utils/msgpack.py"])
    assert not WEIGHT_FILE_MODULES & set(importers)


@pytest.mark.parametrize("line, found", [
    ("from ssl4polyp_tpu.evaluation import evaluate as reference", "ssl4polyp_tpu"),
    ("    from ssl4polyp_tpu.data.loader import HostDataLoader", "ssl4polyp_tpu"),
    ("import ssl4polyp_tpu", "ssl4polyp_tpu"),
    ("import os, ssl4polyp_tpu.metrics", "ssl4polyp_tpu"),
    ("from ssl4polyp_tpu import metrics", "ssl4polyp_tpu"),
    ("        from sklearn.metrics import f1_score", "sklearn"),
    ("import numpy, jax.numpy as jnp", "jax"),
    ("from flax import linen", "flax"),
    ("    from flax import serialization", "flax"),
    ("import msgpack", "msgpack"),
    ("from . import msgpack", None),
    ("from .utils import msgpack", None),
    ("from ssl4polyp_tpu_torch.ops import mlp", None),
    ("import ssl4polyp_tpu_torch", None),
    ("from ..metrics import performance as perf", None),
    ("Counterpart of ``ssl4polyp_tpu/metrics/performance.py``", None),
    ("import jaxtyping_like_name", None),
])
def test_the_source_check_finds_what_it_should(line, found):
    assert _forbidden_import(line) == found


def test_every_device_parameter_defaults_to_the_card():
    # The port's entry points run on the card unless the caller asks for the
    # CPU: a public function that takes a ``device`` either has no default
    # for it or defaults to "cuda".
    import importlib
    import inspect
    import pkgutil

    import ssl4polyp_tpu_torch

    seen = []
    for info in pkgutil.walk_packages(ssl4polyp_tpu_torch.__path__, "ssl4polyp_tpu_torch."):
        module = importlib.import_module(info.name)
        for name, fn in vars(module).items():
            if name.startswith("_") or getattr(fn, "__module__", None) != info.name:
                continue
            targets = [fn] if inspect.isfunction(fn) else (
                [fn.__init__] if inspect.isclass(fn) and "__init__" in vars(fn) else [])
            for target in targets:
                parameter = inspect.signature(target).parameters.get("device")
                if parameter is not None:
                    seen.append(f"{info.name}.{name}")
                    assert parameter.default in (inspect.Parameter.empty, "cuda"), (
                        f"{info.name}.{name}: device defaults to {parameter.default!r}")
    assert {"ssl4polyp_tpu_torch.models.factory.build_classifier",
            "ssl4polyp_tpu_torch.models.factory.get_mae_backbone",
            "ssl4polyp_tpu_torch.models.factory.get_imagenet_or_random_vit",
            "ssl4polyp_tpu_torch.evaluation.eval_classification.evaluate",
            "ssl4polyp_tpu_torch.training.pretrain.PretrainSettings",
            "ssl4polyp_tpu_torch.training.mae_finetune.run_mae_finetune",
            "ssl4polyp_tpu_torch.training.mae_finetune.run_linear_probe"} <= set(seen)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["run_mae_finetune", "run_linear_probe"])
def test_mae_finetune_engines_refuse_a_classifier_on_another_device(engine, tmp_path):
    import torch

    from ssl4polyp_tpu_torch.models.factory import build_classifier
    from ssl4polyp_tpu_torch.training import mae_finetune

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    on_cpu = build_classifier(torch.Generator().manual_seed(0), {}, device="cpu", img_size=32,
                              patch_size=8, embed_dim=64, depth=1, num_heads=1)
    with pytest.raises(ValueError, match="not on cuda"):
        getattr(mae_finetune, engine)(on_cpu, None, device="cuda")
    on_card = build_classifier(torch.Generator().manual_seed(0), {}, device="cuda", img_size=32,
                               patch_size=8, embed_dim=64, depth=1, num_heads=1)
    with pytest.raises(ValueError, match="not on cpu"):
        getattr(mae_finetune, engine)(on_card, None, device="cpu")


def test_chip_smoke_fails_without_cuda():
    # This machine has no CUDA device: the script must exit non-zero
    # before printing any result.
    result = _run(["chip_smoke.py"])
    assert result.returncode != 0
    assert '"ok": true' not in result.stdout
