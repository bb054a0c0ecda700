"""The port imports and runs (an eval forward, a pretrain step, a fine-tune
step, a split evaluation and the standalone eval CLI's ``evaluate``) without
jax, flax, msgpack, scikit-learn or the JAX package itself (the GPU machine
lacks jax and flax), and imports without PyYAML and PIL (which only the
manifest and frame readers import, where they open a file); no source of the
port imports the forbidden ones, every ``device`` parameter defaults to the
card, and chip_smoke.py refuses to run without CUDA."""

import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_BLOCKED_SCRIPT = """
import sys
for name in ("jax", "flax", "msgpack", "yaml", "PIL", "sklearn", "ssl4polyp_tpu"):
    sys.modules[name] = None  # any import of them raises ImportError

import importlib, pkgutil
import numpy as np, torch
import ssl4polyp_tpu_torch

modules = [m.name for m in pkgutil.walk_packages(ssl4polyp_tpu_torch.__path__, "ssl4polyp_tpu_torch.")]
for name in modules:
    importlib.import_module(name)
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
ctx = classification.TrainContext(clf, *classification.loss_settings([3, 1]), weight_decay=0.05)
state = classification.init_train_state(clf, torch.Generator().manual_seed(2))
scales = optim.finetune_lr_scales(state.params, "head+1", 2)
metrics = classification.make_train_step(ctx)(
    state, batch[0], torch.tensor([0, 1]), torch.tensor([True, True]), 1e-4, scales,
    optim.no_weight_decay_scales(state.params))
assert all(bool(torch.isfinite(v)) for v in metrics.values()), metrics

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
    summary = evaluate(ckpt, pack, batch_size=4, image_size=32, num_workers=1, device="cpu",
                       output_dir=Path(tmp) / "eval", export_outputs=True)
    assert summary["n_frames"] == 6 and summary["tau"] == 0.25 and np.isfinite(summary["loss"])
    assert (Path(tmp) / "eval" / "logits.pt").exists()

leaked = sorted(m for m in sys.modules
                if (m == "ssl4polyp_tpu" or m.startswith("ssl4polyp_tpu."))
                and sys.modules[m] is not None)
assert not leaked, leaked
print("ok", len(modules))
"""


def _run(args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_and_runs_with_the_jax_stack_blocked():
    result = _run(["-c", _BLOCKED_SCRIPT])
    assert result.returncode == 0, result.stderr
    assert result.stdout.startswith("ok")
    assert int(result.stdout.split()[1]) >= 38  # every slice module was imported


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
    sources = [*(ROOT / "ssl4polyp_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]
    assert len(sources) > 45
    names = {path.relative_to(ROOT).as_posix() for path in sources}
    assert {"ssl4polyp_tpu_torch/utils/msgpack.py", "ssl4polyp_tpu_torch/utils/checkpoint.py",
            "ssl4polyp_tpu_torch/evaluation/eval_classification.py",
            "ssl4polyp_tpu_torch/ops/attention.py",
            "ssl4polyp_tpu_torch/ops/attention_block.py"} <= names
    for path in sources:
        for line in path.read_text().splitlines():
            assert _forbidden_import(line) is None, f"{path}: {line}"


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
            "ssl4polyp_tpu_torch.evaluation.eval_classification.evaluate"} <= set(seen)


def test_chip_smoke_fails_without_cuda():
    # This machine has no CUDA device: the script must exit non-zero
    # before printing any result.
    result = _run(["chip_smoke.py"])
    assert result.returncode != 0
    assert '"ok": true' not in result.stdout
