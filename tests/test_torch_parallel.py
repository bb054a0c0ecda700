"""The port's data-parallel path on the CPU, against the JAX package.

Each group of ranks is started as ``torchrun`` starts one (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``): every rank a fresh interpreter that imports torch and the
port, joins a gloo group through ``initialize_multihost`` and runs one
``_rank_*`` function of this module, whose result comes back pickled.  A
group that has not ended within ``GROUP_TIMEOUT_S`` is killed and fails its
test.  The module imports no JAX at its top, so that a rank starts in
seconds; the tests import the JAX package where they compare with it.

* the loaders' stripes equal the JAX loaders' for every listed
  ``(process_index, process_count)``;
* one two-rank fine-tune step equals the JAX step over ``build_mesh(data=2)``
  on the global batch the two stripes make (the last row invalid), with the
  augmentation draws handed over, and leaves both ranks' masters equal bit
  for bit;
* the gathered ``evaluate_split`` of two ranks equals the JAX one on the
  concatenated arrays and the port's one-process run, frame order included;
* the fine-tune engine and the eval CLI through their CLIs on two ranks:
  rank 1 writes nothing, the files are a one-rank run's, tau, the best epoch
  and the test frames agree on both ranks, and steps 1 and 2 (the second
  with an invalid padded row) equal one process on the gathered batch;
* the pretraining engine on two ranks, ``accum_iter`` 2: its masters equal
  a one-process run on the gathered batches, and only rank 0 saves.
"""

import json
import os
import pickle
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
# A group of ranks that has not ended by then is killed: a hang fails one
# test instead of running the suite into its time limit.
GROUP_TIMEOUT_S = 120
TINY_VIT = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)
STEP_LR = 5e-4
# fp32 on the CPU: two ranks' sums of their rows against one sum of all of
# them differ in the order of additions alone (and gloo's sum of the two).
GATHER_RTOL = 1e-5

_RANK_MAIN = """
import importlib, os, pickle, sys
sys.modules["torch.utils.tensorboard"] = None  # seconds of TensorFlow; RunLogger falls back
import torch
torch.set_num_threads(2)
module, _, name = sys.argv[1].partition(":")
result = getattr(importlib.import_module(module), name)(*sys.argv[3:])
with open(os.path.join(sys.argv[2], "rank%s.pkl" % os.environ["RANK"]), "wb") as handle:
    pickle.dump(result, handle)
"""


def _free_port() -> int:
    with socket.socket() as probe:
        probe.bind(("127.0.0.1", 0))
        return probe.getsockname()[1]


def run_ranks(target: str, out_dir: Path, *args, world: int = 2) -> list:
    """Run ``target`` (``module:function``) as ``world`` ranks of one group
    and return each rank's result, rank 0 first."""
    out_dir.mkdir(parents=True, exist_ok=True)
    port = _free_port()
    procs, logs = [], []
    try:
        for rank in range(world):
            env = {**os.environ, "RANK": str(rank), "WORLD_SIZE": str(world),
                   "LOCAL_RANK": str(rank), "LOCAL_WORLD_SIZE": str(world),
                   "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                   "PYTHONPATH": os.pathsep.join(filter(None, [str(ROOT),
                                                               os.environ.get("PYTHONPATH")]))}
            logs.append(open(out_dir / f"rank{rank}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _RANK_MAIN, target, str(out_dir), *map(str, args)],
                cwd=ROOT, env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + GROUP_TIMEOUT_S
        for proc in procs:
            try:
                proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pytest.fail(f"{target}: {world} ranks still ran after {GROUP_TIMEOUT_S} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    for rank, proc in enumerate(procs):
        assert proc.returncode == 0, (f"rank {rank} of {target}: exit {proc.returncode}\n"
                                      + (out_dir / f"rank{rank}.log").read_text()[-4000:])
    return [pickle.loads((out_dir / f"rank{rank}.pkl").read_bytes()) for rank in range(world)]


def _relative_l2(got: np.ndarray, want: np.ndarray, name: str) -> float:
    """The relative L2 distance; the K slice of a qkv bias is left out (its
    exact gradient is zero, so both sides hold rounding noise there)."""
    if name.endswith("attn.qkv.bias"):
        d = got.shape[0] // 3
        got, want = (np.concatenate([a[:d], a[2 * d:]]) for a in (got, want))
    return float(np.linalg.norm(got - want) / max(1e-2, float(np.linalg.norm(want))))


# ---------------------------------------------------------------------------
# The loaders' stripes
# ---------------------------------------------------------------------------

STRIPES = [(0, 1), (0, 2), (1, 2), (2, 3)]


class _Frames:
    """A split of ``n`` frames, as far as the loaders' orders read it."""

    def __init__(self, n: int) -> None:
        self.paths = [f"frame_{i:03d}.jpg" for i in range(n)]
        self.stage, self.perturbations_enabled = "test", False

    def __len__(self) -> int:
        return len(self.paths)


@pytest.mark.parametrize("n", [12, 13])  # divisible by 2 and 3, and not
@pytest.mark.parametrize("index,count", STRIPES)
def test_pretrain_loader_stripes_match_jax(n, index, count):
    from ssl4polyp_tpu.data.folder import PretrainLoader as JaxPretrainLoader
    from ssl4polyp_tpu_torch.data.folder import PretrainLoader

    for epoch in (0, 3):
        for drop_last in (True, False):
            ours = PretrainLoader(_Frames(n), 2, seed=7, process_index=index,
                                  process_count=count, drop_last=drop_last)
            ref = JaxPretrainLoader(_Frames(n), 2, seed=7, process_index=index,
                                    process_count=count, drop_last=drop_last, use_native=False)
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            np.testing.assert_array_equal(ours._order(), ref._order())
            assert len(ours) == len(ref)


@pytest.mark.parametrize("n", [12, 13])
@pytest.mark.parametrize("index,count", STRIPES)
def test_host_loader_stripes_match_jax(n, index, count):
    from ssl4polyp_tpu.data import HostDataLoader as JaxHostDataLoader
    from ssl4polyp_tpu_torch.data.loader import HostDataLoader

    for shuffle in (True, False):
        ours = HostDataLoader(_Frames(n), 4, shuffle=shuffle, seed=3, process_index=index,
                              process_count=count)
        ref = JaxHostDataLoader(_Frames(n), 4, shuffle=shuffle, seed=3, process_index=index,
                                process_count=count, use_native=False)
        for epoch in (0, 2):
            ours.set_epoch(epoch)
            ref.set_epoch(epoch)
            for got, want in zip(ours._epoch_order(), ref._epoch_order()):
                np.testing.assert_array_equal(got, want)
            assert len(ours) == len(ref)


# ---------------------------------------------------------------------------
# One fine-tune step on two ranks against the JAX data=2 mesh step
# ---------------------------------------------------------------------------

def _rank_step(params_path: str, batch_path: str):
    from ssl4polyp_tpu_torch.data.augment import draw_augment_params
    from ssl4polyp_tpu_torch.models.factory import build_classifier
    from ssl4polyp_tpu_torch.parallel import initialize_multihost, process_index, shard_batch
    from ssl4polyp_tpu_torch.training import classification, optim
    from ssl4polyp_tpu_torch.utils.checkpoint import load_checkpoint

    initialize_multihost()
    rank = process_index()
    params = load_checkpoint(params_path)["payload"]["params"]
    batch = shard_batch(dict(np.load(batch_path)))
    ours = build_classifier(torch.Generator().manual_seed(0), {}, jax_params=params, device="cpu",
                            compute_dtype=torch.float32, **TINY_VIT)
    ctx = classification.step_context(ours, *classification.loss_settings([40, 20]),
                                      weight_decay=0.05)
    state = classification.init_train_state(ours, torch.Generator().manual_seed(100 + rank))
    replay = torch.Generator()
    replay.set_state(state.generator.get_state())  # the draw the step is about to make
    draws = {k: v.numpy() for k, v in draw_augment_params(len(batch["labels"]),
                                                          replay)._asdict().items()}
    named = dict(state.params)
    metrics = classification.make_train_step(ctx)(
        state, torch.from_numpy(batch["images"]), torch.from_numpy(batch["labels"]),
        torch.from_numpy(batch["valid"]), STEP_LR,
        optim.finetune_lr_scales(named, "full", TINY_VIT["depth"]),
        optim.no_weight_decay_scales(named))
    return {"loss": metrics["loss"].item(), "grad_norm": metrics["grad_norm"].item(),
            "draws": draws, "params": {n: t.numpy().copy() for n, t in state.params.items()}}


def test_two_rank_step_matches_the_jax_data2_mesh_step(tmp_path, monkeypatch):
    from types import SimpleNamespace

    import jax
    import jax.numpy as jnp

    from ssl4polyp_tpu.models import factory as jax_factory
    from ssl4polyp_tpu.parallel.mesh import build_mesh
    from ssl4polyp_tpu.training import classification as jax_classification
    from ssl4polyp_tpu.training import optim as jax_optim
    from ssl4polyp_tpu_torch.models.vit import ViTConfig
    from ssl4polyp_tpu_torch.models.weights import state_dict_from_jax
    from ssl4polyp_tpu_torch.training.classification import loss_settings
    from ssl4polyp_tpu_torch.utils.checkpoint import save_checkpoint
    from tests.test_torch_finetune import LOSS_RTOL, TRAJECTORY_RTOL, _jax_augment

    jax_clf = jax_factory.get_imagenet_or_random_vit(jax.random.PRNGKey(0),
                                                     compute_dtype=jnp.float32, **TINY_VIT)
    params = jax.tree_util.tree_map(np.asarray, jax_clf.params)
    save_checkpoint(tmp_path / "params.ckpt", {"params": params})
    rng = np.random.default_rng(5)
    images = rng.integers(0, 256, (8, 32, 32, 3), dtype=np.uint8)
    labels = np.array([0, 1, 1, 0, 1, 0, 0, 1])
    valid = np.arange(8) < 7  # rank 1's last row
    np.savez(tmp_path / "batch.npz", images=images, labels=labels, valid=valid)
    ranks = run_ranks("tests.test_torch_parallel:_rank_step", tmp_path / "ranks",
                      tmp_path / "params.ckpt", tmp_path / "batch.npz")

    # The ranks' draws, rank 0's rows first, through the JAX chain outside
    # the jitted step: inside it XLA fuses the rotation's coordinates
    # otherwise, and a floor that flips moves a sample by a pixel.
    draws = {k: np.concatenate([r["draws"][k] for r in ranks]) for k in ranks[0]["draws"]}
    augmented = np.asarray(_jax_augment(images, draws))
    monkeypatch.setattr(jax_classification, "augment_batch",
                        lambda images_u8, key, dtype=jnp.float32: jnp.asarray(augmented, dtype))
    mode, pos_weight, class_weights = loss_settings([40, 20])
    ctx = SimpleNamespace(classifier=jax_clf, loss_mode=mode, pos_weight=pos_weight,
                          class_weights=class_weights, plan=SimpleNamespace(weight_decay=0.05),
                          mesh=build_mesh(data=2))
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    new, _, metrics = jax_classification.make_train_step(ctx)(
        jparams, jax_optim.adamw_init(jparams), images, labels, valid, jax.random.PRNGKey(0),
        STEP_LR, jax_optim.finetune_lr_scales(jparams, "full", TINY_VIT["depth"]),
        jax_optim.no_weight_decay_scales(jparams))

    for r in ranks:
        np.testing.assert_allclose(r["loss"], float(metrics["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(r["grad_norm"], float(metrics["grad_norm"]),
                                   rtol=TRAJECTORY_RTOL)
    cfg = ViTConfig(compute_dtype=torch.float32, num_classes=2, **TINY_VIT)
    want = {k: v.numpy() for k, v in state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, new), cfg).items()}
    assert set(ranks[0]["params"]) == set(want)
    for name, got in ranks[0]["params"].items():
        assert got.tobytes() == ranks[1]["params"][name].tobytes(), name
        dist = _relative_l2(got, want[name], name)
        assert dist <= TRAJECTORY_RTOL, f"{name}: relative L2 distance {dist:.2e}"


# ---------------------------------------------------------------------------
# The gathered evaluation
# ---------------------------------------------------------------------------

EVAL_KWARGS = dict(split_name="test", morphology_eval=("polypoid", "flat"),
                   perturbation_eval=True, pos_weight=1.5)


def _logits_of(images: np.ndarray) -> np.ndarray:
    """Logits that are a function of each row alone, whatever the batch."""
    x = images.reshape(len(images), -1).astype(np.float64) / 255.0
    z = x.mean(axis=1) - 0.5 + 0.3 * x[:, :7].sum(axis=1)
    return np.stack([-z, z], axis=1).astype(np.float32)


def _rank_gathered_eval(pack_root: str):
    from ssl4polyp_tpu_torch.data.loader import HostDataLoader
    from ssl4polyp_tpu_torch.data.packs import create_classification_datasets
    from ssl4polyp_tpu_torch.evaluation.evaluate import evaluate_split
    from ssl4polyp_tpu_torch.parallel import initialize_multihost, process_count, process_index

    initialize_multihost()
    index = create_classification_datasets(test_spec="sun_full", pack_root=Path(pack_root),
                                           image_size=16)["test"]
    batches = list(HostDataLoader(index, 3, shuffle=False, drop_last=False, num_workers=1,
                                  process_index=process_index(), process_count=process_count()))
    results = evaluate_split(lambda images: _logits_of(images), batches, index, **EVAL_KWARGS)
    for batch in batches:
        batch["image"] = _logits_of(batch["image"])
    return {"results": results, "batches": batches}


def test_gathered_evaluation_matches_jax_and_one_process(tmp_path):
    from ssl4polyp_tpu.evaluation.evaluate import evaluate_split as jax_evaluate_split
    from ssl4polyp_tpu_torch.data.loader import HostDataLoader
    from ssl4polyp_tpu_torch.data.packs import create_classification_datasets
    from ssl4polyp_tpu_torch.evaluation.evaluate import evaluate_split
    from tests.conftest import make_image_pack
    from tests.test_torch_eval import _assert_close

    make_image_pack(tmp_path / "packs", name="sun_full", frames_per_split=11, image_size=16)
    ranks = run_ranks("tests.test_torch_parallel:_rank_gathered_eval", tmp_path / "ranks",
                      tmp_path / "packs")
    index = create_classification_datasets(test_spec="sun_full", pack_root=tmp_path / "packs",
                                           image_size=16)["test"]
    one = evaluate_split(lambda images: _logits_of(images),
                         HostDataLoader(index, 3, shuffle=False, drop_last=False, num_workers=1),
                         index, **EVAL_KWARGS)
    # Rank 0's stripe, then rank 1's, the padded row last: the JAX split
    # evaluation of the concatenated arrays.
    cat = {key: np.concatenate([b[key] for r in ranks for b in r["batches"]])
           for key in ranks[0]["batches"][0]}
    assert not cat["valid"][-1] and cat["valid"][:-1].all()
    ref = jax_evaluate_split(lambda x: x, [cat], index, **EVAL_KWARGS)
    frames = [row["frame_id"] for row in one["metadata_rows"]]
    assert frames == [row["frame_id"] for row in index.meta]  # the one-process order
    for rank in ranks:
        ours = rank["results"]
        assert [row["frame_id"] for row in ours["metadata_rows"]] == frames
        _assert_close(ours, one, tol=0.0)
        _assert_close(ours, ref, tol=1e-9)
        assert list(ours) == list(ref)


# ---------------------------------------------------------------------------
# The fine-tune engine and the eval CLI through their CLIs
# ---------------------------------------------------------------------------

ENGINE_FRAMES = {"train": 7, "val": 9, "test": 9}  # 7: rank 1's last train batch padded
ENGINE_STEPS_CAPTURED = 2


def _engine_argv(packs: Path, out: Path) -> list:
    return ["--exp-config", "exp/exp2", "--model-key", "ssl_colon", "--seed", "47",
            "--pack-root", str(packs), "--output-dir", str(out / "run"),
            "--thresholds-root", str(out / "th"), "--device", "cpu",
            "--override", "epochs=1", "--override", "batch_size=4", "--override", "image_size=32",
            "--override", "num_workers=1", "--override", "amp=false"]


def _tiny_factory(engine) -> None:
    """The CLI has no width flag: a tiny ViT through the engine's factory."""
    build = engine.build_classifier
    engine.build_classifier = lambda *a, **kw: build(
        *a, **{**kw, "embed_dim": 64, "depth": 2, "num_heads": 4, "patch_size": 8})


def _eval_argv(summary: dict, packs: Path, out: Path) -> list:
    best = Path(summary["metrics_path"]).parent / f"{summary['stem']}.ckpt"
    return ["--checkpoint", str(best), "--test-pack", "sun_full", "--pack-root", str(packs),
            "--batch-size", "4", "--image-size", "32", "--output-dir", str(out / "eval"),
            "--export-outputs", "--num-workers", "1", "--device", "cpu"]


def _rank_engine(packs: str, out: str):
    from unittest import mock

    from chip_smoke import StepCapture, watch_writes
    from ssl4polyp_tpu_torch.evaluation import eval_classification, exports
    from ssl4polyp_tpu_torch.training import classification

    packs, out = Path(packs), Path(out)
    rank = int(os.environ["RANK"])
    writes = watch_writes([out]) if rank else []
    _tiny_factory(classification)
    exported = []
    export = exports.export_frame_outputs

    def recording_export(path, **kwargs):
        exported.append((Path(path).name, [row["frame_id"] for row in kwargs["metadata_rows"]]))
        return export(path, **kwargs)

    with StepCapture(classification, ENGINE_STEPS_CAPTURED, torch.device("cpu")) as capture, \
            mock.patch.object(exports, "export_frame_outputs", recording_export):
        summary = classification.cli_main(_engine_argv(packs, out))
    errors = capture.gathered_errors()
    eval_classification.cli_main(_eval_argv(summary, packs, out))
    return {"summary": {k: v for k, v in summary.items() if k not in ("payload", "timings")},
            "saves": summary["timings"]["saves"], "writes": list(writes), "errors": errors,
            "exported": exported, "steps": len(capture.step_s),
            "valid": [r["batch"]["valid"] for r in capture.records]}


def _files(root: Path) -> list:
    """The files under ``root``; a TensorBoard event file's name holds its
    host, process and time, so only its prefix counts."""
    names = (p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())
    return sorted(name.split("events.out.tfevents.")[0] + "events.out.tfevents.*"
                  if "events.out.tfevents." in name else name for name in names)


def test_finetune_engine_and_eval_cli_on_two_ranks(tmp_path, monkeypatch, capsys):
    from ssl4polyp_tpu_torch.evaluation import eval_classification
    from ssl4polyp_tpu_torch.polypdb.synth import build_synthetic_pack
    from ssl4polyp_tpu_torch.training import classification

    packs = tmp_path / "data_packs"
    build_synthetic_pack(packs, name="sun_full", frames_per_split=ENGINE_FRAMES, image_size=32)
    two = tmp_path / "two"
    ranks = run_ranks("tests.test_torch_parallel:_rank_engine", tmp_path / "ranks", packs, two)

    # One rank, in this process, into another directory.
    one = tmp_path / "one"
    monkeypatch.setattr(classification, "build_classifier", classification.build_classifier)
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)  # as in the ranks
    _tiny_factory(classification)
    summary = classification.cli_main(_engine_argv(packs, one))
    eval_classification.cli_main(_eval_argv(summary, packs, one))
    # and the eval CLI in one process on the two ranks' checkpoint
    eval_classification.cli_main(_eval_argv(ranks[0]["summary"], packs, tmp_path / "two_one"))
    capsys.readouterr()

    assert ranks[1]["writes"] == [] and ranks[1]["saves"] == []
    assert ranks[0]["saves"] and _files(two) == _files(one)
    assert ranks[0]["summary"] == ranks[1]["summary"]  # tau, epochs, best monitor, AUROC
    assert ranks[0]["summary"]["tau"] is not None
    payload = json.loads(Path(ranks[0]["summary"]["metrics_path"]).read_text())
    assert payload["run"]["world_size"] == 2 and ranks[0]["steps"] == 2  # 1 epoch of 2
    # The test frames: the same on both ranks, in the one-rank run's order.
    test_csv = f"{summary['stem']}_test_outputs.csv"
    one_frames = [line.split(",")[0] for line in
                  (Path(summary["metrics_path"]).parent / test_csv).read_text().splitlines()[1:]]
    for rank in ranks:
        assert dict(rank["exported"])[test_csv] == one_frames
    # The two ranks' eval CLI against one process's on the same checkpoint.
    two_eval, one_eval = two / "eval", tmp_path / "two_one" / "eval"
    assert (two_eval / "metadata.jsonl").read_text() == (one_eval / "metadata.jsonl").read_text()
    np.testing.assert_allclose(np.load(two_eval / "logits.npz")["logits"],
                               np.load(one_eval / "logits.npz")["logits"], rtol=0, atol=1e-6)
    # Steps 1 and 2 against one process on the gathered batch; step 2 holds
    # rank 1's padded row, which only the global valid count normalises right.
    assert ranks[1]["errors"] is None and len(ranks[0]["errors"]) == ENGINE_STEPS_CAPTURED
    assert [v.all() for v in ranks[1]["valid"]] == [True, False]
    for error in ranks[0]["errors"]:
        assert error["loss_rel"] <= GATHER_RTOL, error
        assert error["grad_rel"] <= GATHER_RTOL, error


# ---------------------------------------------------------------------------
# The pretraining engine
# ---------------------------------------------------------------------------

PRETRAIN = dict(epochs=1, warmup_epochs=1, batch_size=4, accum_iter=2, image_size=32,
                num_workers=1, log_interval=1, save_freq_epochs=1, keep_last=2,
                keep_every_n_epochs=None, no_train_dir=True, precision="fp32", seed=5,
                limit_steps_per_epoch=2, device="cpu")


def _tiny_mae(pretrain):
    from ssl4polyp_tpu_torch.models.mae import MAEConfig
    from ssl4polyp_tpu_torch.models.vit import ViTConfig

    tiny = MAEConfig(encoder=ViTConfig(compute_dtype=torch.float32, img_size=32, patch_size=8,
                                       embed_dim=32, depth=2, num_heads=2),
                     decoder_embed_dim=16, decoder_depth=1, decoder_num_heads=2)
    pretrain.model_config = lambda settings: tiny
    return tiny


def _rank_pretrain(frames: str, out: str):
    from chip_smoke import watch_writes
    from ssl4polyp_tpu_torch.parallel import initialize_multihost
    from ssl4polyp_tpu_torch.training import pretrain

    initialize_multihost()
    rank = int(os.environ["RANK"])
    writes = watch_writes([out]) if rank else []
    _tiny_mae(pretrain)
    settings = pretrain.PretrainSettings(data_root=frames, output_dir=out, **PRETRAIN)
    summary = pretrain.run_pretraining(settings)
    return {"summary": summary, "writes": list(writes)}


def test_pretraining_engine_on_two_ranks(tmp_path, monkeypatch):
    from PIL import Image

    from ssl4polyp_tpu_torch.data.folder import ImageFolderIndex, PretrainLoader
    from ssl4polyp_tpu_torch.models.weights import mae_state_dict_from_jax
    from ssl4polyp_tpu_torch.training import pretrain
    from ssl4polyp_tpu_torch.utils.checkpoint import load_checkpoint

    frames = tmp_path / "frames"
    frames.mkdir()
    rng = np.random.default_rng(0)
    for i in range(19):  # 2 steps of 8 and a rest: stripes of 10, one padded
        Image.fromarray(rng.integers(0, 255, (40, 40, 3), dtype=np.uint8)).save(
            frames / f"frame_{i:03d}.jpg", quality=90)
    ranks = run_ranks("tests.test_torch_parallel:_rank_pretrain", tmp_path / "ranks", frames,
                      tmp_path / "two")
    assert ranks[1]["writes"] == []
    assert ranks[0]["summary"]["train_loss"] == ranks[1]["summary"]["train_loss"]
    assert sorted(p.name for p in (tmp_path / "two" / "ckpts").iterdir()) == [
        "checkpoint-0.ckpt", "checkpoint-0.ckpt.json", "last.ckpt"]

    # One process on the gathered batches: each step's rows are microbatch
    # 0 of rank 0, of rank 1, then microbatch 1 of each (the noise's order).
    index = ImageFolderIndex(frames, no_train_dir=True)
    stripes = [iter(PretrainLoader(index, 4, image_size=32, seed=5, num_workers=1,
                                   process_index=r, process_count=2)) for r in range(2)]
    gathered = []
    for _ in range(2):
        parts = [next(s).reshape(2, 2, 32, 32, 3) for s in stripes]
        gathered.append(np.concatenate(parts, axis=1).reshape(8, 32, 32, 3))

    class Gathered:
        def __init__(self, *args, **kwargs):
            pass

        def set_epoch(self, epoch):
            pass

        def __len__(self):
            return len(gathered)

        def __iter__(self):
            yield from gathered

    monkeypatch.setattr(pretrain, "PretrainLoader", Gathered)
    monkeypatch.setattr(pretrain, "model_config", pretrain.model_config)
    tiny = _tiny_mae(pretrain)
    pretrain.run_pretraining(pretrain.PretrainSettings(
        data_root=str(frames), output_dir=str(tmp_path / "one"),
        **{**PRETRAIN, "async_checkpoint": False}))
    two = load_checkpoint(tmp_path / "two" / "ckpts" / "last.ckpt")["payload"]
    one = load_checkpoint(tmp_path / "one" / "ckpts" / "last.ckpt")["payload"]
    assert int(two["opt"]["step"]) == int(one["opt"]["step"]) == 2
    named_two, named_one = (mae_state_dict_from_jax(payload["params"], tiny)
                            for payload in (two, one))
    assert named_two.keys() == named_one.keys()
    for name, got in named_two.items():
        dist = _relative_l2(got.numpy(), named_one[name].numpy(), name)
        assert dist <= GATHER_RTOL, f"{name}: relative L2 distance {dist:.2e}"
