"""The standalone eval CLI, the slice as a whole: one checkpoint written by
the JAX package goes through both packages' ``evaluate`` on one pack on the
CPU; checkpoint discovery, filtering and tau resolution case by case."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ssl4polyp_tpu.evaluation import eval_classification as jax_cli
from ssl4polyp_tpu.models.factory import get_imagenet_or_random_vit as jax_vit_factory
from ssl4polyp_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from ssl4polyp_tpu.utils.checkpoint import update_pointer as jax_update_pointer
from ssl4polyp_tpu_torch.evaluation import eval_classification as cli
from tests.conftest import make_image_pack

TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)
MODEL_CFG = dict(TINY, pos_embed="learned", out_token="cls", num_classes=2, pad_tokens_to=0)
# fp32 logits through two blocks on both sides: only summation order and
# fusion differ.
LOGITS_TOL = 1e-4
# The metrics are functions of those logits; with 12 distinct scores no
# ranking or threshold decision moves, so counts and rank metrics are equal
# and the loss moves with the logits.
METRIC_TOL = 1e-6


@pytest.fixture
def trained(tmp_path):
    """A pack with per-row variants and a classifier checkpoint as the JAX
    fine-tune engine writes it: params, a model_cfg and a thresholds block in
    the meta, under its canonical name, with a pointer beside it."""
    packs = tmp_path / "data_packs"
    packs.mkdir()
    make_image_pack(packs, name="sun_full", frames_per_split=12, image_size=32, variant_rows=True)
    classifier = jax_vit_factory(jax.random.PRNGKey(0), None, num_classes=2,
                                 compute_dtype=jnp.float32, **TINY)
    meta = {"epoch": 7, "model_cfg": MODEL_CFG,
            "thresholds": {"primary": {"tau": 0.4375, "policy": "f1_opt_on_val",
                                       "split": "sun_full/val"},
                           "values": {"sun_full_val_f1_opt_on_val": 0.4375,
                                      "sun_full_val_youden_on_val": 0.5625}}}
    run = tmp_path / "run"
    checkpoint = jax_save_checkpoint(run / "SupImnet_SUNFull_s13_e07_valLoss.ckpt",
                                     {"params": classifier.params}, meta)
    jax_update_pointer(run / "SupImnet_SUNFull_s13.ckpt", checkpoint)
    return packs, checkpoint


def _evaluate_both(packs, checkpoint, tmp_path, **kwargs):
    common = dict(pack_root=packs, batch_size=5, image_size=32, num_workers=1,
                  export_outputs=True, **kwargs)
    ours = cli.evaluate(checkpoint, "sun_full", output_dir=tmp_path / "ours", device="cpu",
                        model_overrides={"compute_dtype": torch.float32}, **common)
    ref = jax_cli.evaluate(checkpoint, "sun_full", output_dir=tmp_path / "ref",
                           model_overrides={"compute_dtype": jnp.float32}, **common)
    return ours, ref


@pytest.mark.parametrize("kwargs, tau", [
    ({}, 0.4375),                                                # the stored primary tau
    ({"threshold_key": "sun_full_val_youden_on_val"}, 0.5625),   # a named stored tau
    ({"tau": 0.3}, 0.3),                                         # an explicit tau
])
def test_evaluate_agrees_with_the_jax_cli_on_one_checkpoint_and_pack(trained, tmp_path, kwargs,
                                                                     tau):
    packs, checkpoint = trained
    ours, ref = _evaluate_both(packs, checkpoint, tmp_path, **kwargs)
    assert ours["tau"] == ref["tau"] == tau
    assert ours["n_frames"] == ref["n_frames"] == 12
    assert ours["checkpoint"] == ref["checkpoint"] == str(checkpoint)
    assert sorted(ours) == sorted(ref)
    for key, value in ref.items():
        if isinstance(value, (int, float)):
            np.testing.assert_allclose(ours[key], value, rtol=METRIC_TOL, atol=METRIC_TOL,
                                       err_msg=key)
    # The exported artifacts: the same files, logits to the forward's
    # tolerance, targets, metadata rows and tau equal.
    names = ["eval_results.txt", "logits.npz", "logits.pt", "metadata.jsonl", "tau.json"]
    assert sorted(p.name for p in (tmp_path / "ours").iterdir()) == names
    assert sorted(p.name for p in (tmp_path / "ref").iterdir()) == names
    got, want = np.load(tmp_path / "ours" / "logits.npz"), np.load(tmp_path / "ref" / "logits.npz")
    assert got["logits"].shape == (12, 2) and got["logits"].dtype == want["logits"].dtype
    np.testing.assert_allclose(got["logits"], want["logits"], rtol=LOGITS_TOL, atol=LOGITS_TOL)
    np.testing.assert_array_equal(got["targets"], want["targets"])
    loaded = torch.load(tmp_path / "ours" / "logits.pt", weights_only=True)
    np.testing.assert_array_equal(loaded.numpy(), got["logits"].astype(np.float32))
    for name in ("metadata.jsonl", "tau.json"):
        assert (tmp_path / "ours" / name).read_text() == (tmp_path / "ref" / name).read_text()
    lines = (tmp_path / "ours" / "eval_results.txt").read_text().splitlines()
    assert lines[:2] == [f"checkpoint: {checkpoint}", f"tau: {tau}"]
    assert [line.split(":")[0] for line in lines] == [
        line.split(":")[0] for line in (tmp_path / "ref" / "eval_results.txt").read_text().splitlines()]


def test_tau_from_a_threshold_pack_agrees_with_the_jax_cli(trained, tmp_path):
    # No stored tau (a checkpoint without a thresholds block): both fit the
    # Youden optimum on the threshold pack's val split.
    packs, checkpoint = trained
    bare = jax_save_checkpoint(
        tmp_path / "bare" / "SupImnet_SUNFull_s29.ckpt",
        {"params": cli.load_checkpoint(checkpoint)["payload"]["params"]}, {"model_cfg": MODEL_CFG})
    ours, ref = _evaluate_both(packs, bare, tmp_path, threshold_pack="sun_full")
    assert ours["tau"] == pytest.approx(ref["tau"], abs=LOGITS_TOL) and 0.0 < ours["tau"] < 1.0
    assert ours["n_frames"] == 12 and ours["tp"] == ref["tp"] and ours["fp"] == ref["fp"]


def test_cli_main_discovers_the_checkpoint_and_prints_the_summary(trained, tmp_path, capsys):
    packs, checkpoint = trained
    cli.cli_main([
        "--checkpoint-root", str(checkpoint.parent), "--model-tag", "supimnet", "--seed", "13",
        "--test-pack", "sun_full", "--pack-root", str(packs), "--image-size", "32",
        "--batch-size", "5", "--num-workers", "1", "--device", "cpu",
        "--output-dir", str(tmp_path / "out"), "--export-outputs",
    ])
    summary = json.loads(capsys.readouterr().out)
    # The epoch-tagged file wins over the pointer beside it.
    assert summary["checkpoint"] == str(checkpoint)
    assert summary["n_frames"] == 12 and summary["tau"] == 0.4375
    assert (tmp_path / "out" / "logits.pt").exists()
    with pytest.raises(SystemExit, match="No checkpoint matched"):
        cli.cli_main(["--checkpoint-root", str(checkpoint.parent), "--seed", "99",
                      "--test-pack", "sun_full", "--device", "cpu"])
    with pytest.raises(SystemExit, match="--checkpoint"):
        cli.cli_main(["--test-pack", "sun_full", "--device", "cpu"])


def test_evaluate_on_the_card_needs_a_cuda_device(trained):
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    packs, checkpoint = trained
    with pytest.raises((AssertionError, RuntimeError)):  # no quiet move to the CPU
        cli.evaluate(checkpoint, "sun_full", pack_root=packs, image_size=32)


NAMES = ["SupImnet_SUNFull_s13_e03_valLoss.ckpt", "SupImnet_SUNFull_s29_e05_valLoss.ckpt",
         "SslColon_SUNFull_s13_e02_valLoss.ckpt", "SupImnet_SUNFull_s13.ckpt",
         "SupImnet_PolypGenFew50_fromSUN_s13_s13.ckpt", "SslColon_SUNFull_s47_last.ckpt",
         "notes.ckpt", "checkpoint-3.ckpt"]


@pytest.mark.parametrize("case", [
    ("parse", "SupImnet_SUNFull_s13.ckpt"),
    ("parse", "SslColon_SUNFull_s47_e07_valLoss.ckpt"),
    ("parse", "SupImnet_PolypGenFew50_fromSUN_s13_s13.ckpt"),
    ("parse", "SslColon_SUNFull_s47_last.ckpt"),
    ("parse", "SupImnet_SUNFull_s13_e07_val+Loss.ckpt"),
    ("parse", "checkpoint-3.ckpt"),
    ("parse", "SupImnet_s13.ckpt"),
    ("filter", {}),
    ("filter", {"model_tag": "supimnet"}),
    ("filter", {"model_tag": "SupImnet", "seed": 29}),
    ("filter", {"data_tag": "sunfull", "best_tag": "valloss"}),
    ("filter", {"data_tag": "PolypGenFew50"}),
    ("filter", {"seed": 99}),
    ("tau", {}),
    ("tau", {"explicit_tau": 0.25}),
    ("tau", {"threshold_key": "sun_full_val_youden_on_val"}),
    ("tau", {"threshold_key": "absent_key"}),
    ("tau-sidecar", {}),
    ("tau-metrics-json", {}),
    ("tau-none", {}),
], ids=lambda case: f"{case[0]}-{case[1]}")
def test_discovery_filters_and_tau_resolution_equal_the_jax_clis(tmp_path, case):
    kind, arg = case

    def both(fn):
        results = []
        for module in (cli, jax_cli):
            try:
                results.append(("ok", fn(module)))
            except KeyError as exc:
                results.append(("KeyError", str(exc)))
        assert results[0] == results[1]
        return results[0]

    if kind == "parse":
        info = both(lambda m: (lambda i: i and (i.model_tag, i.data_tag, i.seed, i.epoch,
                                                i.selection_tag, i.is_pointer, i.stem))(
            m.parse_checkpoint_name(tmp_path / arg)))[1]
        assert (info is None) == (arg in ("checkpoint-3.ckpt", "SupImnet_s13.ckpt"))
    elif kind == "filter":
        for name in NAMES:
            (tmp_path / "nested").mkdir(exist_ok=True)
            (tmp_path / ("nested" if "Ssl" in name else "") / name).touch()
            (tmp_path / (name + ".json")).touch()  # sidecars are not checkpoints
        found = both(lambda m: [c.path.name for c in m.filter_candidates(
            m.discover_checkpoints(tmp_path), **arg)])[1]
        assert set(found) <= set(NAMES) - {"notes.ckpt", "checkpoint-3.ckpt"}
        assert bool(found) == (arg.get("seed") != 99)
    else:
        path = tmp_path / "SupImnet_SUNFull_s13.ckpt"
        values = {"sun_full_val_youden_on_val": 0.5625, "a_first_key": 0.125}
        if kind == "tau":
            jax_save_checkpoint(path, {"params": {"w": np.ones(2)}},
                                {"thresholds": {"primary": {"tau": 0.4375}, "values": values}})
        else:
            jax_save_checkpoint(path, {"params": {"w": np.ones(2)}}, {"epoch": 1})
        if kind == "tau-sidecar":
            (tmp_path / "SupImnet_SUNFull_s13.thresholds.json").write_text(
                json.dumps({"thresholds": values}))
        if kind == "tau-metrics-json":
            (tmp_path / "SupImnet_SUNFull_s13_last.metrics.json").write_text(
                json.dumps({"thresholds": {"primary": {"tau": 0.3125}, "values": values}}))
        status, tau = both(lambda m: m.resolve_tau(path, **arg))
        expected = {"tau": {(): 0.4375, ("explicit_tau",): 0.25, ("threshold_key",): 0.5625},
                    "tau-sidecar": {(): 0.125}, "tau-metrics-json": {(): 0.3125},
                    "tau-none": {(): None}}[kind]
        if arg.get("threshold_key") == "absent_key":
            assert status == "KeyError" and "absent_key" in tau
        else:
            assert status == "ok" and tau == expected[tuple(arg)]
