"""The port's weight-file readers and the factory's file branches against the
JAX package's, on files written here from a numpy seed.

* Readers (``models/pth_reader.py``): each reading test of
  ``tests/test_pth_reader.py`` through both readers, on files that
  ``torch.save`` and the JAX ``pth_writer.write_pt`` write: the two give
  equal trees bit for bit, and refuse the same globals.
* Mapping (``models/import_torch.py``): ``mae_params_from_torch`` and
  ``vit_params_from_augreg_npz`` of both packages give equal trees, bit for
  bit, on one file.
* AugReg cache (``models/augreg_cache.py``): ``tests/test_fetch_augreg.py``
  through the port.
* Factory: ``build_classifier`` on ``config/model/{sup_imnet,ssl_imnet,
  ssl_colon}.yaml`` with each named file present and absent, its logits
  against the JAX ``build_classifier(...).apply`` with the JAX head copied
  in.  A tiny ViT (img 32, patch 8, D 64, depth 2, 4 heads).
"""

import argparse
import ast
import collections
import os
import pickle
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import chip_smoke
from ssl4polyp_tpu.models import factory as jax_factory
from ssl4polyp_tpu.models import import_torch as jax_import
from ssl4polyp_tpu.models import pth_reader as jax_reader
from ssl4polyp_tpu.models.pth_writer import write_pt as jax_write_pt
from ssl4polyp_tpu.models.vit import ViTConfig as JaxViTConfig
from ssl4polyp_tpu_torch.models import augreg_cache, factory, import_torch, pth_reader
from ssl4polyp_tpu_torch.models.mae import MAEConfig, encoder_only
from ssl4polyp_tpu_torch.models.vit import ViTConfig
from ssl4polyp_tpu_torch.models.weights import state_dict_from_jax
from ssl4polyp_tpu_torch.utils.checkpoint import save_checkpoint

ROOT = Path(__file__).resolve().parents[1]
TINY = dict(img_size=32, patch_size=8, embed_dim=64, depth=2, num_heads=4)
# Logits of the two factories' models on one tree: fp32 differs by summation
# order and the JAX GELU's polynomial erf through two blocks; bf16 by a few
# bf16 ulps (2^-8 relative) at logits of magnitude ~1-3, as in
# tests/test_torch_vit.py.
TOL = {"fp32": 1e-4, "bf16": 5e-2}


def tiny_mae_cfg() -> MAEConfig:
    return MAEConfig(encoder=ViTConfig(**TINY), decoder_embed_dim=32, decoder_depth=1,
                     decoder_num_heads=2)


def as_float32(value) -> np.ndarray:
    """A leaf of either reader as fp32 numpy: the port's bf16 tensors and
    the JAX reader's ml_dtypes bf16 arrays both cast exactly."""
    if isinstance(value, torch.Tensor):
        return value.float().numpy()
    return np.asarray(value).astype(np.float32)


def assert_same_tree(ours, theirs, path="") -> None:
    """Equal nested containers, every array leaf equal bit for bit (bf16
    leaves through their exact fp32 values), every other leaf equal."""
    if isinstance(theirs, dict):
        assert isinstance(ours, dict) and set(ours) == set(theirs), path
        for key in theirs:
            assert_same_tree(ours[key], theirs[key], f"{path}/{key}")
    elif isinstance(theirs, (list, tuple)):
        assert type(ours) is type(theirs) and len(ours) == len(theirs), path
        for i, (a, b) in enumerate(zip(ours, theirs)):
            assert_same_tree(a, b, f"{path}/{i}")
    elif isinstance(theirs, argparse.Namespace):
        assert_same_tree(vars(ours), vars(theirs), path)
    elif isinstance(theirs, np.ndarray):
        if theirs.dtype.name == "bfloat16":
            assert isinstance(ours, torch.Tensor) and ours.dtype == torch.bfloat16, path
        else:
            assert isinstance(ours, np.ndarray) and ours.dtype == theirs.dtype, path
        assert ours.shape == theirs.shape, path
        got, want = (as_float32(ours), as_float32(theirs)) if theirs.dtype.name == "bfloat16" \
            else (ours, theirs)
        assert got.tobytes() == want.tobytes(), path
    else:
        assert ours == theirs, path


def state_dict():
    gen = torch.Generator().manual_seed(0)
    return {
        "weight": torch.randn(4, 3, generator=gen),
        "bias": torch.randn(4, generator=gen),
        "embed": torch.randn(2, 5, 6, generator=gen, dtype=torch.float64),
        "counts": torch.arange(7, dtype=torch.int64),
        "flag": torch.tensor(True),
        "half": torch.randn(3, 3, generator=gen).to(torch.float16),
        "bf16": torch.randn(3, 3, generator=gen).to(torch.bfloat16),
    }


def read_both(path, key="model"):
    """(port, JAX) state dicts of one file."""
    return pth_reader.read_pth_state_dict(path, key=key), \
        jax_reader.read_pth_state_dict(path, key=key)


# ---------------------------------------------------------------------------
# Readers
# ---------------------------------------------------------------------------

def test_zip_format_roundtrip(tmp_path):
    state = state_dict()
    path = tmp_path / "ckpt.pth"
    torch.save({"model": state, "epoch": 3}, str(path))
    ours, theirs = read_both(path)
    assert_same_tree(ours, theirs)
    for name, tensor in state.items():
        np.testing.assert_array_equal(as_float32(ours[name]), tensor.float().numpy())
    assert ours["bf16"].dtype == torch.bfloat16 and isinstance(ours["weight"], np.ndarray)
    full = pth_reader.read_pth(path)
    assert full["epoch"] == 3
    assert_same_tree(full, jax_reader.read_pth(path))


def test_noncontiguous_and_sliced_tensors(tmp_path):
    gen = torch.Generator().manual_seed(1)
    base = torch.randn(6, 8, generator=gen)
    state = {"transposed": base.t(), "sliced": base[1:5, 2:7], "scalar": torch.tensor(2.5)}
    path = tmp_path / "views.pth"
    torch.save(state, str(path))
    ours, theirs = read_both(path, key=None)
    assert_same_tree(ours, theirs)
    np.testing.assert_array_equal(ours["transposed"], base.t().numpy())
    np.testing.assert_array_equal(ours["sliced"], base[1:5, 2:7].numpy())
    np.testing.assert_array_equal(ours["scalar"], np.float32(2.5))
    assert ours["transposed"].flags.c_contiguous


def test_legacy_format_roundtrip(tmp_path):
    state = {k: v for k, v in state_dict().items() if v.dtype != torch.bfloat16}
    path = tmp_path / "legacy.pth"
    torch.save(state, str(path), _use_new_zipfile_serialization=False)
    ours, theirs = read_both(path, key=None)
    assert_same_tree(ours, theirs)
    assert set(ours) == set(state)


def test_shared_storage_views(tmp_path):
    base = torch.arange(12, dtype=torch.float32)
    state = {"full": base, "view": base[3:9], "strided": base[::2]}
    path = tmp_path / "shared.pth"
    torch.save(state, str(path))
    ours, theirs = read_both(path, key=None)
    assert_same_tree(ours, theirs)
    np.testing.assert_array_equal(ours["view"], np.arange(3, 9, dtype=np.float32))
    np.testing.assert_array_equal(ours["strided"], np.arange(0, 12, 2, dtype=np.float32))


def test_published_mae_checkpoint_layout(tmp_path):
    """The published MAE checkpoints carry model + optimizer state + epoch +
    an argparse.Namespace of run args (and here an OrderedDict): both
    readers give the same graph.  numpy values in the graph (the rest of the
    allow-list) are read by the port alone: numpy 2 pickles them under
    ``numpy._core``, a name the JAX allow-list lacks."""
    gen = torch.Generator().manual_seed(2)
    model = collections.OrderedDict(
        cls_token=torch.randn(1, 1, 8, generator=gen),
        **{"blocks.0.attn.qkv.weight": torch.randn(24, 8, generator=gen)})
    optimizer = {
        "state": {0: {"step": 100, "exp_avg": torch.randn(24, 8, generator=gen),
                      "exp_avg_sq": torch.rand(24, 8, generator=gen)}},
        "param_groups": [{"lr": 1e-3, "betas": (0.9, 0.95), "params": [0]}],
    }
    args = argparse.Namespace(batch_size=64, mask_ratio=0.75, model="mae_vit_base")
    path = tmp_path / "mae_full.pth"
    torch.save({"model": model, "optimizer": optimizer, "epoch": 399, "args": args}, str(path))
    full = pth_reader.read_pth(path)
    assert_same_tree(full, jax_reader.read_pth(path))
    assert full["epoch"] == 399 and full["args"].mask_ratio == 0.75
    assert isinstance(full["args"], argparse.Namespace)
    assert isinstance(full["model"], collections.OrderedDict)
    np.testing.assert_array_equal(full["optimizer"]["state"][0]["exp_avg"],
                                  optimizer["state"][0]["exp_avg"].numpy())
    ours, theirs = read_both(path)
    assert_same_tree(ours, theirs)
    numbers = argparse.Namespace(scale=np.float64(0.5), table=np.arange(3, dtype=np.int32),
                                 kind=np.dtype("<f2"))
    torch.save({"model": model, "args": numbers}, str(path))
    read = pth_reader.read_pth(path)["args"]
    assert read.scale == 0.5 and type(read.scale) is np.float64 and read.kind == np.float16
    np.testing.assert_array_equal(read.table, np.arange(3, dtype=np.int32))


def test_files_of_the_jax_writer_read_equal(tmp_path):
    rng = np.random.default_rng(3)
    obj = {"model": {"w": rng.standard_normal((5, 4)).astype(np.float32),
                     "i": np.arange(6, dtype=np.int64).reshape(2, 3),
                     "h": rng.standard_normal(3).astype(np.float16),
                     "v": np.arange(24, dtype=np.float32).reshape(4, 6)[::2, ::3]},
           "meta": {"epoch": 2, "name": "x", "list": [1, 2.5], "none": None}}
    path = jax_write_pt(tmp_path / "jax.pt", obj)
    assert_same_tree(pth_reader.read_pth(path), jax_reader.read_pth(path))
    ours, theirs = read_both(path)
    assert_same_tree(ours, theirs)
    np.testing.assert_array_equal(ours["v"], obj["model"]["v"])


@pytest.mark.parametrize("write, refused", [
    (lambda path: path.write_bytes(pickle.dumps(eval)), "builtins.eval"),
    (lambda path: torch.save({"run": os.system}, str(path)), "system"),
    (lambda path: torch.save({"w": torch.ones(2), "bad": pickle.PickleError("x")}, str(path)),
     "PickleError"),
    (lambda path: torch.save({"bad": pickle.PickleError("x")}, str(path),
                             _use_new_zipfile_serialization=False), "PickleError"),
], ids=["raw-eval", "zip-os-system", "zip-class", "legacy-class"])
def test_rejects_globals_outside_the_allow_list(tmp_path, write, refused):
    """A global outside the JAX allow-list: both readers refuse the file,
    the port's error names the global, and no code path retries it with
    torch's unrestricted unpickler."""
    path = tmp_path / "evil.pth"
    write(path)
    with pytest.raises(jax_reader.TorchUnpickleError):
        jax_reader.read_pth(path)
    with pytest.raises(pth_reader.TorchUnpickleError, match=refused):
        pth_reader.read_pth(path)
    with pytest.raises(pth_reader.TorchUnpickleError, match=refused):
        import_torch.load_torch_state_dict(path)


def test_no_torch_load_without_weights_only():
    """Every ``torch.load`` call in the port passes ``weights_only=True``."""
    calls = []
    for source in [*(ROOT / "ssl4polyp_tpu_torch").rglob("*.py"), ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(source.read_text())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "load" and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "torch"):
                weights_only = [k.value for k in node.keywords if k.arg == "weights_only"]
                calls.append(f"{source.name}:{node.lineno}")
                assert weights_only and isinstance(weights_only[0], ast.Constant) \
                    and weights_only[0].value is True, calls[-1]
    assert any(call.startswith("pth_reader.py") for call in calls), calls


# ---------------------------------------------------------------------------
# Mapping
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("include_decoder", [False, True], ids=["encoder", "with-decoder"])
def test_mae_params_from_torch_match_bit_for_bit(tmp_path, include_decoder):
    cfg = tiny_mae_cfg()
    path = tmp_path / "mae.pth"
    tree = chip_smoke.write_mae_pth(path, cfg, np.random.default_rng(4))
    jcfg = JaxViTConfig(**TINY)
    ours = import_torch.mae_params_from_torch(import_torch.load_torch_state_dict(path), cfg.encoder,
                                              include_decoder=include_decoder, decoder_depth=1)
    theirs = jax_import.mae_params_from_torch(jax_import.load_torch_state_dict(path), jcfg,
                                              include_decoder=include_decoder, decoder_depth=1)
    assert_same_tree(ours, theirs)
    # and both are the tree the file was written from
    assert_same_tree(ours, tree if include_decoder else encoder_only(tree))


def test_vit_params_from_augreg_npz_match_bit_for_bit(tmp_path):
    cfg = ViTConfig(**TINY, num_classes=2)
    path = tmp_path / "augreg.npz"
    tree = chip_smoke.write_augreg_npz(path, cfg, np.random.default_rng(5))
    ours = import_torch.vit_params_from_augreg_npz(path, cfg)
    theirs = jax_import.vit_params_from_augreg_npz(path, JaxViTConfig(**TINY))
    assert_same_tree(ours, theirs)
    assert_same_tree(ours, tree)


# ---------------------------------------------------------------------------
# AugReg cache (tests/test_fetch_augreg.py through the port)
# ---------------------------------------------------------------------------

def write_fake_augreg(path, *, good=True):
    arrays = {
        "embedding/kernel": np.zeros((16, 16, 3, 768), np.float32),
        "embedding/bias": np.zeros((768,), np.float32),
        "cls": np.zeros((1, 1, 768), np.float32),
        "Transformer/posembed_input/pos_embedding": np.zeros((1, 197, 768), np.float32),
        "Transformer/encoder_norm/scale": np.ones((768,), np.float32),
        "Transformer/encoderblock_0/LayerNorm_0/scale": np.ones((768,), np.float32),
        "Transformer/encoderblock_11/MlpBlock_3/Dense_1/kernel":
            np.zeros((3072, 768), np.float32),
    }
    if not good:
        arrays.pop("cls")
    np.savez(path, **arrays)


def test_verify_accepts_wellformed(tmp_path, capsys):
    path = tmp_path / "augreg.npz"
    write_fake_augreg(path)
    augreg_cache.verify(path)
    assert "verified" in capsys.readouterr().out


def test_verify_rejects_missing_keys(tmp_path):
    path = tmp_path / "bad.npz"
    write_fake_augreg(path, good=False)
    with pytest.raises(SystemExit, match="missing"):
        augreg_cache.verify(path)


def test_cache_dir_env_override(tmp_path, monkeypatch):
    from ssl4polyp_tpu.models import augreg_cache as jax_cache

    monkeypatch.setenv("SSL4POLYP_TPU_CACHE", str(tmp_path / "cache"))
    assert augreg_cache.cache_dir() == tmp_path / "cache"
    assert augreg_cache.default_path() == jax_cache.default_path()
    assert augreg_cache.default_path().parent == tmp_path / "cache"
    assert augreg_cache.default_path().suffix == ".npz"
    assert augreg_cache.AUGREG_URL == jax_cache.AUGREG_URL
    assert augreg_cache.REQUIRED_KEYS == jax_cache.REQUIRED_KEYS
    monkeypatch.delenv("SSL4POLYP_TPU_CACHE")
    assert augreg_cache.cache_dir() == Path.home() / ".cache" / "ssl4polyp_tpu"


def test_factory_auto_uses_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("SSL4POLYP_TPU_CACHE", str(tmp_path))
    gen = torch.Generator().manual_seed(0)
    # no cached file -> the JAX factory's actionable error naming the fetch script
    with pytest.raises(FileNotFoundError, match="fetch_augreg") as ours:
        factory.get_imagenet_or_random_vit(gen, pretrained_npz="auto", device="cpu", **TINY)
    with pytest.raises(FileNotFoundError) as theirs:
        jax_factory.get_imagenet_or_random_vit(jax.random.PRNGKey(0), pretrained_npz="auto",
                                               **TINY)
    assert str(ours.value) == str(theirs.value)

    # a cached (tiny) export loads through the auto path
    cfg = ViTConfig(**TINY, num_classes=2)
    tree = chip_smoke.write_augreg_npz(augreg_cache.default_path(), cfg, np.random.default_rng(6))
    model = factory.get_imagenet_or_random_vit(gen, pretrained_npz="auto", device="cpu", **TINY)
    assert model.scheme == "sup_imnet" and model.cfg.pos_embed == "learned"
    np.testing.assert_array_equal(model.model.cls_token.detach().numpy(), tree["cls_token"])
    with pytest.raises(ValueError, match="not both"):
        factory.get_imagenet_or_random_vit(gen, jax_params=tree, pretrained_npz="auto",
                                           device="cpu", **TINY)


# ---------------------------------------------------------------------------
# Factory on the model configs
# ---------------------------------------------------------------------------

def model_config(name: str) -> dict:
    return yaml.safe_load((ROOT / "config" / "model" / f"{name}.yaml").read_text())["model"]


def write_named_file(model_cfg: dict, root: Path, rng) -> dict:
    """Write the file ``model_cfg["checkpoint"]`` names under ``root`` from a
    numpy-seeded tree, in its format; return the encoder tree it holds."""
    path = root / model_cfg["checkpoint"]
    if path.suffix == ".npz":
        return chip_smoke.write_augreg_npz(path, ViTConfig(**TINY, num_classes=2), rng)
    cfg = tiny_mae_cfg()
    if path.suffix == ".pth":
        return encoder_only(chip_smoke.write_mae_pth(path, cfg, rng))
    tree = chip_smoke.jax_layout_mae_tree(cfg, rng)
    save_checkpoint(path, {"params": tree}, {"epoch": 0})
    return encoder_only(tree)


@pytest.mark.parametrize("dtype", ["fp32", "bf16"])
@pytest.mark.parametrize("present", [True, False], ids=["file", "no-file"])
@pytest.mark.parametrize("name, scheme_with_file, scheme_without", [
    ("sup_imnet", "sup_imnet", "random"),
    ("ssl_imnet", "ssl_imnet", "ssl_imnet"),
    ("ssl_colon", "ssl_colon", "ssl_colon"),
])
def test_build_classifier_on_the_model_configs(tmp_path, name, scheme_with_file, scheme_without,
                                               present, dtype):
    """The port's and the JAX ``build_classifier`` on one config and one
    checkpoint root: with the file, the port's encoder is the file's tree bit
    for bit and its logits (the JAX head copied in) match the JAX
    classifier's; without it, random init and no error, as in the JAX
    factory."""
    model_cfg = model_config(name)
    root = tmp_path / "root"
    encoder = write_named_file(model_cfg, root, np.random.default_rng(7)) if present else None
    torch_dtype, jax_dtype = {"fp32": (torch.float32, jnp.float32),
                              "bf16": (torch.bfloat16, jnp.bfloat16)}[dtype]
    ours = factory.build_classifier(torch.Generator().manual_seed(0), model_cfg,
                                    checkpoint_root=root, device="cpu",
                                    compute_dtype=torch_dtype, **TINY)
    theirs = jax_factory.build_classifier(jax.random.PRNGKey(0), model_cfg, checkpoint_root=root,
                                          compute_dtype=jax_dtype, **TINY)
    assert ours.scheme == theirs.scheme == (scheme_with_file if present else scheme_without)
    assert ours.cfg.pos_embed == theirs.cfg.pos_embed
    params = jax.tree_util.tree_map(np.asarray, theirs.params)
    if present:
        got = state_dict_from_jax(encoder, ours.cfg)
        mine = dict(ours.model.named_parameters())
        assert all(torch.equal(mine[n], t) for n, t in got.items())
        assert_same_tree({k: v for k, v in params.items() if k != "head"}, encoder)
    else:
        # random on both sides: the port takes the JAX weights to compare
        ours.model.load_state_dict(state_dict_from_jax(params, ours.cfg))
    ours.model.head.load_state_dict({
        "weight": torch.from_numpy(np.ascontiguousarray(params["head"]["kernel"].T)),
        "bias": torch.from_numpy(params["head"]["bias"].copy())})
    images = np.random.default_rng(8).standard_normal((3, 32, 32, 3)).astype(np.float32)
    want = np.asarray(theirs.apply(theirs.params, jnp.asarray(images)))
    with torch.inference_mode():
        got = ours.model(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (3, 2) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


def test_a_missing_checkpoint_file_is_random_init(tmp_path):
    """A config whose checkpoint does not exist builds, with no error, the
    random model the same generator builds without a checkpoint."""
    for name in ("sup_imnet", "ssl_imnet", "ssl_colon"):
        model_cfg = model_config(name)
        with_missing = factory.build_classifier(torch.Generator().manual_seed(1), model_cfg,
                                                checkpoint_root=tmp_path, device="cpu", **TINY)
        bare = factory.build_classifier(torch.Generator().manual_seed(1),
                                        {k: v for k, v in model_cfg.items() if k != "checkpoint"},
                                        device="cpu", **TINY)
        for (n, a), (_, b) in zip(with_missing.model.named_parameters(),
                                  bare.model.named_parameters()):
            assert torch.equal(a, b), (name, n)


def test_mae_weight_path_formats(tmp_path):
    """``get_mae_backbone``'s ``weight_path``: a ``.pth``, a suffix-less
    ``.pth``, a suffix-less ``.ckpt`` and a ``.ckpt.json`` sidecar's path all
    give the tree they hold, the sin-cos table the file's; the head is fresh
    from the generator."""
    cfg = tiny_mae_cfg()
    pth_tree = chip_smoke.write_mae_pth(tmp_path / "a.pth", cfg, np.random.default_rng(9))
    (tmp_path / "b").write_bytes((tmp_path / "a.pth").read_bytes())
    ckpt_tree = chip_smoke.jax_layout_mae_tree(cfg, np.random.default_rng(10))
    ckpt = save_checkpoint(tmp_path / "c.ckpt", {"params": ckpt_tree}, {"epoch": 1})
    (tmp_path / "d").write_bytes(ckpt.read_bytes())
    cases = [("a.pth", pth_tree), ("b", pth_tree), ("d", ckpt_tree), ("c.ckpt.json", ckpt_tree)]
    heads = []
    for weight, tree in cases:
        built = factory.get_mae_backbone(torch.Generator().manual_seed(2), device="cpu",
                                         weight_path=tmp_path / weight, **TINY)
        want = state_dict_from_jax(encoder_only(tree), built.cfg)
        mine = dict(built.model.named_parameters())
        assert set(mine) - set(want) == {"head.weight", "head.bias"}
        assert all(torch.equal(mine[n], t) for n, t in want.items()), weight
        heads.append(built.model.head.weight.detach())
    assert all(torch.equal(h, heads[0]) for h in heads)


def test_a_bf16_pth_is_cast_to_fp32(tmp_path):
    """A checkpoint saved in bf16: the reader keeps its tensors bf16, the
    factory casts each to fp32 (exactly), as the JAX ``_as_jax`` does."""
    cfg = tiny_mae_cfg()
    tree = chip_smoke.write_mae_pth(tmp_path / "fp32.pth", cfg, np.random.default_rng(11))
    with torch.serialization.safe_globals([argparse.Namespace]):
        state = torch.load(tmp_path / "fp32.pth", weights_only=True)
    state["model"] = {k: v.bfloat16() for k, v in state["model"].items()}
    torch.save(state, tmp_path / "bf16.pth")
    read = import_torch.load_torch_state_dict(tmp_path / "bf16.pth")
    assert all(isinstance(v, torch.Tensor) and v.dtype == torch.bfloat16 for v in read.values())
    built = factory.get_mae_backbone(torch.Generator().manual_seed(3), device="cpu",
                                     weight_path=tmp_path / "bf16.pth", **TINY)
    want = state_dict_from_jax(encoder_only(tree), built.cfg)
    mine = dict(built.model.named_parameters())
    for name, tensor in want.items():
        assert mine[name].dtype == torch.float32
        assert torch.equal(mine[name], tensor.bfloat16().float()), name
    theirs = jax_factory.get_mae_backbone(jax.random.PRNGKey(0), weight_path=tmp_path / "bf16.pth",
                                          **TINY)
    np.testing.assert_array_equal(np.asarray(theirs.params["blocks"]["mlp"]["fc1"]["kernel"][1]),
                                  mine["blocks.1.mlp.fc1.weight"].detach().numpy().T)
