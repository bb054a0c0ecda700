"""The port's pack index, perturbation renderer and host loader against the
JAX package's, on one pack of JPEG frames with per-row variants."""

import numpy as np
import pytest
from PIL import Image

from ssl4polyp_tpu.configs import manifests as jax_manifests
from ssl4polyp_tpu.data import loader as jax_loader
from ssl4polyp_tpu.data import packs as jax_packs
from ssl4polyp_tpu.data import transforms as jax_transforms
from ssl4polyp_tpu_torch.configs import manifests
from ssl4polyp_tpu_torch.data import loader, packs, transforms
from tests.conftest import make_image_pack


@pytest.fixture
def variant_pack(tmp_path):
    return make_image_pack(tmp_path, frames_per_split=11, image_size=40, variant_rows=True)


def _datasets(module, pack, **kwargs):
    return module.create_classification_datasets(
        train_spec=pack, val_spec=pack, test_spec=pack, image_size=32,
        perturbation_splits=("test",), **kwargs)


def test_pack_index_equals_the_jax_packages(variant_pack, tmp_path):
    ours = _datasets(packs, variant_pack, snapshot_dir=tmp_path / "snap")
    ref = _datasets(jax_packs, variant_pack)
    assert set(ours) == set(ref) == {"train", "val", "test"}
    for alias in ref:
        a, b = ours[alias], ref[alias]
        assert a.paths == b.paths and a.meta == b.meta and a.provenance == b.provenance
        np.testing.assert_array_equal(a.labels, b.labels)
        assert (a.split, a.stage, a.image_size, a.perturbations_enabled, a.hmac_key) == (
            b.split, b.stage, b.image_size, b.perturbations_enabled, b.hmac_key)
        np.testing.assert_array_equal(a.class_counts(2), b.class_counts(2))
    assert ours["test"].perturbations_enabled and not ours["train"].perturbations_enabled
    # The provenance snapshot names the torch backend, not a TPU.
    import json
    accel = json.loads((tmp_path / "snap" / "accelerator.json").read_text())
    assert accel["backend"] in ("cpu", "cuda") and "torch" in accel
    assert (tmp_path / "snap" / "manifest_snapshot" / "test.csv").exists()


@pytest.mark.parametrize("spec, splits", [
    ("{pack}", ["train", "test"]), ("{pack}/manifest.yaml", ["val"]), ("{pack}/test.csv", ["test"]),
])
def test_pack_specs_resolve_as_in_the_jax_package(variant_pack, spec, splits):
    spec = spec.format(pack=variant_pack)
    assert packs.resolve_pack_spec(spec, splits) == jax_packs.resolve_pack_spec(spec, splits)


def test_manifest_checks_raise_as_in_the_jax_package(variant_pack):
    manifest = variant_pack / "manifest.yaml"
    for module in (manifests, jax_manifests):
        pack = module.load_pack(manifest_yaml=manifest)
        assert [len(pack[s].rows) for s in ("train", "val", "test")] == [11, 11, 11]
    # Pin a hash and a count that the files do not meet.
    import yaml
    raw = yaml.safe_load(manifest.read_text())
    raw["test"]["sha256"] = "0" * 64
    raw["counts"] = {"val": {"frames": 11, "label_counts": {"pos": 4}}}
    manifest.write_text(yaml.safe_dump(raw))
    for module in (manifests, jax_manifests):
        with pytest.raises(ValueError, match="label '1' expected 4 rows, found 5"):
            module.load_pack(manifest_yaml=manifest, train=variant_pack / "train.csv")
        with pytest.raises(ValueError, match="SHA256 mismatch"):
            module.verify_hash(variant_pack / "test.csv", manifest, split_name="test")
        module.verify_hash(variant_pack / "val.csv", manifest, split_name="val")  # not pinned
        with pytest.raises(ValueError, match="Missing required columns"):
            module.load_split(manifest)  # a YAML file is no split CSV


@pytest.mark.parametrize("variant", ["clean", "blur_1p5", "jpeg_30", "bc_b0p7_c0p7", "occ_a0p2",
                                     "occ_a0p05", "blur_0", "unknown_variant"])
def test_perturber_renders_the_jax_packages_pixels(variant):
    rng = np.random.default_rng(3)
    image = Image.fromarray(rng.integers(0, 256, (48, 40, 3), dtype=np.uint8))
    row = {"frame_path": "store/a.jpg", "frame_id": "f1", "case_id": "c1", "variant": variant,
           "perturbation_id": variant, "rng_seed": "-1", "render_in_pipeline": "True",
           "blur_sigma": "-1.0", "jpeg_q": "-1", "brightness": "-1.0", "contrast": "-1.0",
           "bbox_area_frac": "-1.0"}
    assert transforms.row_hmac_seed(row) == jax_transforms.row_hmac_seed(row)
    assert transforms.parse_variant_params(variant) == jax_transforms.parse_variant_params(variant)
    ours = np.asarray(transforms.PerRowPerturber()(image, row))
    ref = np.asarray(jax_transforms.PerRowPerturber()(image, row))
    np.testing.assert_array_equal(ours, ref)
    if variant.startswith("occ_a0p"):
        assert (ours == 0).all(axis=-1).any() and not np.array_equal(ours, np.asarray(image))
    seeded = dict(row, rng_seed="7")
    np.testing.assert_array_equal(np.asarray(transforms.PerRowPerturber(b"k")(image, seeded)),
                                  np.asarray(jax_transforms.PerRowPerturber(b"k")(image, seeded)))


@pytest.mark.parametrize("use_native", [False, True])
@pytest.mark.parametrize("alias, batch_size, kwargs", [
    ("test", 4, {}),                                        # perturbed rows, padded tail
    ("train", 4, {"seed": 13}),                             # shuffled, drop_last
    ("train", 16, {"seed": 13}),                            # tiny pack: never drop the only batch
    ("val", 3, {"process_index": 1, "process_count": 2}),   # a stripe, wrap-around padding
    ("val", 5, {"shuffle": True, "seed": 2, "drop_last": True}),
])
def test_loader_yields_the_jax_loaders_batches(variant_pack, alias, batch_size, kwargs,
                                               use_native):
    # The frames (40 px) are resized to 32: the native decoder's pixels and
    # PIL's differ, and each side must take the same one.  The perturbed
    # test split goes through PIL on both sides whatever use_native says.
    ours = loader.HostDataLoader(_datasets(packs, variant_pack)[alias], batch_size,
                                 num_workers=2, use_native=use_native, **kwargs)
    ref = jax_loader.HostDataLoader(_datasets(jax_packs, variant_pack)[alias], batch_size,
                                    num_workers=2, use_native=use_native, **kwargs)
    assert ours._use_native == ref._use_native == (use_native and alias != "test")
    assert (ours.shuffle, ours.drop_last, len(ours)) == (ref.shuffle, ref.drop_last, len(ref))
    for epoch in (0, 1):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        batches, ref_batches = list(ours), list(ref)
        assert len(batches) == len(ref_batches) == len(ref) > 0
        for a, b in zip(batches, ref_batches):
            assert set(a) == set(b) == {"image", "label", "valid", "index"}
            for key in b:
                assert a[key].dtype == b[key].dtype and a[key].shape == b[key].shape
                np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_a_frame_that_does_not_decode_is_a_masked_slot(variant_pack):
    index = _datasets(packs, variant_pack)["val"]
    with open(index.paths[2], "wb") as handle:
        handle.write(b"not a jpeg")
    batches = list(loader.HostDataLoader(index, 4, num_workers=1))
    valid = np.concatenate([b["valid"] for b in batches])
    assert valid.sum() == 10 and not valid[2] and not batches[0]["image"][2].any()
    # decode_frame itself raises: the loader is what masks.
    with pytest.raises(Exception):
        transforms.decode_frame(index.paths[2], 32)
    np.testing.assert_array_equal(transforms.decode_frame(index.paths[0], 32),
                                  jax_transforms.decode_frame(index.paths[0], 32))
