"""The port's native JPEG decoder against the JAX package's, byte for byte.

Both libraries build here from the same C++ (the JAX one against the
system's libjpeg-turbo 2.1.5, the port's against the libjpeg-turbo that
PIL's wheel ships).  Every entry point must give the same bytes and the same
status, at 1 and 8 threads, on frames of the study's sizes (SUN's
1240x1080, PolypGen's 1920x1080 and 1350x1080, Hyperkvasir-like 720x576 and
1280x1024, 384x288, 224x224) at 4:2:0 and 4:4:4, a progressive and a
grayscale frame, and on files it cannot decode (CMYK, corrupt, missing,
PNG); the crops cover every DCT scale from 1/8 to 8/8.  ``reference.py``
applied to PIL's ``draft`` decode gives the library's bytes at the scales
``draft`` reaches.  The loaders yield the JAX loaders' batches with the
native decoder on both sides and with PIL on both sides, and a decoder that
cannot be built raises before any batch.
"""

import os

import numpy as np
import pytest
from PIL import Image

from ssl4polyp_tpu import native as jax_native
from ssl4polyp_tpu.data import folder as jax_folder
from ssl4polyp_tpu.data import loader as jax_loader
from ssl4polyp_tpu.data import packs as jax_packs
from chip_smoke import draft_decode, sun_like_pixels
from ssl4polyp_tpu_torch import native
from ssl4polyp_tpu_torch.data import folder, loader, packs
from ssl4polyp_tpu_torch.data.transforms import decode_frame
from ssl4polyp_tpu_torch.native import reference
from tests.conftest import make_image_pack

SIZES = [(1240, 1080), (1920, 1080), (1350, 1080), (720, 576), (1280, 1024), (384, 288),
         (224, 224)]
# PIL's subsampling codes: 0 is 4:4:4, 2 is 4:2:0.
SUBSAMPLINGS = {"444": 0, "420": 2}
DRAFT_SCALES = (1, 2, 4, 8)  # the N of N/8 that PIL's Image.draft reaches


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """name -> path of every JPEG of the matrix."""
    root = tmp_path_factory.mktemp("native_frames")
    rng = np.random.default_rng(23)
    paths = {}
    for width, height in SIZES:
        pixels = sun_like_pixels(rng, width, height)
        for tag, code in SUBSAMPLINGS.items():
            paths[f"{width}x{height}_{tag}"] = root / f"{width}x{height}_{tag}.jpg"
            Image.fromarray(pixels).save(paths[f"{width}x{height}_{tag}"], quality=90,
                                         subsampling=code)
    pixels = sun_like_pixels(rng, 1240, 1080)
    paths["progressive"] = root / "progressive.jpg"
    Image.fromarray(pixels).save(paths["progressive"], quality=90, progressive=True)
    paths["grayscale"] = root / "grayscale.jpg"
    Image.fromarray(pixels).convert("L").save(paths["grayscale"], quality=90)
    return paths


@pytest.fixture(scope="module")
def bad_files(tmp_path_factory):
    """Files the decoder refuses: CMYK, corrupt, missing, PNG."""
    root = tmp_path_factory.mktemp("native_bad")
    pixels = sun_like_pixels(np.random.default_rng(5), 320, 240)
    Image.fromarray(pixels).convert("CMYK").save(root / "cmyk.jpg", quality=90)
    # A JPEG's start-of-image marker, then noise: no frame header to read.
    noise = np.random.default_rng(6).integers(0, 256, 4096, dtype=np.uint8).tobytes()
    (root / "corrupt.jpg").write_bytes(b"\xff\xd8" + noise)
    Image.fromarray(pixels).save(root / "frame.png")
    return {"cmyk": root / "cmyk.jpg", "corrupt": root / "corrupt.jpg",
            "missing": root / "missing.jpg", "png": root / "frame.png"}


def _size(path):
    with Image.open(path) as img:
        return img.size


def _draft(path, num):
    """PIL's decode at scale num/8 (``Image.draft``), as RGB, at libjpeg's
    size for that scale."""
    decoded = draft_decode(path, num)
    width, height = _size(path)
    assert decoded.shape[:2] == (reference.scaled_size(height, num),
                                 reference.scaled_size(width, num))
    return decoded


def _crops(width, height, rng):
    """(out, (fy, fx, fh, fw), flip, num) for every scale from 1/8 to 8/8 at
    out 64 (and at 224 where the frame allows it), then torchvision's
    RandomResizedCrop draws at 224, as the pretraining loader draws them."""
    crops = []
    for out in (64, 224):
        for num in range(1, 9):
            # Crop height so that scale num covers `out` and num - 1 does not.
            fh = out * 8 / (height * (num - 0.5))
            if fh > 1:
                continue
            fw = min(1.0, fh * width / height)
            fy, fx = rng.uniform(0, 1 - fh), rng.uniform(0, 1 - fw)
            crops.append((out, (fy, fx, fh, fw), bool(rng.integers(0, 2))))
    for _ in range(6):
        y0, x0, h, w = folder.sample_crop_box(width, height, rng)
        crops.append((224, (y0 / height, x0 / width, h / height, w / width), rng.random() < 0.5))
    return [(out, frac, flip, reference.crop_scale(width, height, out, out, frac[2], frac[3]))
            for out, frac, flip in crops]


def test_the_library_builds_from_the_repos_sources_against_pils_libjpeg():
    library = native.build_library()
    assert library.exists() and library.name == "libjpeg_loader.so"
    assert library.parent.parent.name == "ssl4polyp_tpu_torch"
    assert library.parent.parent.parent.name == "build"
    log = (library.parent / "g++.log").read_text()
    assert "-ffp-contract=off" in log and str(native.libjpeg_path()) in log
    assert "third_party/libjpeg-turbo" in log
    assert native.native_available()


@pytest.mark.parametrize("name", sorted(
    [f"{w}x{h}_{tag}" for w, h in SIZES for tag in SUBSAMPLINGS] + ["progressive", "grayscale"]))
def test_every_entry_point_is_the_jax_librarys(frames, name):
    path = frames[name]
    width, height = _size(path)
    assert native.jpeg_dims(path) == jax_native.jpeg_dims(path) == (width, height)
    for out in (224, 64):
        ours, ref = native.decode_resize(path, out, out), jax_native.decode_resize(path, out, out)
        assert ours is not None and np.array_equal(ours, ref)
    rng = np.random.default_rng(width * 7 + height)
    for out, frac, flip, _ in _crops(width, height, rng):
        ours = native.decode_crop_resize(path, out, out, frac, flip)
        ref = jax_native.decode_crop_resize(path, out, out, frac, flip)
        assert ours is not None and np.array_equal(ours, ref), (out, frac, flip)


@pytest.mark.parametrize("threads", [1, 8])
def test_the_batch_entry_points_are_the_jax_librarys(frames, bad_files, threads):
    paths = [*frames.values(), *bad_files.values()] * 2
    for out in (224, 96):
        ours = native.decode_resize_batch_status(paths, out, out, n_threads=threads)
        ref = jax_native.decode_resize_batch_status(paths, out, out, n_threads=threads)
        np.testing.assert_array_equal(ours[1], ref[1])
        np.testing.assert_array_equal(ours[0], ref[0])
        assert ours[1].tolist() == [True] * len(frames) + [False] * len(bad_files) + \
            [True] * len(frames) + [False] * len(bad_files)
        assert not ours[0][~ours[1]].any()  # failed frames zero-filled
        np.testing.assert_array_equal(
            native.decode_resize_batch(paths, out, out, n_threads=threads),
            jax_native.decode_resize_batch(paths, out, out, n_threads=threads))
    rng = np.random.default_rng(threads)
    for out in (224, 64):
        crops, flips, batch = [], [], []
        for path in paths:
            width, height = jax_native.jpeg_dims(path) or (640, 480)
            draws = [c for c in _crops(width, height, rng) if c[0] == out]
            _, frac, flip, _ = draws[int(rng.integers(0, len(draws)))]
            crops.append(frac)
            flips.append(flip)
            batch.append(path)
        crops, flips = np.asarray(crops), np.asarray(flips)
        ours = native.decode_crop_resize_batch_status(batch, out, out, crops, flips,
                                                      n_threads=threads)
        ref = jax_native.decode_crop_resize_batch_status(batch, out, out, crops, flips,
                                                         n_threads=threads)
        np.testing.assert_array_equal(ours[1], ref[1])
        np.testing.assert_array_equal(ours[0], ref[0])
        assert not ours[0][~ours[1]].any() and ours[1].sum() == 2 * len(frames)


def test_the_crops_cover_every_dct_scale(frames):
    seen = set()
    for name, path in frames.items():
        width, height = _size(path)
        seen |= {num for *_, num in _crops(width, height, np.random.default_rng(width * 7 + height))}
    assert seen == set(range(1, 9))


@pytest.mark.parametrize("name", ["cmyk", "corrupt", "missing", "png"])
def test_files_it_cannot_decode_fail_alike(bad_files, name):
    path = bad_files[name]
    assert native.decode_resize(path, 64, 64) is None and jax_native.decode_resize(path, 64, 64) is None
    assert native.decode_crop_resize(path, 64, 64, (0, 0, 1, 1)) is None
    assert jax_native.decode_crop_resize(path, 64, 64, (0, 0, 1, 1)) is None
    assert native.jpeg_dims(path) == jax_native.jpeg_dims(path)


@pytest.mark.parametrize("name", sorted(
    [f"{w}x{h}_{tag}" for w, h in SIZES for tag in SUBSAMPLINGS] + ["progressive", "grayscale"]))
def test_the_reference_is_the_jax_library_through_draft(frames, name):
    path = frames[name]
    width, height = _size(path)
    checked = 0
    for out in (224, 64):
        num = reference.resize_scale(width, height, out, out)
        if num in DRAFT_SCALES:
            want = jax_native.decode_resize(path, out, out)
            np.testing.assert_array_equal(reference.resize_decoded(_draft(path, num), out, out),
                                          want)
            checked += 1
    rng = np.random.default_rng(width * 7 + height)
    for out, frac, flip, num in _crops(width, height, rng):
        if num in DRAFT_SCALES:
            want = jax_native.decode_crop_resize(path, out, out, frac, flip)
            got = reference.crop_decoded(_draft(path, num), frac, out, out, flip)
            np.testing.assert_array_equal(got, want, err_msg=f"{out} {frac} {flip} {num}/8")
            checked += 1
    assert checked >= 4


def test_the_reference_crop_needs_the_rows_from_the_crop_at_offset_zero(frames):
    """The trap the reference keeps: resampling the whole decode at row
    offset sy gives other bits than the library's rows from sy at 0."""
    path = frames["1240x1080_420"]
    differs = 0
    for frac in [(0.31, 0.1, 0.45, 0.6), (0.23, 0.2, 0.5, 0.5), (0.4, 0.05, 0.43, 0.7)]:
        num = reference.crop_scale(1240, 1080, 224, 224, frac[2], frac[3])
        decoded = _draft(path, 4)
        assert num == 4
        want = jax_native.decode_crop_resize(path, 224, 224, frac)
        np.testing.assert_array_equal(reference.crop_decoded(decoded, frac, 224, 224), want)
        sy, sx, sh, sw = reference.crop_box(*decoded.shape[:2], *frac)
        whole = reference.cubic_crop_resize(decoded, sy, sx, sh, sw, 224, 224)
        differs += not np.array_equal(whole, want)
    assert differs >= 1


# --------------------------------------------------------------------------
# The loaders on frames that are resized
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sun_pack(tmp_path_factory):
    """A pack whose 16 frames a split are 1240x1080 JPEGs (SUN's size)."""
    root = tmp_path_factory.mktemp("sun_pack")
    pack = make_image_pack(root, name="sun_full", frames_per_split=16, image_size=8)
    rng = np.random.default_rng(11)
    for path in sorted((root / "sun_full_images").glob("*.jpg")):
        Image.fromarray(sun_like_pixels(rng, 1240, 1080)).save(path, quality=90)
    return pack


def _split(module, pack, alias, **kwargs):
    specs = {f"{alias}_spec": pack}
    return module.create_classification_datasets(image_size=224, **specs, **kwargs)[alias]


def _batches(host_loader, epochs=(0, 1)):
    out = []
    for epoch in epochs:
        host_loader.set_epoch(epoch)
        out += list(host_loader)
    return out


@pytest.mark.parametrize("alias, kwargs", [("test", {}), ("train", {"seed": 13})])
def test_host_loader_is_the_jax_loaders_with_native_on_both_sides(sun_pack, alias, kwargs):
    native.reset_decode_counts()
    ours = loader.HostDataLoader(_split(packs, sun_pack, alias), 8, num_workers=8, **kwargs)
    ref = jax_loader.HostDataLoader(_split(jax_packs, sun_pack, alias), 8, num_workers=8, **kwargs)
    assert ours._use_native and ref._use_native
    got, want = _batches(ours), _batches(ref)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    assert native.decode_counts() == {"decoded": 32, "failed": 0}


def test_host_loader_decodes_through_pil_under_the_switch_on_both_sides(sun_pack, monkeypatch):
    native_batch = next(iter(loader.HostDataLoader(_split(packs, sun_pack, "test"), 8,
                                                   num_workers=4)))
    monkeypatch.setenv("SSL4POLYP_NATIVE_DECODE", "0")
    ours = loader.HostDataLoader(_split(packs, sun_pack, "test"), 8, num_workers=4)
    ref = jax_loader.HostDataLoader(_split(jax_packs, sun_pack, "test"), 8, num_workers=4)
    assert not ours._use_native and not ref._use_native
    native.reset_decode_counts()
    got, want = list(ours), list(ref)
    assert native.decode_counts() == {"decoded": 0, "failed": 0}
    for a, b in zip(got, want, strict=True):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)
    index = _split(packs, sun_pack, "test")
    np.testing.assert_array_equal(got[0]["image"][0], decode_frame(index.paths[0], 224))
    # The two decoders' pixels differ on a resized frame.
    assert not np.array_equal(got[0]["image"], native_batch["image"])
    # use_native=False does what the switch does.
    monkeypatch.delenv("SSL4POLYP_NATIVE_DECODE")
    pinned = next(iter(loader.HostDataLoader(index, 8, num_workers=4, use_native=False)))
    np.testing.assert_array_equal(pinned["image"], got[0]["image"])


def test_host_loader_renders_a_perturbed_pack_through_pil_on_both_sides(tmp_path):
    pack = make_image_pack(tmp_path, frames_per_split=10, image_size=40, variant_rows=True)
    kwargs = dict(test_spec=pack, image_size=32, perturbation_splits=("test",))
    ours = loader.HostDataLoader(packs.create_classification_datasets(**kwargs)["test"], 4,
                                 num_workers=2, use_native=True)
    ref = jax_loader.HostDataLoader(jax_packs.create_classification_datasets(**kwargs)["test"], 4,
                                    num_workers=2, use_native=True)
    assert not ours._use_native and not ref._use_native
    for a, b in zip(list(ours), list(ref), strict=True):
        for key in b:
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)


def test_host_loader_retries_what_the_decoder_fails_through_pil(sun_pack, bad_files, tmp_path):
    index = _split(packs, sun_pack, "test")
    index.paths = list(index.paths)
    index.paths[3] = str(bad_files["cmyk"])
    native.reset_decode_counts()
    batch, _ = list(loader.HostDataLoader(index, 8, num_workers=4))
    assert native.decode_counts() == {"decoded": 15, "failed": 1}
    assert batch["valid"].all()
    np.testing.assert_array_equal(batch["image"][3], decode_frame(bad_files["cmyk"], 224))


@pytest.fixture(scope="module")
def sun_folder(tmp_path_factory):
    """16 unlabelled 1240x1080 JPEGs and a PNG, for the pretraining loader."""
    root = tmp_path_factory.mktemp("sun_folder")
    rng = np.random.default_rng(17)
    for i in range(16):
        Image.fromarray(sun_like_pixels(rng, 1240, 1080)).save(root / f"{i:02d}.jpg", quality=90)
    return root


@pytest.mark.parametrize("use_native", [None, False])
def test_pretrain_loader_is_the_jax_loaders_on_both_paths(sun_folder, use_native):
    native.reset_decode_counts()
    ours = folder.PretrainLoader(folder.ImageFolderIndex(sun_folder, no_train_dir=True), 8,
                                 seed=3, num_workers=8, use_native=use_native)
    ref = jax_folder.PretrainLoader(jax_folder.ImageFolderIndex(sun_folder, no_train_dir=True), 8,
                                    seed=3, num_workers=8, use_native=use_native)
    got, want = _batches(ours), _batches(ref)
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        assert a.shape == (8, 224, 224, 3)
        np.testing.assert_array_equal(a, b)
    assert native.decode_counts() == {"decoded": 32 if use_native is None else 0, "failed": 0}


def test_pretrain_loaders_paths_draw_the_same_crops_and_give_other_pixels(sun_folder):
    index = folder.ImageFolderIndex(sun_folder, no_train_dir=True)
    by_native = next(iter(folder.PretrainLoader(index, 8, seed=3, num_workers=4)))
    by_pil = next(iter(folder.PretrainLoader(index, 8, seed=3, num_workers=4, use_native=False)))
    assert not np.array_equal(by_native, by_pil)
    # The same crop and flip: a few levels apart, not another picture.
    assert np.abs(by_native.astype(int) - by_pil.astype(int)).mean() < 4


def test_pretrain_loader_sends_frames_without_a_jpeg_header_to_pil(sun_folder, tmp_path):
    for path in sorted(sun_folder.glob("*.jpg"))[:4]:
        (tmp_path / path.name).write_bytes(path.read_bytes())
    with Image.open(tmp_path / "00.jpg") as img:
        img.save(tmp_path / "04.png")
    index = folder.ImageFolderIndex(tmp_path, no_train_dir=True)
    native.reset_decode_counts()
    ours = list(folder.PretrainLoader(index, 5, num_workers=2, drop_last=False))
    ref = list(jax_folder.PretrainLoader(jax_folder.ImageFolderIndex(tmp_path, no_train_dir=True),
                                         5, num_workers=2, drop_last=False))
    assert native.decode_counts() == {"decoded": 4, "failed": 0}
    np.testing.assert_array_equal(ours[0], ref[0])


# --------------------------------------------------------------------------
# No silent fallback
# --------------------------------------------------------------------------

@pytest.fixture
def unbuilt(monkeypatch, tmp_path):
    """The module as in a fresh process, building into an empty directory."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_BUILD_ROOT", tmp_path / "build")
    return monkeypatch


def _loaders_refuse(sun_pack, sun_folder, match):
    with pytest.raises(RuntimeError, match=match):
        loader.HostDataLoader(_split(packs, sun_pack, "test"), 8, num_workers=2)
    pretrain = folder.PretrainLoader(folder.ImageFolderIndex(sun_folder, no_train_dir=True), 8,
                                     num_workers=2)
    with pytest.raises(RuntimeError, match=match):
        next(iter(pretrain))


def test_a_libjpeg_that_is_not_one_raises_and_no_loader_yields(unbuilt, tmp_path, sun_pack,
                                                               sun_folder):
    fake = tmp_path / "libjpeg.so.62"
    fake.write_text("not a shared library\n")
    unbuilt.setattr(native, "libjpeg_path", lambda: fake)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed .* libjpeg .*libjpeg.so.62"):
        native.build_library()
    assert "libjpeg.so.62" in next((tmp_path / "build").glob("*/g++.log")).read_text()
    _loaders_refuse(sun_pack, sun_folder, "g\\+\\+ failed")
    # Pinned off, the loaders never ask for it.
    assert not loader.HostDataLoader(_split(packs, sun_pack, "test"), 8, use_native=False)._use_native
    assert len(list(folder.PretrainLoader(folder.ImageFolderIndex(sun_folder, no_train_dir=True),
                                          8, num_workers=2, use_native=False))) == 2


def test_a_missing_compiler_raises_and_no_loader_yields(unbuilt, tmp_path, sun_pack, sun_folder):
    unbuilt.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.native_available()
    _loaders_refuse(sun_pack, sun_folder, "g\\+\\+ not found")


def test_a_library_that_fails_its_first_use_check_raises():
    class Refuses:  # a libjpeg of another ABI: every frame fails with status 2
        @staticmethod
        def decode_resize(*args):
            return 2

    with pytest.raises(RuntimeError, match="first-use check: status 2"):
        native._check(Refuses(), native.libjpeg_path())


def test_the_library_is_found_as_pil_maps_it():
    path = native.libjpeg_path()
    assert path.exists() and ".so.62" in path.name and path.name.startswith("libjpeg")
    import PIL

    wheel = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    if os.path.isdir(wheel):
        assert str(path.parent) == os.path.realpath(wheel)
