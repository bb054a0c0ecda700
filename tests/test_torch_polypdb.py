"""The port's pack tools (``ssl4polyp_tpu_torch/polypdb``) against the JAX
package's: the synthetic SUN and PolypGen roots byte for byte from one seed;
every builder on the same roots, written to the same path in turn with the
clock pinned, byte for byte in every CSV and manifest; the error messages of
roots that are too small; the HMAC primitives and the target scaling under
hypothesis; ``build_sun_test_corruptions`` with and without OpenCV; every
CLI subcommand through both ``main``s; port copies of
``test_pack_builders.py`` and ``test_polypdb.py``; and the slice as a whole:
packs the port built, a port exp1 parent, and exp5b through both engines
from that parent.  Frames are 32 px; roots hold about 15 cases."""

from __future__ import annotations

import contextlib
import csv
import hashlib
import hmac
import io
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import yaml
from hypothesis import given, settings
from hypothesis import strategies as st

from ssl4polyp_tpu.polypdb import builders as jax_builders
from ssl4polyp_tpu.polypdb import cli as jax_cli
from ssl4polyp_tpu.polypdb import robustness as jax_robustness
from ssl4polyp_tpu.polypdb import synth as jax_synth
from ssl4polyp_tpu_torch.polypdb import builders, cli, synth
from ssl4polyp_tpu_torch.polypdb.builders import (
    FULL_COLUMNS,
    PERTURBATION_GRID,
    build_polypgen_fewshot,
    build_polypgen_pack,
    build_sun_morphology_pack,
    build_sun_pack,
    build_sun_perturbations,
    build_sun_subsets,
)
from ssl4polyp_tpu_torch.polypdb.cli import check_csv_paths
from ssl4polyp_tpu_torch.polypdb.cli import main as polypdb_main
from ssl4polyp_tpu_torch.polypdb.robustness import build_sun_test_corruptions
from ssl4polyp_tpu_torch.polypdb.synth import (
    build_synthetic_polypgen_root,
    build_synthetic_sun_root,
)

ROOT = Path(__file__).resolve().parents[1]
GENERATED_AT = "2026-01-01T00:00:00+00:00"
SUN_ROOT_ARGS = dict(pos_cases=14, frames_per_case=10, neg_sources=3, frames_per_source=80,
                     image_size=32, seed=7)
PG_ROOT_ARGS = dict(centres=3, pos_per_centre=14, neg_per_centre=4, sequences=5,
                    frames_per_sequence=12, image_size=32, seed=3)
SUN_PACK_ARGS = dict(seed=47, frames_per_case=8, cases_per_split=(8, 3, 3))
# exp5b through the two engines from one parent, fp32: the forwards differ
# by summation order and the JAX GELU's polynomial erf (as in
# test_torch_finetune_engine.py), so metric blocks agree to 1e-5 relative.
BLOCK_RTOL = 1e-5
# The exp5b run's clean rows against the parent's test exports: the same
# frames through the same forward, batched differently.
PROB_ATOL = 1e-6


def _rows(path: Path):
    with open(path, newline="", encoding="utf-8") as handle:
        reader = csv.DictReader(handle)
        return reader.fieldnames, list(reader)


def _files(directory: Path) -> dict:
    return {p.relative_to(directory).as_posix(): p.read_bytes()
            for p in sorted(directory.rglob("*")) if p.is_file()}


@pytest.fixture(autouse=True)
def pinned_clock(monkeypatch):
    """Manifests carry ``generated_at``: one instant for both packages."""
    for module in (builders, jax_builders):
        monkeypatch.setattr(module, "_now_iso", lambda: GENERATED_AT)


@pytest.fixture(scope="module")
def sun_root(tmp_path_factory):
    return build_synthetic_sun_root(tmp_path_factory.mktemp("sun_root"), **SUN_ROOT_ARGS)


@pytest.fixture(scope="module")
def sun_pack(sun_root, tmp_path_factory):
    return build_sun_pack(sun_root, tmp_path_factory.mktemp("packs") / "sun_full",
                          **SUN_PACK_ARGS)


@pytest.fixture(scope="module")
def polypgen_root(tmp_path_factory):
    return build_synthetic_polypgen_root(tmp_path_factory.mktemp("pg_root"), **PG_ROOT_ARGS)


@pytest.fixture(scope="module")
def polypgen_extended(polypgen_root, tmp_path_factory):
    return build_polypgen_pack(
        polypgen_root,
        tmp_path_factory.mktemp("pg_packs") / "polypgen_clean_test_extended",
        include_negative_sequences=True,
    )


# ---------------------------------------------------------------------------
# The port against the JAX package, byte for byte
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["sun", "polypgen"])
def test_synthetic_roots_are_byte_equal(layout, tmp_path):
    name = f"build_synthetic_{layout}_root"
    args = SUN_ROOT_ARGS if layout == "sun" else PG_ROOT_ARGS
    ours = getattr(synth, name)(tmp_path / "port", **args)
    theirs = getattr(jax_synth, name)(tmp_path / "jax", **args)
    assert ours == tmp_path / "port" and theirs == tmp_path / "jax"
    files = _files(ours)
    assert len(files) > 100 and files == _files(theirs)


def _both_write(out: Path, call):
    """``call(module)`` for the JAX then the port builders into ``out``:
    the returned paths and every file written, equal."""
    jax_result = call(jax_builders)
    jax_files = _files(out)
    shutil.rmtree(out)
    port_result = call(builders)
    port_files = _files(out)
    assert port_result == jax_result
    assert set(port_files) == set(jax_files)
    for name in jax_files:
        assert port_files[name] == jax_files[name], name
    return port_files


BUILDS = {
    "sun build": lambda m, r, out: m.build_sun_pack(r["sun"], out, **SUN_PACK_ARGS),
    "sun morph": lambda m, r, out: m.build_sun_morphology_pack(r["sun"], out, **SUN_PACK_ARGS),
    "sun subsets-canonical": lambda m, r, out: m.build_sun_subsets(
        r["sun_pack"], out, percents=(5, 25, 50, 100), seed=13),
    "sun perturbations": lambda m, r, out: m.build_sun_perturbations(
        r["sun_pack"], out, master_seed=47),
    "polypgen build": lambda m, r, out: m.build_polypgen_pack(r["polypgen"], out),
    "polypgen build --include-negative-sequences": lambda m, r, out: m.build_polypgen_pack(
        r["polypgen"], out, include_negative_sequences=True),
    "polypgen fewshot": lambda m, r, out: m.build_polypgen_fewshot(
        r["polypgen_extended"], out, budgets=(20, 60, 150), seed=13),
}


@pytest.mark.parametrize("what", list(BUILDS))
def test_builders_write_the_jax_packages_bytes(what, sun_root, sun_pack, polypgen_root,
                                               polypgen_extended, tmp_path):
    inputs = {"sun": sun_root, "sun_pack": sun_pack, "polypgen": polypgen_root,
              "polypgen_extended": polypgen_extended}
    out = tmp_path / "out"
    files = _both_write(out, lambda module: BUILDS[what](module, inputs, out))
    manifests = [name for name in files if name.endswith("manifest.yaml")]
    assert manifests and any(name.endswith(".csv") for name in files)
    for name in manifests:
        manifest = yaml.safe_load(files[name])
        assert manifest["generated_at"] == GENERATED_AT
        assert manifest.get("generator", {}).get("repo", "ssl4polyp-tpu") == "ssl4polyp-tpu"


def _too_small(tmp: Path, case: str):
    """Write a root too small for a builder; return the builder's call."""
    root = tmp / "root"
    if case == "no positive cases":
        synth.build_synthetic_sun_root(root, pos_cases=0, neg_sources=1, frames_per_source=8,
                                       image_size=8)
        return lambda m: m.build_sun_pack(root, tmp / "out")
    if case == "no negative sources":
        synth.build_synthetic_sun_root(root, pos_cases=3, frames_per_case=4, neg_sources=0,
                                       image_size=8)
        return lambda m: m.build_sun_pack(root, tmp / "out", frames_per_case=4)
    if case == "fewer cases than splits":
        synth.build_synthetic_sun_root(root, pos_cases=2, frames_per_case=4, neg_sources=3,
                                       frames_per_source=8, image_size=8)
        return lambda m: m.build_sun_pack(root, tmp / "out", frames_per_case=4)
    if case == "a split without negative chunks":
        synth.build_synthetic_sun_root(root, pos_cases=3, frames_per_case=4, neg_sources=2,
                                       frames_per_source=8, image_size=8)
        return lambda m: m.build_sun_pack(root, tmp / "out", frames_per_case=4)
    if case == "a morphology stratum smaller than the splits":
        synth.build_synthetic_sun_root(root, pos_cases=3, frames_per_case=4, neg_sources=3,
                                       frames_per_source=8, image_size=8)
        return lambda m: m.build_sun_morphology_pack(root, tmp / "out", frames_per_case=4)
    if case == "chunks shorter than a case":
        synth.build_synthetic_sun_root(root, pos_cases=3, frames_per_case=8, neg_sources=3,
                                       frames_per_source=5, image_size=8)
        return lambda m: m.build_sun_pack(root, tmp / "out", frames_per_case=6)
    assert case == "an empty polypgen root"
    (root / "C1").mkdir(parents=True)
    return lambda m: m.build_polypgen_pack(root, tmp / "out")


@pytest.mark.parametrize("case", [
    "no positive cases", "no negative sources", "fewer cases than splits",
    "a split without negative chunks", "a morphology stratum smaller than the splits",
    "chunks shorter than a case", "an empty polypgen root",
])
def test_roots_that_are_too_small_fail_with_the_jax_packages_message(case, tmp_path):
    call = _too_small(tmp_path, case)
    raised = []
    for module in (jax_builders, builders):
        with pytest.raises(ValueError) as info:
            call(module)
        raised.append(str(info.value))
    assert raised[0] == raised[1] and raised[0]


TEXT = st.text(max_size=40)


@settings(max_examples=200, deadline=None)
@given(item=TEXT, seed=st.one_of(st.integers(-2**40, 2**40), TEXT))
def test_hmac_rank_key_matches_jax(item, seed):
    assert builders.hmac_rank_key(item, seed) == jax_builders.hmac_rank_key(item, seed)


@settings(max_examples=200, deadline=None)
@given(key=st.one_of(st.integers(0, 2**32), TEXT), message=TEXT)
def test_hmac_uint32_matches_jax(key, message):
    got = builders._hmac_uint32(key, message)
    assert got == jax_builders._hmac_uint32(key, message) and 0 <= got < 2**32


@settings(max_examples=300, deadline=None)
@given(targets=st.lists(st.integers(0, 200), min_size=1, max_size=5),
       available=st.integers(0, 400))
def test_scaled_targets_match_jax(targets, available):
    outcomes = []
    for module in (jax_builders, builders):
        try:
            outcomes.append(("ok", module._scaled_targets(targets, available)))
        except ValueError as exc:
            outcomes.append(("error", str(exc)))
    assert outcomes[0] == outcomes[1]


CORRUPTIONS = {
    "blur": {"sigma": [0.5, 2.0]},
    "jpeg": {"quality": [30, 90]},
    "brightness": {"factor": [0.7]},
    "contrast": {"factor": [1.5]},
    "occlusion": {"area": [0.05, 0.3]},
}


@pytest.mark.parametrize("opencv", ["installed", "absent"])
def test_corruptions_are_byte_equal_per_variant(opencv, source_pack, tmp_path, monkeypatch):
    """With ``cv2`` where it is installed, and with its import failing in
    both packages, as on a machine without OpenCV."""
    if opencv == "absent":
        monkeypatch.setitem(sys.modules, "cv2", None)
    else:
        pytest.importorskip("cv2")
    pack, roots = source_pack
    out = tmp_path / "out"
    jax_robustness.build_sun_test_corruptions(pack, CORRUPTIONS, roots, out)
    theirs = _files(out)
    shutil.rmtree(out)
    build_sun_test_corruptions(pack, CORRUPTIONS, roots, out)
    ours = _files(out)
    assert set(ours) == set(theirs)
    assert sum(name.endswith("test.csv") for name in ours) == 8
    for name in theirs:
        assert ours[name] == theirs[name], name


def _cli_run(module, argv):
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        module.main(argv)
    return printed.getvalue()


def _cli_cases(tmp: Path, sun_root: Path, sun_pack: Path, polypgen_root: Path,
               polypgen_extended: Path, source_pack) -> dict:
    pack, roots = source_pack
    spec = tmp / "spec.yaml"
    spec.write_text(yaml.safe_dump({"jpeg": {"quality": [40]}, "occlusion": {"area": [0.2]}}))
    roots_json = tmp / "roots.json"
    roots_json.write_text(json.dumps(roots))
    out = str(tmp / "out")
    return {
        "synth": ["synth", "--out", out, "--name", "tiny", "--frames-per-split", "4",
                  "--image-size", "16", "--splits", "train", "test"],
        "synth-root sun": ["synth-root", "--layout", "sun", "--out", out, "--image-size", "16",
                           "--scale", "0.25"],
        "synth-root polypgen": ["synth-root", "--layout", "polypgen", "--out", out,
                                "--image-size", "16", "--scale", "0.25", "--seed", "2"],
        "sun build": ["sun", "build", "--root", str(sun_root), "--out", out,
                      "--frames-per-case", "8", "--cases-per-split", "8", "3", "3"],
        "sun morph": ["sun", "morph", "--root", str(sun_root), "--out", out, "--seed", "13",
                      "--frames-per-case", "8", "--cases-per-split", "8", "3", "3"],
        "sun subsets-canonical": ["sun", "subsets-canonical", "--pack", str(sun_pack),
                                  "--percents", "10", "50", "100", "--out", out],
        "sun perturbations": ["sun", "perturbations", "--pack", str(sun_pack), "--out", out,
                              "--master-seed", "13"],
        "sun corrupt": ["sun", "corrupt", "--pack", str(pack), "--spec", str(spec),
                        "--roots", str(roots_json), "--out", out],
        "polypgen build": ["polypgen", "build", "--root", str(polypgen_root), "--out", out,
                           "--include-negative-sequences"],
        "polypgen fewshot": ["polypgen", "fewshot", "--parent-pack", str(polypgen_extended),
                             "--out", out, "--budgets", "20", "60"],
        "no subcommand": [],
    }


CLI_CASES = ["synth", "synth-root sun", "synth-root polypgen", "sun build", "sun morph",
             "sun subsets-canonical", "sun perturbations", "sun corrupt", "polypgen build",
             "polypgen fewshot", "no subcommand"]


@pytest.mark.parametrize("case", CLI_CASES)
def test_cli_subcommands_match_jax(case, sun_root, sun_pack, polypgen_root, polypgen_extended,
                                   source_pack, tmp_path):
    argv = _cli_cases(tmp_path, sun_root, sun_pack, polypgen_root, polypgen_extended,
                      source_pack)[case]
    out = tmp_path / "out"
    theirs = _cli_run(jax_cli, argv)
    jax_files = _files(out) if out.exists() else {}
    if out.exists():
        shutil.rmtree(out)
    ours = _cli_run(cli, argv)
    assert ours == theirs and bool(ours) == (case != "sun corrupt")
    assert (_files(out) if out.exists() else {}) == jax_files
    assert bool(jax_files) == (case != "no subcommand")


def test_cli_runs_as_a_module(tmp_path):
    out = tmp_path / "root"
    argv = ["synth-root", "--layout", "sun", "--out", str(out), "--image-size", "16",
            "--scale", "0.25"]
    result = subprocess.run([sys.executable, "-m", "ssl4polyp_tpu_torch.polypdb.cli", *argv],
                            cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr
    ours = _files(out)
    shutil.rmtree(out)
    assert result.stdout == _cli_run(jax_cli, argv)
    assert ours == _files(out) and len(ours) == 3 * 4 + 3 * 12 + 1


# ---------------------------------------------------------------------------
# test_pack_builders.py through the port
# ---------------------------------------------------------------------------


class TestSunBuild:
    def test_schema_is_the_28_column_reference_header(self, sun_pack):
        header, rows = _rows(sun_pack / "train.csv")
        assert header == FULL_COLUMNS
        assert len(FULL_COLUMNS) == 28
        assert rows, "train split must not be empty"

    def test_case_disjointness_and_balance(self, sun_pack):
        seen = {}
        for split in ("train", "val", "test"):
            _, rows = _rows(sun_pack / f"{split}.csv")
            cases = {r["case_id"] for r in rows}
            for case in cases:
                assert case not in seen, f"case {case} leaks {seen.get(case)}->{split}"
                seen[case] = split
            pos = {r["case_id"] for r in rows if r["label"] == "1"}
            neg = cases - pos
            assert len(pos) == len(neg)
            per_case = {}
            for r in rows:
                per_case[r["case_id"]] = per_case.get(r["case_id"], 0) + 1
            assert set(per_case.values()) == {8}

    def test_negative_rows_are_synthetic_chunks(self, sun_pack):
        _, rows = _rows(sun_pack / "train.csv")
        negatives = [r for r in rows if r["label"] == "0"]
        assert negatives
        for row in negatives:
            assert row["synthetic_case"] == "True"
            assert row["case_id"].startswith("NEG_SUN_case")
            assert "_v" in row["case_id"]
            assert int(row["chunk_start"]) <= int(row["frame_index"]) <= int(row["chunk_end"])
            assert row["source_case_id"] == row["case_id"].rsplit("_v", 1)[0]

    def test_negative_sources_are_split_disjoint(self, sun_pack):
        source_split = {}
        for split in ("train", "val", "test"):
            _, rows = _rows(sun_pack / f"{split}.csv")
            for row in rows:
                if row["label"] == "0":
                    previous = source_split.setdefault(row["source_case_id"], split)
                    assert previous == split

    def test_manifest_hashes_and_counts_verify(self, sun_pack):
        manifest = yaml.safe_load((sun_pack / "manifest.yaml").read_text())
        for split in ("train", "val", "test"):
            digest = hashlib.sha256((sun_pack / f"{split}.csv").read_bytes()).hexdigest()
            assert manifest["hashes"][split] == digest
            _, rows = _rows(sun_pack / f"{split}.csv")
            counts = manifest["counts"][split]
            assert counts["frames"] == len(rows)
            assert counts["pos"] == sum(1 for r in rows if r["label"] == "1")
        assert manifest["policy"]["selection"] == "hmac_sha256(case_id,seed)"
        assert manifest["frame_sampling"]["salt_id"] == "seed-47"

    def test_pack_loads_through_strict_loader(self, sun_pack, sun_root, tmp_path):
        from ssl4polyp_tpu_torch.data.packs import create_classification_datasets

        datasets = create_classification_datasets(
            train_spec=sun_pack, val_spec=sun_pack, test_spec=sun_pack,
            roots_map={"sun": str(sun_root)},
            snapshot_dir=tmp_path / "snap",
            check_exists=True,
        )
        assert set(datasets) == {"train", "val", "test"}
        assert len(datasets["train"]) == 16 * 8  # (8 pos + 8 neg cases) x 8 frames
        assert Path(datasets["train"].paths[0]).exists()

    def test_deterministic_rebuild(self, sun_root, tmp_path):
        first = build_sun_pack(sun_root, tmp_path / "a", **SUN_PACK_ARGS)
        second = build_sun_pack(sun_root, tmp_path / "b", **SUN_PACK_ARGS)
        for split in ("train", "val", "test"):
            assert (first / f"{split}.csv").read_bytes() == (second / f"{split}.csv").read_bytes()


class TestSunMorphology:
    def test_splits_are_morphology_stratified(self, sun_root, tmp_path):
        pack = build_sun_morphology_pack(sun_root, tmp_path / "sun_morphology", **SUN_PACK_ARGS)
        for split in ("train", "val"):
            _, rows = _rows(pack / f"{split}.csv")
            morphs = {r["morphology"] for r in rows if r["label"] == "1"}
            assert morphs == {"flat", "polypoid"}, f"{split} lost a stratum"
        manifest = yaml.safe_load((pack / "manifest.yaml").read_text())
        assert "stratify=morphology" in manifest["policy"]["balance"]


class TestSunSubsets:
    def test_canonical_nesting_and_manifests(self, sun_pack, tmp_path):
        subsets = build_sun_subsets(sun_pack, tmp_path / "sun_subsets",
                                    percents=(25, 50, 100), seed=13)
        cases = {}
        for subset in subsets:
            _, rows = _rows(subset / "train.csv")
            cases[subset.name] = {r["case_id"] for r in rows}
            manifest = yaml.safe_load((subset / "manifest.yaml").read_text())
            digest = hashlib.sha256((subset / "train.csv").read_bytes()).hexdigest()
            assert manifest["hashes"]["train"] == digest
        assert cases["sun_p25"] < cases["sun_p50"] < cases["sun_p100"]
        _, full_rows = _rows(sun_pack / "train.csv")
        assert cases["sun_p100"] == {r["case_id"] for r in full_rows}


class TestSunPerturbations:
    def test_grid_shape_and_seed_rule(self, sun_pack, tmp_path):
        grid = build_sun_perturbations(sun_pack, tmp_path / "perturb", master_seed=47)
        _, clean_rows = _rows(sun_pack / "test.csv")
        header, rows = _rows(grid / "test.csv")
        assert header == FULL_COLUMNS
        assert len(rows) == len(clean_rows) * len(PERTURBATION_GRID)
        assert len(PERTURBATION_GRID) == 16
        by_id = {}
        for row in rows:
            by_id.setdefault(row["perturbation_id"], []).append(row)
        assert set(by_id) == {str(s["id"]) for s in PERTURBATION_GRID}
        probe = by_id["blur_sigma_1p0"][0]
        expected = int.from_bytes(
            hmac.new(b"47", f"{probe['orig_frame_id']}:blur_sigma_1p0".encode(),
                     hashlib.sha256).digest()[:4], "big")
        assert int(probe["rng_seed"]) == expected
        assert probe["render_in_pipeline"] == "True"
        assert probe["blur_sigma"] == "1.0"
        clean = by_id["clean"][0]
        assert clean["blur_sigma"] == "-1.0" and clean["jpeg_q"] == "-1"

    def test_renderer_consumes_generated_rows(self, sun_pack, tmp_path):
        from PIL import Image

        from ssl4polyp_tpu_torch.data.transforms import PerRowPerturber

        grid = build_sun_perturbations(sun_pack, tmp_path / "perturb2", master_seed=47)
        _, rows = _rows(grid / "test.csv")
        perturber = PerRowPerturber()
        rng = np.random.default_rng(0)
        frame = rng.integers(0, 255, (32, 32, 3), dtype=np.uint8)
        outputs = {}
        for wanted in ("clean", "blur_sigma_2p0", "occ_a0p20", "bc_b0p6_c0p6"):
            row = next(r for r in rows if r["perturbation_id"] == wanted)
            outputs[wanted] = np.asarray(perturber(Image.fromarray(frame), row))
        assert np.array_equal(outputs["clean"], frame)
        for name in ("blur_sigma_2p0", "occ_a0p20", "bc_b0p6_c0p6"):
            assert not np.array_equal(outputs[name], frame), name


class TestPolypgenBuild:
    def test_clean_pack_excludes_sequences(self, polypgen_root, tmp_path):
        pack = build_polypgen_pack(polypgen_root, tmp_path / "clean")
        _, rows = _rows(pack / "test.csv")
        assert all(not r["frame_id"].startswith("NEGSEQ.") for r in rows)
        assert {r["case_id"] for r in rows} == {"C1", "C2", "C3"}
        assert sum(1 for r in rows if r["label"] == "1") == 3 * 14
        assert sum(1 for r in rows if r["label"] == "0") == 3 * 4

    def test_extended_pack_appends_sequences(self, polypgen_extended):
        _, rows = _rows(polypgen_extended / "test.csv")
        seq_rows = [r for r in rows if r["frame_id"].startswith("NEGSEQ.")]
        assert len(seq_rows) == 5 * 12
        assert all(r["case_id"] == "None" and r["label"] == "0" for r in seq_rows)
        manifest = yaml.safe_load((polypgen_extended / "manifest.yaml").read_text())
        assert manifest["counts"]["test"]["neg"] == 3 * 4 + 5 * 12

    def test_pack_loads_through_strict_loader(self, polypgen_extended, polypgen_root):
        from ssl4polyp_tpu_torch.configs.manifests import load_pack

        pack = load_pack(
            test=polypgen_extended / "test.csv",
            manifest_yaml=polypgen_extended / "manifest.yaml",
            roots_map={"polypgen_clean": str(polypgen_root)},
        )
        assert len(pack["test"].rows) == 3 * (14 + 4) + 5 * 12


class TestPolypgenFewshot:
    def test_budgets_and_val_fraction_rule(self, polypgen_extended, tmp_path):
        packs = build_polypgen_fewshot(
            polypgen_extended, tmp_path / "fewshot", budgets=(20, 40), seed=13,
        )
        for pack, budget in zip(packs, (20, 40)):
            manifest = yaml.safe_load((pack / "manifest.yaml").read_text())
            policy = manifest["policy"]
            assert policy["fewshot_budget_S"] == budget
            assert policy["val_fraction_target"] == 0.1  # budget < 100
            counts = manifest["counts"]
            realized = counts["train"]["frames"] + counts["val"]["frames"]
            assert realized == min(budget, realized)
            assert counts["train"]["pos"] + counts["val"]["pos"] == budget // 2

    def test_sequence_disjointness_across_splits(self, polypgen_extended, tmp_path):
        # budget 60 > 2*pool(12) forces the sequence phase
        (pack,) = build_polypgen_fewshot(
            polypgen_extended, tmp_path / "fs", budgets=(60,), seed=13,
        )
        seqs = {}
        for split in ("train", "val", "test"):
            _, rows = _rows(pack / f"{split}.csv")
            for row in rows:
                if row["frame_id"].startswith("NEGSEQ."):
                    seq = row["frame_id"].split(".")[1]
                    previous = seqs.setdefault(seq, split)
                    assert previous == split, f"sequence {seq} spans splits"

    def test_pool_first_and_sequence_cap(self, polypgen_extended, tmp_path):
        (pack,) = build_polypgen_fewshot(
            polypgen_extended, tmp_path / "fs2", budgets=(60,), seed=13,
            max_frames_per_sequence=5,
        )
        _, train_rows = _rows(pack / "train.csv")
        _, val_rows = _rows(pack / "val.csv")
        picked = [r for r in train_rows + val_rows if r["label"] == "0"]
        pool = [r for r in picked if not r["frame_id"].startswith("NEGSEQ.")]
        assert len(pool) == 3 * 4  # entire pool consumed before sequences
        per_seq = {}
        for row in picked:
            if row["frame_id"].startswith("NEGSEQ."):
                seq = row["frame_id"].split(".")[1]
                per_seq[seq] = per_seq.get(seq, 0) + 1
        assert per_seq and max(per_seq.values()) <= 5

    def test_test_split_is_complement_minus_touched_sequences(
            self, polypgen_extended, tmp_path):
        (pack,) = build_polypgen_fewshot(
            polypgen_extended, tmp_path / "fs3", budgets=(60,), seed=13,
        )
        _, parent_rows = _rows(polypgen_extended / "test.csv")
        split_ids = {}
        for split in ("train", "val", "test"):
            _, rows = _rows(pack / f"{split}.csv")
            split_ids[split] = {r["frame_id"] for r in rows}
        assert not (split_ids["train"] & split_ids["test"])
        assert not (split_ids["val"] & split_ids["test"])
        touched = {fid.split(".")[1] for fid in (split_ids["train"] | split_ids["val"])
                   if fid.startswith("NEGSEQ.")}
        for fid in {r["frame_id"] for r in parent_rows} - set().union(*split_ids.values()):
            assert fid.startswith("NEGSEQ.") and fid.split(".")[1] in touched


class TestEnginePipeline:
    def test_generated_pack_trains_with_hash_verification(self, tmp_path):
        """run_exp1-equivalent: a pack the port's builder wrote drives the
        port's classification engine (strict manifest/hash checks on)."""
        from ssl4polyp_tpu_torch.training import protocol as proto
        from ssl4polyp_tpu_torch.training.classification import (
            build_run,
            run_classification_training,
        )
        from tests.test_classification_engine import TINY_MODEL, tiny_cfg

        root = build_synthetic_sun_root(
            tmp_path / "sun_root", pos_cases=4, frames_per_case=6,
            neg_sources=3, frames_per_source=16, image_size=32, seed=5,
        )
        packs_dir = tmp_path / "data_packs"
        build_sun_pack(root, packs_dir / "sun_full", seed=47,
                       frames_per_case=4, cases_per_split=(2, 1, 1))
        cfg = tiny_cfg()
        cfg["epochs"] = 1
        plan = proto.resolve_run_plan(cfg, model_key="sup_imnet", seed=13)
        ctx = build_run(plan, output_dir=tmp_path / "out", pack_root=packs_dir,
                        model_overrides=TINY_MODEL, device="cpu")
        summary = run_classification_training(ctx)
        metrics_path = Path(summary["metrics_path"])
        assert metrics_path.exists()


# ---------------------------------------------------------------------------
# test_polypdb.py through the port
# ---------------------------------------------------------------------------


@pytest.fixture
def source_pack(tmp_path):
    from PIL import Image

    images = tmp_path / "images"
    (images / "frames").mkdir(parents=True)
    rng = np.random.default_rng(0)
    rows = []
    for i in range(4):
        rel = f"frames/img_{i}.png"
        Image.fromarray(
            rng.integers(30, 220, (40, 40, 3), dtype=np.uint8)
        ).save(images / rel)
        rows.append({"frame_path": f"sun/{rel}", "label": str(i % 2), "case_id": f"c{i}"})
    pack = tmp_path / "pack"
    pack.mkdir()
    with open(pack / "test.csv", "w", newline="") as handle:
        writer = csv.DictWriter(handle, fieldnames=["frame_path", "label", "case_id"])
        writer.writeheader()
        writer.writerows(rows)
    return pack, {"sun": str(images)}


def test_build_corruptions(source_pack, tmp_path):
    pack, roots = source_pack
    spec = {
        "blur": {"sigma": [1.0, 2.0]},
        "jpeg": {"quality": [30]},
        "brightness": {"factor": [0.7]},
        "contrast": {"factor": [1.5]},
        "occlusion": {"area": [0.2]},
    }
    out = tmp_path / "out"
    build_sun_test_corruptions(pack, spec, roots, out)

    dirs = sorted(p.name for p in out.iterdir() if p.is_dir())
    assert dirs == ["blur_1.0", "blur_2.0", "brightness_0.7", "contrast_1.5",
                    "jpeg_30", "occlusion_0.2"]
    manifest = yaml.safe_load((out / "manifest.yaml").read_text())
    assert manifest["policy"]["robustness_rng"] == 12345

    with open(out / "blur_1.0" / "test.csv") as handle:
        rows = list(csv.DictReader(handle))
    assert rows[0]["variant"] == "blur"
    assert rows[0]["severity"] == "1.0"
    corrupted = out / "blur_2.0" / "sun" / "frames" / "img_0.png"
    assert corrupted.exists()
    from PIL import Image

    original = np.asarray(Image.open(Path(roots["sun"]) / "frames" / "img_0.png"))
    blurred = np.asarray(Image.open(corrupted))
    assert not np.array_equal(original, blurred)


def test_occlusion_determinism(source_pack, tmp_path):
    pack, roots = source_pack
    spec = {"occlusion": {"area": [0.3]}}
    out_a, out_b = tmp_path / "a", tmp_path / "b"
    build_sun_test_corruptions(pack, spec, roots, out_a)
    build_sun_test_corruptions(pack, spec, roots, out_b)
    from PIL import Image

    img_a = np.asarray(Image.open(out_a / "occlusion_0.3" / "sun" / "frames" / "img_1.png"))
    img_b = np.asarray(Image.open(out_b / "occlusion_0.3" / "sun" / "frames" / "img_1.png"))
    np.testing.assert_array_equal(img_a, img_b)
    assert (img_a == 0).all(axis=-1).sum() > 0  # a black box exists


def test_check_csv_paths(source_pack, tmp_path):
    pack, roots = source_pack
    assert check_csv_paths(pack / "test.csv", roots) == []
    missing = check_csv_paths(pack / "test.csv", {"sun": str(tmp_path / "nope")})
    assert len(missing) == 4


def test_cli_end_to_end(source_pack, tmp_path):
    pack, roots = source_pack
    spec_path = tmp_path / "spec.yaml"
    spec_path.write_text(yaml.safe_dump({"jpeg": {"quality": [40]}}))
    roots_path = tmp_path / "roots.json"
    roots_path.write_text(json.dumps(roots))
    out = tmp_path / "cli_out"
    polypdb_main([
        "sun", "corrupt",
        "--pack", str(pack),
        "--spec", str(spec_path),
        "--roots", str(roots_path),
        "--out", str(out),
    ])
    assert (out / "jpeg_40" / "test.csv").exists()


# ---------------------------------------------------------------------------
# The slice: exp5b from packs the port built, through both engines
# ---------------------------------------------------------------------------

TINY_RUN = {"epochs": 1, "batch_size": 8, "image_size": 32, "num_workers": 2, "amp": False,
            "log_interval": 1}


def _plan(proto, exp: str, output_dir: Path):
    from ssl4polyp_tpu_torch.configs.layered import load_layered_config

    return proto.resolve_run_plan(load_layered_config(exp), model_key="sup_imnet", seed=13,
                                  overrides=dict(TINY_RUN), output_dir=str(output_dir))


def test_exp5b_from_port_built_packs_through_both_engines(tmp_path):
    """The port's builders write sun_full and its 16-variant perturbation
    grid; exp1's sup_imnet arm (tiny, fp32, one epoch) gives the canonical
    SUN parent under ``<root>/classification``; exp5b then finds it there,
    as a user's run does, and evaluates every row through the port's engine
    and through the JAX engine: the frozen tau bit-equal to the parent's,
    every ``per_tag`` block within BLOCK_RTOL, and the clean rows'
    probabilities equal to the parent's test exports within PROB_ATOL."""
    from ssl4polyp_tpu.training import classification as jax_engine
    from ssl4polyp_tpu.training import protocol as jax_proto
    from ssl4polyp_tpu_torch.training import protocol as proto
    from ssl4polyp_tpu_torch.training.classification import (
        build_run,
        run_classification_training,
    )
    from tests.test_classification_engine import TINY_MODEL

    root = build_synthetic_sun_root(tmp_path / "sun_root", pos_cases=9, frames_per_case=6,
                                    neg_sources=3, frames_per_source=12, image_size=32, seed=11)
    packs = tmp_path / "data_packs"
    build_sun_pack(root, packs / "sun_full", frames_per_case=4, cases_per_split=(3, 3, 3))
    build_sun_perturbations(packs / "sun_full", packs / "sun_test_perturbations")
    _, clean = _rows(packs / "sun_full" / "test.csv")
    assert len(clean) == 24

    classification_root = tmp_path / "classification"
    parent_ctx = build_run(_plan(proto, "exp/exp1", classification_root / "exp1_sup_imnet_seed13"),
                           output_dir=classification_root / "exp1_sup_imnet_seed13",
                           pack_root=packs, model_overrides=TINY_MODEL,
                           exp_config_name="exp/exp1.yaml", device="cpu")
    parent = run_classification_training(parent_ctx, thresholds_root=tmp_path / "th")
    parent_test = {r["frame_id"]: float(r["prob"]) for r in _rows(
        parent_ctx.layout.output_dir / f"{parent_ctx.layout.stem}_test_outputs.csv")[1]}
    assert len(parent_test) == 24

    runs = {}
    for name, protocol, build, train in (
            ("port", proto, lambda plan, out: build_run(
                plan, output_dir=out, pack_root=packs, model_overrides=TINY_MODEL,
                exp_config_name="exp/exp5b.yaml", device="cpu"), run_classification_training),
            ("jax", jax_proto, lambda plan, out: jax_engine.build_run(
                plan, output_dir=out, pack_root=packs, model_overrides=TINY_MODEL,
                exp_config_name="exp/exp5b.yaml"), jax_engine.run_classification_training)):
        out = classification_root / f"exp5b_{name}"
        plan = _plan(protocol, "exp/exp5b", out)
        assert Path(plan.parent_checkpoint) == parent_ctx.layout.checkpoint_path
        ctx = build(plan, out)
        summary = train(ctx)
        payload = json.loads(Path(summary["metrics_path"]).read_text())
        runs[name] = (ctx, payload)

    grid = {str(spec["id"]) for spec in PERTURBATION_GRID}
    port_ctx, port_payload = runs["port"]
    _, jax_payload = runs["jax"]
    for payload in (port_payload, jax_payload):
        assert payload["eval_only"] is True
        assert payload["thresholds"]["primary"]["tau"] == parent["tau"]
        assert set(payload["test_perturbations"]["per_tag"]) == grid | {"ALL-perturbed"}
    for tag, block in port_payload["test_perturbations"]["per_tag"].items():
        theirs = jax_payload["test_perturbations"]["per_tag"][tag]
        assert set(block) == set(theirs), tag
        for key, value in block.items():
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                assert value == pytest.approx(theirs[key], rel=BLOCK_RTOL, abs=BLOCK_RTOL), \
                    (tag, key)
    _, rows = _rows(port_ctx.layout.output_dir / f"{port_ctx.layout.stem}_test_outputs.csv")
    assert len(rows) == 16 * 24
    clean_rows = [r for r in rows if r["perturbation_tag"] == "clean"]
    assert len(clean_rows) == 24
    for row in clean_rows:
        assert abs(float(row["prob"]) - parent_test[row["frame_id"]]) <= PROB_ATOL
