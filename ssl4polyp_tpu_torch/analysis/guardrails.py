"""Strict metrics.json validation before any number enters a report.

Re-creates the reference guardrail layer (``analysis/result_loader.py`` +
``reporting/threshold_specs.py``): schema blocks, per-experiment expected
threshold policies (with ``${val_path}`` binding), confusion-matrix vs class
count consistency, prevalence recomputation, and curve-export digest checks.
Violations raise :class:`GuardrailViolation` — reports never silently skip
bad runs.

The port's copy of ``ssl4polyp_tpu/analysis/guardrails.py``, exp5b's
threshold specs included.
"""

from __future__ import annotations

import hashlib
import json
import math
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict, Mapping, Optional, Sequence

import numpy as np

__all__ = [
    "GuardrailViolation",
    "ResultLoader",
    "LoadedResult",
    "THRESHOLD_SPECS",
    "compute_file_sha256",
    "build_report_manifest",
]


class GuardrailViolation(RuntimeError):
    pass


THRESHOLD_SPECS: Dict[str, Dict[str, Any]] = {
    "exp1": {
        "primary": {"policy": "f1_opt_on_val", "split": "${val_path}", "require": ["tau", "split", "epoch"]},
        "sensitivity": {"policy": "youden_on_val", "split": "${val_path}", "require": ["tau", "split", "epoch"]},
    },
    "exp2": {
        "primary": {"policy": "f1_opt_on_val", "split": "${val_path}", "require": ["tau", "split", "epoch"]},
        "sensitivity": {"policy": "youden_on_val", "split": "${val_path}", "require": ["tau", "split", "epoch"]},
    },
    "exp3b": {
        "primary": {"policy": "f1_opt_on_val", "split": "${val_path}", "require": ["tau", "split", "epoch"]},
        "sensitivity": {"policy": "youden_on_val", "split": "${val_path}", "require": ["tau", "split", "epoch"]},
        "expected_val_path": "sun_morphology/val",
    },
    "exp4": {
        "primary": {"policy": "f1_opt_on_val", "split": "${val_path}", "require": ["tau", "split", "epoch"]},
        "sensitivity": {"policy": "youden_on_val", "split": "${val_path}", "require": ["tau", "split", "epoch"]},
    },
    "exp5a": {
        "primary": {"policy": "sun_val_frozen", "source_split": "sun_full/val", "require": ["tau", "source_split"]},
    },
    "exp5b": {
        "primary": {"policy": "sun_val_frozen", "source_split": "sun_full/val", "require": ["tau", "source_split"]},
    },
    "exp5c": {
        "primary": {"policy": "sun_val_frozen", "source_split": "sun_full/val", "require": ["tau", "source_split"]},
        "sensitivity": {"policy": "val_opt_youden", "split": "${val_path}", "require": ["tau", "split", "epoch"]},
    },
}


def compute_file_sha256(path: Path) -> str:
    digest = hashlib.sha256()
    with open(path, "rb") as handle:
        for chunk in iter(lambda: handle.read(1 << 20), b""):
            digest.update(chunk)
    return digest.hexdigest()


def _as_float(value: object) -> Optional[float]:
    if isinstance(value, (int, float, np.integer, np.floating)):
        number = float(value)
    elif isinstance(value, str):
        try:
            number = float(value.strip())
        except ValueError:
            return None
    else:
        return None
    return number if math.isfinite(number) else None


def _as_int(value: object) -> Optional[int]:
    number = _as_float(value)
    if number is None:
        return None
    rounded = round(number)
    return int(rounded) if math.isclose(number, rounded, abs_tol=1e-9) else None


def normalise_manifest_path(candidate: object) -> str:
    text = str(candidate).strip().replace("\\", "/")
    while text.startswith("./"):
        text = text[2:]
    text = text.lstrip("/")
    if "/data_packs/" in text:
        text = text.split("/data_packs/", 1)[1]
    if text.startswith("data_packs/"):
        text = text[len("data_packs/"):]
    if text.endswith(".csv"):
        text = text[:-4]
    return text


@dataclass(frozen=True)
class LoadedResult:
    metrics_path: Path
    payload: Mapping[str, Any]
    primary_metrics: Dict[str, float]
    sensitivity_metrics: Dict[str, float]


class ResultLoader:
    def __init__(
        self,
        exp_id: str,
        *,
        required_curve_keys: Sequence[str] = (),
        strict: bool = True,
        enforce_curve_exports: bool = True,
        enforce_csv_hashes: bool = True,
    ) -> None:
        if exp_id not in THRESHOLD_SPECS:
            raise GuardrailViolation(f"Unknown experiment id {exp_id!r}")
        self.exp_id = exp_id
        self.required_curve_keys = tuple(required_curve_keys)
        self.strict = strict
        self.enforce_curve_exports = enforce_curve_exports
        self.enforce_csv_hashes = enforce_csv_hashes
        self._curve_digests: Dict[str, str] = {}
        self._csv_digest_registry: Dict[str, str] = {}
        self.loaded_runs: list[Dict[str, Any]] = []

    # ------------------------------------------------------------------

    def load(self, metrics_path: str | Path) -> LoadedResult:
        metrics_path = Path(metrics_path)
        payload = json.loads(metrics_path.read_text(encoding="utf-8"))
        return self.extract(metrics_path, payload)

    def extract(self, metrics_path: Path, payload: Mapping[str, Any]) -> LoadedResult:
        normalised = self.validate(metrics_path, payload)
        return LoadedResult(
            metrics_path=metrics_path,
            payload=normalised,
            primary_metrics=self._metric_block(normalised.get("test_primary")),
            sensitivity_metrics=self._metric_block(normalised.get("test_sensitivity")),
        )

    def validate(self, metrics_path: Path, payload: Mapping[str, Any]) -> Dict[str, Any]:
        if not isinstance(payload, Mapping):
            raise GuardrailViolation(f"{metrics_path}: payload must be a mapping")
        normalised = self._strip_debug(dict(payload))

        for key in normalised:
            if isinstance(key, str) and key.startswith("eval_") and key != "eval_only":
                raise GuardrailViolation(
                    f"{metrics_path}: disallowed evaluation key {key!r}"
                )

        spec = THRESHOLD_SPECS[self.exp_id]
        val_path = self._validate_schema(metrics_path, normalised, spec)
        self._validate_thresholds(metrics_path, normalised, val_path, spec)

        if "sensitivity" in spec:
            if not isinstance(normalised.get("test_sensitivity"), Mapping):
                raise GuardrailViolation(
                    f"{metrics_path}: missing test_sensitivity block"
                )
        elif "test_sensitivity" in normalised:
            raise GuardrailViolation(
                f"{metrics_path}: unexpected test_sensitivity block"
            )

        self._validate_confusion(metrics_path, normalised, "test_primary")
        self._validate_confusion(metrics_path, normalised, "test_sensitivity")
        self._validate_curves(metrics_path, normalised)
        self._validate_csv_hashes(metrics_path, normalised)
        self._register(metrics_path, normalised)
        return normalised

    # ------------------------------------------------------------------

    @staticmethod
    def _strip_debug(obj: Any) -> Any:
        if isinstance(obj, Mapping):
            return {
                str(k): ResultLoader._strip_debug(v)
                for k, v in obj.items()
                if not str(k).startswith("debug")
            }
        if isinstance(obj, list):
            return [ResultLoader._strip_debug(v) for v in obj]
        return obj

    def _validate_schema(
        self, metrics_path: Path, payload: Mapping[str, Any], spec: Mapping[str, Any]
    ) -> Optional[str]:
        eval_only = bool(payload.get("eval_only"))
        required = ["thresholds", "data", "test_primary"] + ([] if eval_only else ["val"])
        for key in required:
            if key not in payload:
                raise GuardrailViolation(f"{metrics_path}: missing block {key!r}")
        data = payload.get("data")
        if not isinstance(data, Mapping):
            raise GuardrailViolation(f"{metrics_path}: data block must be a mapping")
        present = {}
        for split in ("train", "val", "test"):
            entry = data.get(split)
            if entry is None:
                continue
            if not isinstance(entry, Mapping):
                raise GuardrailViolation(f"{metrics_path}: data.{split} must be a mapping")
            for field in ("path", "sha256"):
                value = entry.get(field)
                if not isinstance(value, str) or not value.strip():
                    raise GuardrailViolation(
                        f"{metrics_path}: data.{split}.{field} is required"
                    )
            present[split] = entry
        if not present:
            raise GuardrailViolation(f"{metrics_path}: data block has no splits")
        if eval_only:
            if "test" not in present:
                raise GuardrailViolation(f"{metrics_path}: eval_only needs data.test")
        else:
            missing = [s for s in ("train", "val", "test") if s not in present]
            if missing:
                raise GuardrailViolation(f"{metrics_path}: missing data splits {missing}")

        val_path = None
        if "val" in present:
            val_path = str(present["val"]["path"]).strip()
            expected = spec.get("expected_val_path")
            if expected:
                allowed = {normalise_manifest_path(e) for e in (
                    expected if isinstance(expected, (list, tuple)) else [expected]
                )}
                if normalise_manifest_path(val_path) not in allowed:
                    raise GuardrailViolation(
                        f"{metrics_path}: data.val.path must be one of {sorted(allowed)} "
                        f"(found {val_path!r})"
                    )
        if not isinstance(payload.get("test_primary"), Mapping):
            raise GuardrailViolation(f"{metrics_path}: test_primary must be a mapping")
        if not eval_only and not isinstance(payload.get("val"), Mapping):
            raise GuardrailViolation(f"{metrics_path}: val must be a mapping")
        return val_path

    def _validate_thresholds(
        self,
        metrics_path: Path,
        payload: Mapping[str, Any],
        val_path: Optional[str],
        spec: Mapping[str, Any],
    ) -> None:
        thresholds = payload.get("thresholds")
        if not isinstance(thresholds, Mapping):
            raise GuardrailViolation(f"{metrics_path}: missing thresholds block")

        def check(slot: str, slot_spec: Mapping[str, Any]) -> None:
            block = thresholds.get(slot)
            if not isinstance(block, Mapping):
                raise GuardrailViolation(f"{metrics_path}: thresholds.{slot} missing")
            if block.get("policy") != slot_spec["policy"]:
                raise GuardrailViolation(
                    f"{metrics_path}: thresholds.{slot}.policy="
                    f"{block.get('policy')!r} != {slot_spec['policy']!r}"
                )
            missing = [f for f in slot_spec.get("require", ()) if f not in block]
            if missing:
                raise GuardrailViolation(
                    f"{metrics_path}: thresholds.{slot} missing fields {missing}"
                )
            if "tau" in block:
                tau = _as_float(block.get("tau"))
                if tau is None or not 0.0 <= tau <= 1.0:
                    raise GuardrailViolation(
                        f"{metrics_path}: thresholds.{slot}.tau out of [0,1]"
                    )
            if "epoch" in block and _as_int(block.get("epoch")) is None:
                raise GuardrailViolation(
                    f"{metrics_path}: thresholds.{slot}.epoch must be an integer"
                )
            if "split" in slot_spec:
                if not val_path:
                    raise GuardrailViolation(
                        f"{metrics_path}: thresholds.{slot}.split declared but no data.val.path"
                    )
                expected = slot_spec["split"].replace("${val_path}", val_path)
                if block.get("split") != expected:
                    raise GuardrailViolation(
                        f"{metrics_path}: thresholds.{slot}.split="
                        f"{block.get('split')!r} != {expected!r}"
                    )
            if block.get("policy") == "sun_val_frozen":
                if block.get("source_split") != slot_spec.get("source_split"):
                    raise GuardrailViolation(
                        f"{metrics_path}: thresholds.{slot}.source_split must be "
                        f"{slot_spec.get('source_split')!r}"
                    )
                self._validate_frozen_provenance(metrics_path, slot, block, slot_spec)

        check("primary", spec["primary"])
        if "sensitivity" in spec:
            check("sensitivity", spec["sensitivity"])
        elif "sensitivity" in thresholds:
            raise GuardrailViolation(
                f"{metrics_path}: unexpected thresholds.sensitivity"
            )

    def _validate_frozen_provenance(
        self,
        metrics_path: Path,
        slot: str,
        block: Mapping[str, Any],
        slot_spec: Mapping[str, Any],
    ) -> None:
        """Frozen-τ records must carry auditable source provenance.

        The reference annotates frozen thresholds with the checkpoint they came
        from (``metrics/thresholds.py:393-463``) but never verifies it on the
        way back in; here the report layer refuses frozen records that lack a
        ``notes.source_checkpoint`` or whose recorded source split contradicts
        the expected SUN validation split.
        """
        if not self.strict:
            return
        notes = block.get("notes")
        if not isinstance(notes, Mapping):
            raise GuardrailViolation(
                f"{metrics_path}: thresholds.{slot} (sun_val_frozen) missing notes block"
            )
        source_ckpt = notes.get("source_checkpoint")
        if not isinstance(source_ckpt, str) or not source_ckpt.strip():
            raise GuardrailViolation(
                f"{metrics_path}: thresholds.{slot}.notes.source_checkpoint is required "
                "for frozen thresholds"
            )
        expected_split = slot_spec.get("source_split")
        recorded = notes.get("source_split_path")
        if isinstance(recorded, str) and recorded.strip() and expected_split:
            if normalise_manifest_path(expected_split) not in normalise_manifest_path(recorded):
                raise GuardrailViolation(
                    f"{metrics_path}: thresholds.{slot}.notes.source_split_path="
                    f"{recorded!r} does not contain {expected_split!r}"
                )
        if "unexpected_source_split" in notes:
            raise GuardrailViolation(
                f"{metrics_path}: thresholds.{slot} frozen τ was derived on an "
                f"unexpected split: {notes.get('unexpected_source_split')!r}"
            )
        sha = notes.get("source_checkpoint_sha256")
        if sha is not None and (not isinstance(sha, str) or len(sha.strip()) != 64):
            raise GuardrailViolation(
                f"{metrics_path}: thresholds.{slot}.notes.source_checkpoint_sha256 "
                "must be a 64-hex sha256"
            )

    def _validate_csv_hashes(self, metrics_path: Path, payload: Mapping[str, Any]) -> None:
        """Cross-run digest consistency plus on-disk re-hash of outputs CSVs.

        The reference wrote this guardrail (``result_loader.py:558``) but left
        it disabled (``result_loader.py:189``); here it is active, and it goes
        further: ``provenance.*_outputs_csv`` files sitting next to the
        metrics.json are re-hashed and compared to their declared sha256.
        """
        if not self.enforce_csv_hashes:
            return
        digests: Dict[str, str] = {}
        data_block = payload.get("data")
        if isinstance(data_block, Mapping):
            for split in ("train", "val", "test"):
                entry = data_block.get(split)
                if not isinstance(entry, Mapping):
                    continue
                sha = entry.get("sha256")
                path_value = entry.get("path")
                if isinstance(sha, str) and sha.strip() and isinstance(path_value, str):
                    key = f"data.{split}:{normalise_manifest_path(path_value)}"
                    digests[key] = sha.strip().lower()
        for key, digest in digests.items():
            previous = self._csv_digest_registry.get(key)
            if previous is None:
                self._csv_digest_registry[key] = digest
            elif previous != digest:
                raise GuardrailViolation(
                    f"{metrics_path}: dataset digest mismatch for {key!r}: "
                    f"{digest} != previously seen {previous}"
                )

        provenance = payload.get("provenance")
        if not isinstance(provenance, Mapping):
            return
        for name_key, sha_key in (
            ("test_outputs_csv", "test_outputs_csv_sha256"),
            ("test_zero_shot_outputs_csv", "test_zero_shot_outputs_csv_sha256"),
        ):
            csv_name = provenance.get(name_key)
            declared = provenance.get(sha_key)
            if not isinstance(csv_name, str) or not csv_name.strip():
                continue
            if not isinstance(declared, str) or not declared.strip():
                if self.strict:
                    raise GuardrailViolation(
                        f"{metrics_path}: provenance.{name_key} declared without {sha_key}"
                    )
                continue
            csv_path = Path(csv_name)
            if not csv_path.is_absolute():
                csv_path = metrics_path.parent / csv_path
            if not csv_path.exists():
                if self.strict:
                    raise GuardrailViolation(
                        f"{metrics_path}: declared outputs CSV missing on disk: {csv_path}"
                    )
                continue
            actual = compute_file_sha256(csv_path)
            if actual != declared.strip().lower():
                raise GuardrailViolation(
                    f"{metrics_path}: provenance.{sha_key} mismatch for {csv_path.name}: "
                    f"declared {declared[:12]}…, file hashes to {actual[:12]}…"
                )

    def _validate_confusion(
        self, metrics_path: Path, payload: Mapping[str, Any], block_name: str
    ) -> None:
        block = payload.get(block_name)
        if not isinstance(block, Mapping):
            if block_name == "test_primary" and self.strict:
                raise GuardrailViolation(f"{metrics_path}: missing {block_name}")
            return
        required = ("tp", "fp", "tn", "fn", "n_pos", "n_neg")
        missing = [k for k in required if k not in block]
        if missing:
            if self.strict:
                raise GuardrailViolation(
                    f"{metrics_path}: {block_name} missing {missing}"
                )
            return
        values = {k: _as_int(block.get(k)) for k in required}
        if any(v is None for v in values.values()):
            if self.strict:
                raise GuardrailViolation(
                    f"{metrics_path}: non-integer confusion entries in {block_name}"
                )
            return
        prevalence = _as_float(block.get("prevalence"))
        if prevalence is None:
            if self.strict:
                raise GuardrailViolation(
                    f"{metrics_path}: missing {block_name}.prevalence"
                )
            return
        if not 0.0 <= prevalence <= 1.0:
            raise GuardrailViolation(
                f"{metrics_path}: invalid {block_name}.prevalence={prevalence}"
            )
        confusion_total = values["tp"] + values["fp"] + values["tn"] + values["fn"]
        class_total = values["n_pos"] + values["n_neg"]
        if confusion_total != class_total:
            raise GuardrailViolation(
                f"{metrics_path}: confusion totals disagree with class counts in {block_name}"
            )
        if class_total > 0:
            expected = values["n_pos"] / class_total
            if not math.isclose(prevalence, expected, rel_tol=1e-6, abs_tol=1e-6):
                raise GuardrailViolation(
                    f"{metrics_path}: {block_name}.prevalence={prevalence} "
                    f"!= n_pos/(n_pos+n_neg)={expected:.6f}"
                )

    def _validate_curves(self, metrics_path: Path, payload: Mapping[str, Any]) -> None:
        if not self.required_curve_keys:
            return
        exports = payload.get("curve_exports")
        if not isinstance(exports, Mapping):
            if self.enforce_curve_exports:
                raise GuardrailViolation(f"{metrics_path}: missing curve_exports block")
            return
        for key in self.required_curve_keys:
            entry = exports.get(key)
            if not isinstance(entry, Mapping):
                if self.enforce_curve_exports:
                    raise GuardrailViolation(
                        f"{metrics_path}: missing curve_exports[{key!r}]"
                    )
                continue
            path_value = entry.get("path")
            if not isinstance(path_value, str) or not path_value.strip():
                if self.enforce_curve_exports:
                    raise GuardrailViolation(
                        f"{metrics_path}: curve_exports[{key!r}] missing path"
                    )
                continue
            curve_path = Path(path_value)
            if not curve_path.is_absolute():
                curve_path = metrics_path.parent / curve_path
            if not curve_path.exists():
                if self.enforce_curve_exports:
                    raise GuardrailViolation(
                        f"{metrics_path}: curve file missing {curve_path}"
                    )
                continue
            declared = entry.get("sha256")
            if not (isinstance(declared, str) and declared.strip()):
                # A digest-less entry makes the check vacuous (comparing a
                # file hash to itself): in strict mode demand the declared
                # digest; otherwise skip the pointless hashing.
                if self.enforce_curve_exports:
                    raise GuardrailViolation(
                        f"{metrics_path}: curve_exports[{key!r}] lacks a "
                        f"sha256 to verify against"
                    )
                continue
            digest = compute_file_sha256(curve_path)
            if declared.strip().lower() != digest:
                raise GuardrailViolation(
                    f"{metrics_path}: curve_exports[{key!r}] digest mismatch"
                )

    def _register(self, metrics_path: Path, payload: Mapping[str, Any]) -> None:
        record: Dict[str, Any] = {"metrics_path": str(metrics_path)}
        provenance = payload.get("provenance")
        if isinstance(provenance, Mapping):
            for field in ("model", "subset_percent", "train_seed", "pack_seed", "split"):
                if field in provenance:
                    record[field] = provenance[field]
        record.setdefault("seed", payload.get("seed"))
        for slot in ("primary", "sensitivity"):
            block = (payload.get("thresholds") or {}).get(slot)
            if isinstance(block, Mapping) and "policy" in block:
                record[f"{slot}_threshold_policy"] = block["policy"]
        self.loaded_runs.append(record)

    @staticmethod
    def _metric_block(block: Optional[Mapping[str, Any]]) -> Dict[str, float]:
        if not isinstance(block, Mapping):
            return {}
        out: Dict[str, float] = {}
        for key, value in block.items():
            number = _as_float(value)
            if number is not None:
                out[str(key)] = number
        return out


def build_report_manifest(
    exp_id: str,
    *,
    runs: Sequence[Mapping[str, Any]],
    outputs: Sequence[str | Path] = (),
    extra: Optional[Mapping[str, Any]] = None,
) -> Dict[str, Any]:
    """Reproducibility manifest for a generated report."""
    manifest: Dict[str, Any] = {
        "experiment": exp_id,
        "n_runs": len(runs),
        "runs": [dict(r) for r in runs],
        "outputs": [str(o) for o in outputs],
    }
    if extra:
        manifest.update(dict(extra))
    return manifest
