#!/usr/bin/env bash
# Regenerate every data-pack family the reference ships as assets
# (reference data_packs/{sun_full,sun_morphology,sun_subsets,
# sun_test_perturbations,polypgen_clean_test,polypgen_clean_test_extended,
# polypgen_fewshot}) from dataset roots, through the PyTorch port's polypdb
# CLI (the same packs, byte for byte, as scripts/build_data_packs.sh).
#
# Usage:
#   SUN_ROOT=/data/sun POLYPGEN_ROOT=/data/polypgen scripts/torch/build_data_packs.sh [out_dir]
#   scripts/torch/build_data_packs.sh --synthetic [out_dir]   # smoke-test roots
#
# The output directory defaults to ./data_packs (the loader's
# SSL4POLYP_TPU_DATA_PACKS_ROOT / data_packs_root()).
set -euo pipefail

SYNTHETIC=0
if [[ "${1:-}" == "--synthetic" ]]; then
  SYNTHETIC=1
  shift
fi
OUT="${1:-data_packs}"
mkdir -p "$OUT"

if [[ "$SYNTHETIC" == 1 ]]; then
  SUN_ROOT="$OUT/_synthetic_roots/sun"
  POLYPGEN_ROOT="$OUT/_synthetic_roots/polypgen"
  python -m ssl4polyp_tpu_torch.polypdb.cli synth-root --layout sun --out "$SUN_ROOT" --scale 1.5
  python -m ssl4polyp_tpu_torch.polypdb.cli synth-root --layout polypgen --out "$POLYPGEN_ROOT" --scale 2.0
  SUN_ARGS=(--frames-per-case 8 --cases-per-split 8 3 3)
  FEWSHOT_BUDGETS=(20 40)
else
  : "${SUN_ROOT:?set SUN_ROOT to the SUN dataset root (case dirs with images/)}"
  : "${POLYPGEN_ROOT:?set POLYPGEN_ROOT to the PolypGen dataset root}"
  SUN_ARGS=(--frames-per-case 33 --cases-per-split 70 15 15)
  FEWSHOT_BUDGETS=(50 100 200 500)
fi

echo "== sun_full =="
python -m ssl4polyp_tpu_torch.polypdb.cli sun build \
  --root "$SUN_ROOT" --out "$OUT/sun_full" --seed 47 "${SUN_ARGS[@]}"

echo "== sun_morphology =="
python -m ssl4polyp_tpu_torch.polypdb.cli sun morph \
  --root "$SUN_ROOT" --out "$OUT/sun_morphology" --seed 47 "${SUN_ARGS[@]}"

echo "== sun_subsets =="
python -m ssl4polyp_tpu_torch.polypdb.cli sun subsets-canonical \
  --pack "$OUT/sun_full" --percents 5 10 25 50 100 --seed 13 \
  --out "$OUT/sun_subsets"

echo "== sun_test_perturbations =="
python -m ssl4polyp_tpu_torch.polypdb.cli sun perturbations \
  --pack "$OUT/sun_full" --out "$OUT/sun_test_perturbations" --master-seed 47

echo "== polypgen_clean_test =="
python -m ssl4polyp_tpu_torch.polypdb.cli polypgen build \
  --root "$POLYPGEN_ROOT" --out "$OUT/polypgen_clean_test" --track clean

echo "== polypgen_clean_test_extended =="
python -m ssl4polyp_tpu_torch.polypdb.cli polypgen build \
  --root "$POLYPGEN_ROOT" --out "$OUT/polypgen_clean_test_extended" \
  --track clean --include-negative-sequences

echo "== polypgen_fewshot =="
python -m ssl4polyp_tpu_torch.polypdb.cli polypgen fewshot \
  --parent-pack "$OUT/polypgen_clean_test_extended" \
  --out "$OUT/polypgen_fewshot" --budgets "${FEWSHOT_BUDGETS[@]}" --seed 13

echo "all packs written under $OUT"
