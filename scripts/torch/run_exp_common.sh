#!/usr/bin/env bash
# Shared sweep loop: for each model x seed of an experiment config, run
# training then stage reporting inputs.  Mirrors the reference run_exp*.sh
# structure (seeds/models read from the config itself).  The PyTorch port's
# copy of scripts/run_exp_common.sh: every step runs ssl4polyp_tpu_torch.
# Run from the repository root with the package importable, e.g.
#   PYTHONPATH=. bash scripts/torch/run_exp1.sh --device cuda
set -euo pipefail

EXP_CONFIG="$1"; shift
OUTPUT_DIR="${OUTPUT_DIR:-checkpoints/classification}"
RESULTS_DIR="${RESULTS_DIR:-results}"
EXTRA_ARGS=("$@")

SEEDS=$(python scripts/torch/print_config_seeds.py "$EXP_CONFIG")
MODELS=$(python scripts/torch/print_config_models.py "$EXP_CONFIG")

for MODEL in $MODELS; do
  for SEED in $SEEDS; do
    echo "=== $EXP_CONFIG model=$MODEL seed=$SEED ==="
    python -m ssl4polyp_tpu_torch.training.classification \
      --exp-config "$EXP_CONFIG" \
      --model-key "$MODEL" \
      --seed "$SEED" \
      --output-dir "$OUTPUT_DIR" \
      "${EXTRA_ARGS[@]}"
  done
done

python -m ssl4polyp_tpu_torch.utils.reporting_inputs \
  --exp-config "$EXP_CONFIG" \
  --runs-root "$OUTPUT_DIR" \
  --results-root "$RESULTS_DIR"
