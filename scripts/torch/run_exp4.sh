#!/usr/bin/env bash
# Exp4 sweeps subset percents x models x seeds, through the PyTorch port.
set -euo pipefail
EXP_CONFIG=exp/exp4
OUTPUT_DIR="${OUTPUT_DIR:-checkpoints/classification}"
RESULTS_DIR="${RESULTS_DIR:-results}"

SEEDS=$(python scripts/torch/print_config_seeds.py "$EXP_CONFIG")
MODELS=$(python scripts/torch/print_config_models.py "$EXP_CONFIG")

for PERCENT in 5 10 25 50 100; do
  for MODEL in $MODELS; do
    for SEED in $SEEDS; do
      echo "=== exp4 p=$PERCENT model=$MODEL seed=$SEED ==="
      python -m ssl4polyp_tpu_torch.training.classification \
        --exp-config "$EXP_CONFIG" \
        --model-key "$MODEL" \
        --seed "$SEED" \
        --override "dataset.percent=$PERCENT" \
        --output-dir "$OUTPUT_DIR" "$@"
    done
  done
done

python -m ssl4polyp_tpu_torch.utils.reporting_inputs \
  --exp-config "$EXP_CONFIG" \
  --runs-root "$OUTPUT_DIR" \
  --results-root "$RESULTS_DIR"
