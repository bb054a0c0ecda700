#!/usr/bin/env bash
# Tiny end-to-end smoke (config/exp/exp1_smoke.yaml), through the PyTorch port.
set -euo pipefail
python -m ssl4polyp_tpu_torch.training.classification \
  --exp-config exp/exp1_smoke \
  --model-key sup_imnet \
  --seed 13 \
  --output-dir "${OUTPUT_DIR:-checkpoints/classification_smoke}" "$@"
