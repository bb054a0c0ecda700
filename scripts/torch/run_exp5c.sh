#!/usr/bin/env bash
# Exp5c iterates the few-shot budget configs (s50..s500), through the PyTorch port.
set -euo pipefail
for BUDGET in s50 s100 s200 s500; do
  bash "$(dirname "$0")/run_exp_common.sh" "exp/exp5c/budgets/$BUDGET" "$@"
done
