#!/usr/bin/env bash
# Run the full experiment battery sequentially, through the PyTorch port.
set -euo pipefail
for EXP in 1 2 3 4 5a 5b; do
  bash "$(dirname "$0")/run_exp$EXP.sh" "$@"
done
bash "$(dirname "$0")/run_exp5c.sh" "$@"
