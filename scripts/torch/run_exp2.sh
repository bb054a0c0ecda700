#!/usr/bin/env bash
# Sweep for exp2 (see config/exp/exp2.yaml), through the PyTorch port.
exec bash "$(dirname "$0")/run_exp_common.sh" exp/exp2 "$@"
