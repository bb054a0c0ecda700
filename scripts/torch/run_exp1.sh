#!/usr/bin/env bash
# Sweep for exp1 (see config/exp/exp1.yaml), through the PyTorch port.
exec bash "$(dirname "$0")/run_exp_common.sh" exp/exp1 "$@"
