#!/usr/bin/env bash
# Sweep for exp3 (see config/exp/exp3.yaml), through the PyTorch port.
exec bash "$(dirname "$0")/run_exp_common.sh" exp/exp3 "$@"
