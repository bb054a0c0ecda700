#!/usr/bin/env bash
# Sweep for exp5a (see config/exp/exp5a.yaml), through the PyTorch port.
exec bash "$(dirname "$0")/run_exp_common.sh" exp/exp5a "$@"
