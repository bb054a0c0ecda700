#!/usr/bin/env bash
# Sweep for exp5b (see config/exp/exp5b.yaml), through the PyTorch port.
exec bash "$(dirname "$0")/run_exp_common.sh" exp/exp5b "$@"
