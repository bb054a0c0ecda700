#!/usr/bin/env python
"""Print the training-seed list of an experiment config (one per line).

Used by the port's run_exp*.sh sweep loops (reference
``scripts/print_config_seeds.py``), through the port's ``configs.layered``.
"""

import argparse

from ssl4polyp_tpu_torch.configs.layered import load_layered_config


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("exp_config")
    args = parser.parse_args()
    cfg = load_layered_config(args.exp_config)
    seeds = (cfg.get("protocol") or {}).get("seeds") or cfg.get("seeds") or []
    for seed in seeds:
        print(int(seed))


if __name__ == "__main__":
    main()
