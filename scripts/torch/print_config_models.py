#!/usr/bin/env python
"""Print the model keys of an experiment config (one per line), through the
port's ``configs.layered``."""

import argparse

from ssl4polyp_tpu_torch.configs.layered import load_layered_config, resolve_model_entries


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("exp_config")
    args = parser.parse_args()
    cfg = load_layered_config(args.exp_config)
    for entry in resolve_model_entries(cfg.get("models", [])):
        key = entry.get("key")
        if key:
            print(key)


if __name__ == "__main__":
    main()
