"""Paper-settings Hyperkvasir pretraining wrapper.

Reference: ``models/mae/run_hyperkvasir_pretraining.py`` — fixes the study's
MAE recipe (ViT-B/16, 400 epochs, batch 64, blr 1e-3, mask 0.75, warmup 40,
``--no_train_dir``) and auto-resumes from the newest checkpoint.  Here it is
a thin settings constructor over :mod:`.pretrain` (no subprocess hop).

The port's copy of ``ssl4polyp_tpu/training/hyperkvasir.py``; ``--device``
(default ``cuda``) is its one added flag.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

from ..parallel.multihost import initialize_multihost
from .pretrain import PretrainSettings, run_pretraining

__all__ = ["hyperkvasir_settings", "main"]


def hyperkvasir_settings(
    data_root: str,
    output_dir: str = "checkpoints/pretrained/vit_b/hyperkvasir",
    **overrides: Any,
) -> PretrainSettings:
    defaults: Dict[str, Any] = dict(
        data_root=data_root,
        output_dir=output_dir,
        model="mae_vit_base_patch16",
        epochs=400,
        warmup_epochs=40,
        batch_size=64,
        blr=1e-3,
        mask_ratio=0.75,
        weight_decay=0.05,
        no_train_dir=True,
        save_freq_epochs=20,
        keep_last=2,
        keep_every_n_epochs=100,
        resume="auto",
    )
    defaults.update(overrides)
    return PretrainSettings(**defaults)


def main(argv: Optional[list] = None) -> None:
    import argparse

    parser = argparse.ArgumentParser(description="Hyperkvasir MAE pretraining (paper settings)")
    parser.add_argument("--data-root", required=True)
    parser.add_argument("--output-dir", default="checkpoints/pretrained/vit_b/hyperkvasir")
    parser.add_argument("--epochs", type=int, default=400)
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--accum-iter", type=int, default=1)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    initialize_multihost(backend="gloo" if args.device == "cpu" else None)
    settings = hyperkvasir_settings(
        args.data_root,
        output_dir=args.output_dir,
        epochs=args.epochs,
        batch_size=args.batch_size,
        accum_iter=args.accum_iter,
        device=args.device,
    )
    run_pretraining(settings)


if __name__ == "__main__":
    main()
