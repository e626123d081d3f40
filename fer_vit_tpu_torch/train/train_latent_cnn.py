"""Train the latent CNN baselines on pSp w+ latents.

Port of ``fer_vit_tpu/train/train_latent_cnn.py``, flag for flag
(reference: train/train_latent_cnn.py:380-407): ``--model_type
light|standard|deep|2d``, ``--dropout`` (0.3), mixup fixed at alpha 1.0
(reference :115-120), experiment name
``latent_cnn_{type}_ep{E}_bs{B}_lr{LR}[_frac{F}]`` (reference :290-294).
The BatchNorms take each batch's row mask in training (the harness passes
it), so the padded last batch's pad rows stay out of their statistics.

Usage:
    python -m fer_vit_tpu_torch.train.train_latent_cnn \\
        --latent_train_dir latents/train --latent_val_dir latents/val \\
        --model_type standard

From Python, ``main(args, device="cpu")`` runs on the CPU; the device
defaults to CUDA and the run raises without it.
"""

from __future__ import annotations

import argparse

import torch

from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device
from fer_vit_tpu_torch.models import create_latent_cnn
from fer_vit_tpu_torch.train.cli_common import (add_data_args, add_misc_args,
                                                add_training_args,
                                                load_stores,
                                                policy_from_args,
                                                run_latent_training)
from fer_vit_tpu_torch.train.harness import TrainConfig


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train Latent CNN baselines")
    add_data_args(parser, augmentation=False)
    add_training_args(parser, mixup=False)
    parser.add_argument("--model_type",
                        choices=["light", "standard", "deep", "2d"],
                        default="standard")
    parser.add_argument("--latent_dim", type=int, default=512)
    parser.add_argument("--seq_len", type=int, default=0)
    parser.add_argument("--num_classes", type=int, default=7)
    parser.add_argument("--dropout", type=float, default=0.3)
    add_misc_args(parser)
    return parser


def main(args, device: DeviceLike = None) -> dict:
    device = resolve_device(device)
    train_store, val_store = load_stores(args)
    dtype = policy_from_args(args)
    # dropout draws from torch's default generator (the reference seeds it)
    torch.manual_seed(args.seed)

    model = create_latent_cnn(
        args.model_type,
        latent_dim=args.latent_dim,
        seq_len=args.seq_len,
        num_classes=args.num_classes,
        dropout=args.dropout,
        dtype=dtype,
        generator=torch.Generator().manual_seed(args.seed),
    )

    cfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        weight_decay=args.weight_decay, scheduler=args.scheduler,
        label_smoothing=args.label_smoothing,
        mixup=1.0,  # hardcoded in the reference (train_latent_cnn.py:115-120)
        use_class_weights=args.use_class_weights,
        num_classes=args.num_classes, seed=args.seed,
        clean_metrics_forward=True,  # reference train_latent_cnn.py:134
    )

    config = {
        "model": {
            "model_type": args.model_type, "latent_dim": args.latent_dim,
            "seq_len": args.seq_len, "num_classes": args.num_classes,
            "dropout": args.dropout,
        },
        "training": {
            "epochs": args.epochs, "batch_size": args.batch_size,
            "lr": args.lr, "weight_decay": args.weight_decay,
            "use_class_weights": args.use_class_weights,
            "scheduler": args.scheduler, "seed": args.seed,
            "data_fraction": args.data_fraction,
        },
        "data": {
            "train_dir": args.latent_train_dir,
            "val_dir": args.latent_val_dir,
            "train_samples_total": train_store.total_samples,
            "train_samples_used": len(train_store),
            "val_samples": len(val_store),
        },
    }

    base = (f"latent_cnn_{args.model_type}_ep{args.epochs}"
            f"_bs{args.batch_size}_lr{args.lr}")
    experiment_name = (
        f"{base}_frac{int(args.data_fraction * 100)}"
        if args.data_fraction < 1.0 else base
    )

    return run_latent_training(args, model, cfg, experiment_name, config,
                               train_store, val_store, device=device)


if __name__ == "__main__":
    main(build_parser().parse_args())
