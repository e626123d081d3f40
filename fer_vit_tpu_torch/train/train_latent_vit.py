"""Train LatentViT on precomputed pSp w+ latents.

Port of ``fer_vit_tpu/train/train_latent_vit.py``, flag for flag (reference:
train/train_latent_vit.py:387-426), with the same config dicts, experiment
name and experiment dir. The latent set lives on the device; compute is
bf16 on CUDA unless ``--no_bf16``, with f32 parameters.

Usage:
    python -m fer_vit_tpu_torch.train.train_latent_vit \
        --latent_train_dir latents/train --latent_val_dir latents/val

From Python, ``main(args, device="cpu")`` runs on the CPU; the device
defaults to CUDA and the run raises without it.
"""

from __future__ import annotations

import argparse

import torch

from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device
from fer_vit_tpu_torch.data.latent_store import train_val_arrays
from fer_vit_tpu_torch.models import LatentViT
from fer_vit_tpu_torch.train.cli_common import (augment_from_args,
                                                policy_from_args,
                                                run_latent_training)
from fer_vit_tpu_torch.train.harness import TrainConfig
from fer_vit_tpu_torch.utils.experiment_logger import create_experiment_name


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train LatentViT with data fraction option"
    )
    # data
    parser.add_argument("--latent_train_dir", required=True)
    parser.add_argument("--latent_val_dir", required=True)
    parser.add_argument("--data_fraction", type=float, default=1.0)
    parser.add_argument("--use_augmentation", action="store_true")
    parser.add_argument("--latent_noise", type=float, default=0.1)
    parser.add_argument("--latent_mask", type=float, default=0.1)
    # training
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=1e-2)
    parser.add_argument("--scheduler", choices=["none", "cosine", "plateau"],
                        default="plateau")
    parser.add_argument("--use_class_weights", action="store_true")
    parser.add_argument("--label_smoothing", type=float, default=0.1)
    parser.add_argument("--mixup", type=float, default=1.0)
    # model
    parser.add_argument("--latent_dim", type=int, default=512)
    parser.add_argument("--seq_len", type=int, default=0)
    parser.add_argument("--embed_dim", type=int, default=512)
    parser.add_argument("--depth", type=int, default=6)
    parser.add_argument("--heads", type=int, default=8)
    parser.add_argument("--mlp_dim", type=int, default=2048)
    parser.add_argument("--num_classes", type=int, default=7)
    parser.add_argument("--dropout", type=float, default=0.1)
    # misc
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--experiments_dir", default="experiments")
    parser.add_argument("--no_bf16", action="store_true",
                        help="force f32 compute even on CUDA")
    parser.add_argument("--resume", default=None,
                        help="checkpoint path to resume training from")
    parser.add_argument("--debug_nans", action="store_true",
                        help="enable autograd anomaly detection (errors at "
                             "the first backward op giving a NaN)")
    return parser


def validate_args(args) -> None:
    if args.data_fraction <= 0.0 or args.data_fraction > 1.0:
        raise ValueError(
            f"data_fraction must be in (0.0, 1.0], got {args.data_fraction}"
        )


def main(args, device: DeviceLike = None) -> dict:
    device = resolve_device(device)
    dtype = policy_from_args(args)
    # dropout draws from torch's default generator (the reference seeds it)
    torch.manual_seed(args.seed)
    train_store, val_store = train_val_arrays(
        args.latent_train_dir, args.latent_val_dir, args.data_fraction, args.seed
    )
    print(f"Train samples: {len(train_store)}  Val samples: {len(val_store)}")

    # seq_len auto-inference from the data (reference: :221-229).
    if args.seq_len <= 0:
        args.seq_len = train_store.seq_len
        print(f"Inferred seq_len from latents: {args.seq_len}")

    model = LatentViT(
        latent_dim=args.latent_dim,
        seq_len=args.seq_len,
        embed_dim=args.embed_dim,
        depth=args.depth,
        heads=args.heads,
        mlp_dim=args.mlp_dim,
        num_classes=args.num_classes,
        dropout=args.dropout,
        dtype=dtype,
        generator=torch.Generator().manual_seed(args.seed),
    )

    cfg = TrainConfig(
        epochs=args.epochs,
        batch_size=args.batch_size,
        lr=args.lr,
        weight_decay=args.weight_decay,
        scheduler=args.scheduler,
        label_smoothing=args.label_smoothing,
        mixup=args.mixup,
        use_class_weights=args.use_class_weights,
        num_classes=args.num_classes,
        seed=args.seed,
        augment=augment_from_args(args),
        clean_metrics_forward=True,  # reference :138-141 runs it always
    )
    model_config = {
        "latent_dim": args.latent_dim, "seq_len": args.seq_len,
        "embed_dim": args.embed_dim, "depth": args.depth, "heads": args.heads,
        "mlp_dim": args.mlp_dim, "num_classes": args.num_classes,
        "dropout": args.dropout,
    }
    training_config = {
        "epochs": args.epochs, "batch_size": args.batch_size, "lr": args.lr,
        "weight_decay": args.weight_decay,
        "use_class_weights": args.use_class_weights,
        "scheduler": args.scheduler, "seed": args.seed,
        "data_fraction": args.data_fraction, "mixup": args.mixup,
    }
    config = {
        "model": model_config,
        "training": training_config,
        "data": {
            "train_dir": args.latent_train_dir,
            "val_dir": args.latent_val_dir,
            "train_samples_total": train_store.total_samples,
            "train_samples_used": len(train_store),
            "val_samples": len(val_store),
        },
    }

    base_name = create_experiment_name(model_config, training_config,
                                       is_latent=True)
    experiment_name = f"{base_name}_frac{int(args.data_fraction * 100)}"
    return run_latent_training(args, model, cfg, experiment_name, config,
                               train_store, val_store, device=device)


if __name__ == "__main__":
    parsed = build_parser().parse_args()
    validate_args(parsed)
    main(parsed)
