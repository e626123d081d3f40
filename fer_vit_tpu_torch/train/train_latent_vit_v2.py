"""Train LatentViTv2 (the LWN/SPE/LEAM ablations) on pSp w+ latents.

Port of ``fer_vit_tpu/train/train_latent_vit_v2.py``, flag for flag
(reference: train/train_latent_vit_v2.py:404-446): LatentViT's flags plus
gradient clipping (default 1.0), the four ablation flags and an
``--experiment_name`` override; the same config dicts, experiment name and
experiment dir.

Usage:
    python -m fer_vit_tpu_torch.train.train_latent_vit_v2 \\
        --latent_train_dir latents/train --latent_val_dir latents/val \\
        --use_spe --use_lwn --use_lwn_residual --use_leam

From Python, ``main(args, device="cpu")`` runs on the CPU; the device
defaults to CUDA and the run raises without it.
"""

from __future__ import annotations

import argparse

import torch

from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device
from fer_vit_tpu_torch.models import LatentViTv2
from fer_vit_tpu_torch.train.cli_common import (add_data_args, add_misc_args,
                                                add_training_args,
                                                augment_from_args,
                                                load_stores,
                                                policy_from_args,
                                                run_latent_training)
from fer_vit_tpu_torch.train.harness import TrainConfig
from fer_vit_tpu_torch.utils.experiment_logger import create_experiment_name


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train LatentViT v2")
    add_data_args(parser)
    add_training_args(parser)
    # model
    parser.add_argument("--latent_dim", type=int, default=512)
    parser.add_argument("--seq_len", type=int, default=0)
    parser.add_argument("--embed_dim", type=int, default=512)
    parser.add_argument("--depth", type=int, default=6)
    parser.add_argument("--heads", type=int, default=8)
    parser.add_argument("--mlp_dim", type=int, default=2048)
    parser.add_argument("--num_classes", type=int, default=7)
    parser.add_argument("--dropout", type=float, default=0.1)
    # ablation flags
    parser.add_argument("--use_lwn", action="store_true")
    parser.add_argument("--use_lwn_residual", action="store_true")
    parser.add_argument("--use_spe", action="store_true")
    parser.add_argument("--use_leam", action="store_true")
    # misc
    add_misc_args(parser)
    parser.add_argument("--grad_clip", type=float, default=1.0)
    parser.add_argument("--experiment_name", type=str, default="")
    return parser


def main(args, device: DeviceLike = None) -> dict:
    device = resolve_device(device)
    train_store, val_store = load_stores(args)
    dtype = policy_from_args(args)
    # dropout draws from torch's default generator (the reference seeds it)
    torch.manual_seed(args.seed)

    model = LatentViTv2(
        latent_dim=args.latent_dim,
        seq_len=args.seq_len,
        embed_dim=args.embed_dim,
        depth=args.depth,
        heads=args.heads,
        mlp_dim=args.mlp_dim,
        num_classes=args.num_classes,
        dropout=args.dropout,
        use_lwn=args.use_lwn,
        use_lwn_residual=args.use_lwn_residual,
        use_spe=args.use_spe,
        use_leam=args.use_leam,
        dtype=dtype,
        generator=torch.Generator().manual_seed(args.seed),
    )

    cfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        weight_decay=args.weight_decay, scheduler=args.scheduler,
        label_smoothing=args.label_smoothing, mixup=args.mixup,
        grad_clip=args.grad_clip, use_class_weights=args.use_class_weights,
        num_classes=args.num_classes, seed=args.seed,
        augment=augment_from_args(args),
        clean_metrics_forward=True,  # reference template: unconditional
    )

    model_config = {
        "latent_dim": args.latent_dim, "seq_len": args.seq_len,
        "embed_dim": args.embed_dim, "depth": args.depth, "heads": args.heads,
        "mlp_dim": args.mlp_dim, "num_classes": args.num_classes,
        "dropout": args.dropout, **model.get_config(),
    }
    training_config = {
        "epochs": args.epochs, "batch_size": args.batch_size, "lr": args.lr,
        "weight_decay": args.weight_decay,
        "use_class_weights": args.use_class_weights,
        "scheduler": args.scheduler, "seed": args.seed,
        "data_fraction": args.data_fraction, "mixup": args.mixup,
        "grad_clip": args.grad_clip,
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

    if args.experiment_name:
        experiment_name = args.experiment_name
    else:
        base = create_experiment_name(model_config, training_config,
                                      is_latent=True)
        experiment_name = f"{base}_frac{int(args.data_fraction * 100)}"

    return run_latent_training(args, model, cfg, experiment_name, config,
                               train_store, val_store, device=device)


if __name__ == "__main__":
    main(build_parser().parse_args())
