"""Train ExpressionAwareViT (a fixed SVM-direction decomposer, then the
hybrid ViT).

Port of ``fer_vit_tpu/train/train_expression_aware_vit.py``, flag for flag
(reference: train/train_expression_aware_vit.py:304-330): decomposition
modes, the hybrid ViT's options, layer-wise LR. The directions are a
non-persistent buffer, so the trained parameters are exactly the ViT's.

Usage:
    python -m fer_vit_tpu_torch.train.train_expression_aware_vit \\
        --latent_train_dir latents/train --latent_val_dir latents/val \\
        --directions_path directions.npz --output_mode concat

From Python, ``main(args, device="cpu")`` runs on the CPU; the device
defaults to CUDA and the run raises without it.
"""

from __future__ import annotations

import argparse

import torch

from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device
from fer_vit_tpu_torch.models import ExpressionAwareViT
from fer_vit_tpu_torch.train.cli_common import (add_misc_args, load_stores,
                                                policy_from_args,
                                                run_latent_training)
from fer_vit_tpu_torch.train.harness import TrainConfig
from fer_vit_tpu_torch.train.train_hybrid_latent_vit import (freezing,
                                                             pretrained_patch)
from fer_vit_tpu_torch.utils.experiment_logger import create_experiment_name


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train Expression-Aware ViT")
    parser.add_argument("--latent_train_dir", required=True)
    parser.add_argument("--latent_val_dir", required=True)
    parser.add_argument("--directions_path", required=True)
    parser.add_argument("--output_mode",
                        choices=["expr_only", "id_only", "enhanced", "concat"],
                        default="expr_only")
    parser.add_argument("--decompose_mode",
                        choices=["all_classes", "max_class"],
                        default="all_classes")
    parser.add_argument("--enhance_alpha", type=float, default=2.0)
    parser.add_argument("--model_size", choices=["tiny", "small", "base"],
                        default="small")
    parser.add_argument("--num_classes", type=int, default=7)
    parser.add_argument("--use_pretrained", action="store_true")
    parser.add_argument("--pretrained_npz", default=None)
    parser.add_argument("--freeze_transformer", action="store_true")
    parser.add_argument("--freeze_stages", type=int, default=0)
    parser.add_argument("--use_adapter", action="store_true")
    parser.add_argument("--adapter_dim", type=int, default=64)
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=0.01)
    parser.add_argument("--scheduler", choices=["none", "cosine", "plateau"],
                        default="plateau")
    parser.add_argument("--use_class_weights", action="store_true")
    parser.add_argument("--use_layerwise_lr", action="store_true")
    add_misc_args(parser)
    return parser


def main(args, device: DeviceLike = None) -> dict:
    device = resolve_device(device)
    args.seq_len = 0
    args.data_fraction = 1.0
    train_store, val_store = load_stores(args)
    dtype = policy_from_args(args)
    # dropout draws from torch's default generator (the reference seeds it)
    torch.manual_seed(args.seed)
    freeze_stages = args.freeze_stages if args.freeze_stages > 0 else None

    model = ExpressionAwareViT.from_config(
        args.directions_path,
        model_size=args.model_size,
        num_classes=args.num_classes,
        use_adapter=args.use_adapter,
        adapter_dim=args.adapter_dim,
        output_mode=args.output_mode,
        enhance_alpha=args.enhance_alpha,
        decompose_mode=args.decompose_mode,
        dtype=dtype,
        generator=torch.Generator().manual_seed(args.seed),
    )
    print(f"[ExpressionAwareViT] decompose={args.decompose_mode} "
          f"output={args.output_mode} seq_len={model.seq_len}")

    cfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        weight_decay=args.weight_decay, scheduler=args.scheduler,
        label_smoothing=0.0, mixup=0.0,
        use_class_weights=args.use_class_weights,
        num_classes=args.num_classes, seed=args.seed,
    )
    lr_mult, wd_mask, group_mults = freezing(args, model, freeze_stages)

    model_cfg = {
        "model_size": args.model_size, "output_mode": args.output_mode,
        "decompose_mode": args.decompose_mode,
        "enhance_alpha": args.enhance_alpha,
        "use_pretrained": args.use_pretrained,
        "freeze_transformer": args.freeze_transformer,
        "freeze_stages": freeze_stages, "use_adapter": args.use_adapter,
        "directions_path": args.directions_path,
    }
    training_cfg = {
        "epochs": args.epochs, "batch_size": args.batch_size, "lr": args.lr,
        "weight_decay": args.weight_decay, "scheduler": args.scheduler,
        "use_class_weights": args.use_class_weights,
        "use_layerwise_lr": args.use_layerwise_lr, "seed": args.seed,
    }
    config = {"model": model_cfg, "training": training_cfg,
              "data": {"train_dir": args.latent_train_dir,
                       "val_dir": args.latent_val_dir}}
    exp_name = ("expr_aware_vit_"
                f"{create_experiment_name(model_cfg, training_cfg)}")
    # the pretrained graft's positions go to the ViT's seq_len, which is
    # twice the data's in concat mode
    return run_latent_training(
        args, model, cfg, exp_name, config, train_store, val_store,
        lr_mult=lr_mult,
        init_params_patch=pretrained_patch(args, model.seq_len),
        wd_mask=wd_mask, lr_group_mults=group_mults, device=device)


if __name__ == "__main__":
    main(build_parser().parse_args())
