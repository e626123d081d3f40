"""Train HybridLatentViT (a timm ViT trunk over latent tokens).

Port of ``fer_vit_tpu/train/train_hybrid_latent_vit.py``, flag for flag
(reference: train/train_hybrid_latent_vit.py:386-421): model sizes,
freezing flags, adapters, ``--use_layerwise_lr`` (input_proj, adapters and
head x10, pos/CLS x5 without weight decay, reference :63-117). No mixup,
label smoothing or data fraction, as the reference; seq_len and latent_dim
come from the data (reference :211-215).

Freezing is an LR multiplier of 0 in the optimizer's param groups, not a
``requires_grad`` edit. Pretrained ImageNet trunk weights come from a
converted ``.npz`` (``--pretrained_npz``, written by
:mod:`fer_vit_tpu_torch.encoders.convert_timm` or the JAX package's
converter), grafted after init and before ``--resume``.

Usage:
    python -m fer_vit_tpu_torch.train.train_hybrid_latent_vit \\
        --latent_train_dir latents/train --latent_val_dir latents/val \\
        --model_size small --use_pretrained --pretrained_npz vit_small.npz

From Python, ``main(args, device="cpu")`` runs on the CPU; the device
defaults to CUDA and the run raises without it.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device
from fer_vit_tpu_torch.models.hybrid_latent_vit import (
    create_hybrid_latent_vit, graft_pretrained, layerwise_lr_mult,
    trainable_mask)
from fer_vit_tpu_torch.train.cli_common import (add_misc_args, load_stores,
                                                policy_from_args,
                                                run_latent_training)
from fer_vit_tpu_torch.train.harness import TrainConfig
from fer_vit_tpu_torch.utils.experiment_logger import create_experiment_name


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description="Train Hybrid Latent ViT")
    parser.add_argument("--latent_train_dir", required=True)
    parser.add_argument("--latent_val_dir", required=True)
    # model
    parser.add_argument("--model_size", choices=["tiny", "small", "base"],
                        default="small")
    parser.add_argument("--num_classes", type=int, default=7)
    parser.add_argument("--use_pretrained", action="store_true")
    parser.add_argument("--pretrained_npz", default=None,
                        help="converted timm trunk weights (.npz)")
    parser.add_argument("--freeze_transformer", action="store_true")
    parser.add_argument("--freeze_stages", type=int, default=0)
    parser.add_argument("--use_adapter", action="store_true")
    parser.add_argument("--adapter_dim", type=int, default=64)
    # training
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


def freezing(args, model, freeze_stages: Optional[int]):
    """(lr_mult, wd_mask, lr_group_mults) from the freezing and layer-wise
    LR flags; each None when not asked for."""
    lr_mult = wd_mask = None
    if args.use_layerwise_lr:
        lr_mult, wd_mask = layerwise_lr_mult(model, args.freeze_transformer,
                                             freeze_stages)
    elif args.freeze_transformer or freeze_stages:
        frozen = trainable_mask(model, args.freeze_transformer, freeze_stages)
        lr_mult = {k: 1.0 if t else 0.0 for k, t in frozen.items()}
    # the reference's optimizer-group order (train_hybrid_latent_vit.py:65-
    # 117): input_proj x10, transformer x1, [adapters x10], head x10,
    # pos/CLS x5; only the LR log's tags read it
    group_mults = (([10.0, 1.0] + ([10.0] if args.use_adapter else [])
                    + [10.0, 5.0]) if args.use_layerwise_lr else None)
    return lr_mult, wd_mask, group_mults


def pretrained_patch(args, seq_len: int):
    """The ``--use_pretrained --pretrained_npz`` graft as an
    ``init_params_patch``, or None."""
    if not args.use_pretrained:
        return None
    if not args.pretrained_npz:
        print("WARNING: --use_pretrained without --pretrained_npz → "
              "random-initialized trunk (no timm/network here; convert "
              "weights with fer_vit_tpu_torch.encoders.convert_timm)")
        return None
    from fer_vit_tpu_torch.interop.from_jax import load_npz_variables

    pretrained = load_npz_variables(args.pretrained_npz)["params"]
    return lambda model: graft_pretrained(model, pretrained, seq_len)


def main(args, device: DeviceLike = None) -> dict:
    device = resolve_device(device)
    args.seq_len = 0
    args.data_fraction = 1.0
    train_store, val_store = load_stores(args)
    dtype = policy_from_args(args)
    # dropout draws from torch's default generator (the reference seeds it)
    torch.manual_seed(args.seed)
    freeze_stages = args.freeze_stages if args.freeze_stages > 0 else None

    model = create_hybrid_latent_vit(
        latent_dim=train_store.latent_dim,
        seq_len=train_store.seq_len,
        model_size=args.model_size,
        num_classes=args.num_classes,
        use_adapter=args.use_adapter,
        adapter_dim=args.adapter_dim,
        dtype=dtype,
        generator=torch.Generator().manual_seed(args.seed),
    )

    cfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        weight_decay=args.weight_decay, scheduler=args.scheduler,
        label_smoothing=0.0, mixup=0.0,
        use_class_weights=args.use_class_weights,
        num_classes=args.num_classes, seed=args.seed,
    )
    lr_mult, wd_mask, group_mults = freezing(args, model, freeze_stages)

    model_config = {
        "latent_dim": train_store.latent_dim, "seq_len": train_store.seq_len,
        "model_size": args.model_size, "use_pretrained": args.use_pretrained,
        "freeze_transformer": args.freeze_transformer,
        "freeze_stages": freeze_stages,
        "use_adapter": args.use_adapter,
        "adapter_dim": args.adapter_dim if args.use_adapter else None,
    }
    training_config = {
        "epochs": args.epochs, "batch_size": args.batch_size, "lr": args.lr,
        "weight_decay": args.weight_decay, "scheduler": args.scheduler,
        "use_class_weights": args.use_class_weights,
        "use_layerwise_lr": args.use_layerwise_lr, "seed": args.seed,
    }
    config = {"model": model_config, "training": training_config,
              "data": {"train_dir": args.latent_train_dir,
                       "val_dir": args.latent_val_dir}}
    experiment_name = (
        f"hybrid_vit_{create_experiment_name(model_config, training_config)}"
    )
    return run_latent_training(
        args, model, cfg, experiment_name, config, train_store, val_store,
        lr_mult=lr_mult,
        init_params_patch=pretrained_patch(args, train_store.seq_len),
        wd_mask=wd_mask, lr_group_mults=group_mults, device=device)


if __name__ == "__main__":
    main(build_parser().parse_args())
