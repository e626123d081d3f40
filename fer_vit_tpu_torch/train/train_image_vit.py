"""Train ImageViT on face images (FER2013-style class dirs).

Port of ``fer_vit_tpu/train/train_image_vit.py``, flag for flag (reference:
train/train_image_vit.py:461-499): model sizes tiny/small/base/custom,
adamw|sgd, none/cosine/plateau/warmup_cosine schedules (cosine floor
lr * 0.01), ``--use_pretrained`` (the timm vit_small architecture, with
ImageNet weights from a converted ``.npz`` via ``--pretrained_npz``), and
the same config dicts, experiment name and experiment dir.

The images decode once into a uint8 array that stays on the device; each
batch is flipped, warped, colour-jittered and normalised there
(``--use_augmentation``) or only normalised. Compute is bf16 on CUDA unless
``--no_bf16``, with f32 parameters. As in the JAX trainer, the
tiny/small/base presets build their model without ``--dropout`` (dropout
0.1); ``--model_size custom`` takes every model flag.

With no dropout, every attention of the 197-token ViT (224 px, patch 16)
runs through the fused attention kernel in the forward of each training
step and each eval batch; its backward recomputes through the plain
version.

Usage:
    python -m fer_vit_tpu_torch.train.train_image_vit \\
        --train_dir faces/train --val_dir faces/val --use_augmentation

From Python, ``main(args, device="cpu")`` runs on the CPU; the device
defaults to CUDA and the run raises without it.
"""

from __future__ import annotations

import argparse
from functools import partial

import torch

from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device
from fer_vit_tpu_torch.data.image_pipeline import (ImageAugmentConfig,
                                                   ImageStore, image_augment,
                                                   normalize_images)
from fer_vit_tpu_torch.models import (ImageViT, create_vit_base,
                                      create_vit_small, create_vit_tiny)
from fer_vit_tpu_torch.models.timm_vit import create_timm_vit
from fer_vit_tpu_torch.train.cli_common import load_resume, policy_from_args
from fer_vit_tpu_torch.train.harness import Harness, TrainConfig
from fer_vit_tpu_torch.train.loop import fit
from fer_vit_tpu_torch.utils.experiment_logger import (ExperimentLogger,
                                                       create_experiment_name)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Train Vision Transformer on image data"
    )
    # data
    parser.add_argument("--train_dir", required=True)
    parser.add_argument("--val_dir", required=True)
    parser.add_argument("--img_size", type=int, default=224)
    parser.add_argument("--use_augmentation", action="store_true")
    # model
    parser.add_argument("--model_size",
                        choices=["tiny", "small", "base", "custom"],
                        default="small")
    parser.add_argument("--patch_size", type=int, default=16)
    parser.add_argument("--embed_dim", type=int, default=384)
    parser.add_argument("--depth", type=int, default=12)
    parser.add_argument("--heads", type=int, default=6)
    parser.add_argument("--mlp_dim", type=int, default=1536)
    parser.add_argument("--num_classes", type=int, default=7)
    parser.add_argument("--dropout", type=float, default=0.1)
    parser.add_argument("--use_pretrained", action="store_true")
    parser.add_argument("--pretrained_npz", default=None,
                        help="converted timm weights (.npz) for --use_pretrained")
    # training
    parser.add_argument("--epochs", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--weight_decay", type=float, default=0.05)
    parser.add_argument("--optimizer", choices=["adamw", "sgd"],
                        default="adamw")
    parser.add_argument("--scheduler",
                        choices=["none", "cosine", "plateau", "warmup_cosine"],
                        default="warmup_cosine")
    parser.add_argument("--grad_clip", type=float, default=None)
    parser.add_argument("--label_smoothing", type=float, default=0.1)
    # misc
    parser.add_argument("--use_class_weights", action="store_true")
    parser.add_argument("--num_workers", type=int, default=4)  # accepted; N/A
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--data_fraction", type=float, default=1.0)
    parser.add_argument("--experiments_dir", default="experiments")
    parser.add_argument("--no_bf16", action="store_true",
                        help="force f32 compute even on CUDA")
    parser.add_argument("--resume", default=None,
                        help="checkpoint path (last_model.pt) to resume from "
                             "— full state: params, optimizer, epoch, LR "
                             "scheduler")
    parser.add_argument("--debug_nans", action="store_true",
                        help="enable autograd anomaly detection (errors at "
                             "the first backward op giving a NaN)")
    return parser


def build_model(args, dtype=None, generator=None):
    """(model, patch): ``patch`` copies the ``--pretrained_npz`` weights into
    the model (None without them)."""
    kw = dict(dtype=dtype, generator=generator)
    if args.use_pretrained:
        model, patch = create_timm_vit(
            "small", num_classes=args.num_classes, img_size=args.img_size,
            pretrained_npz=args.pretrained_npz, **kw,
        )
        if patch is None:
            print("WARNING: --use_pretrained without --pretrained_npz: "
                  "timm architecture with RANDOM init (convert timm weights "
                  "with fer_vit_tpu/encoders/convert_timm.py)")
        return model, patch
    if args.model_size == "tiny":
        return create_vit_tiny(args.num_classes, args.img_size, **kw), None
    if args.model_size == "small":
        return create_vit_small(args.num_classes, args.img_size, **kw), None
    if args.model_size == "base":
        return create_vit_base(args.num_classes, args.img_size, **kw), None
    return ImageViT(
        img_size=args.img_size, patch_size=args.patch_size,
        embed_dim=args.embed_dim, depth=args.depth, heads=args.heads,
        mlp_dim=args.mlp_dim, num_classes=args.num_classes,
        dropout=args.dropout, **kw,
    ), None


def main(args, device: DeviceLike = None) -> dict:
    device = resolve_device(device)
    dtype = policy_from_args(args)
    # dropout draws from torch's default generator (the reference seeds it)
    torch.manual_seed(args.seed)
    train_store = ImageStore.load(args.train_dir, args.img_size)
    val_store = ImageStore.load(args.val_dir, args.img_size)
    if args.data_fraction < 1.0:
        idx = train_store.balanced_subset_indices(args.data_fraction, args.seed)
        train_store = train_store.subset(idx)
        print(f"Data fraction {args.data_fraction}: {len(train_store)} samples")

    model, params_patch = build_model(
        args, dtype, torch.Generator().manual_seed(args.seed))
    if params_patch is not None:
        params_patch(model)

    cfg = TrainConfig(
        epochs=args.epochs, batch_size=args.batch_size, lr=args.lr,
        weight_decay=args.weight_decay, optimizer=args.optimizer,
        scheduler=args.scheduler, label_smoothing=args.label_smoothing,
        mixup=0.0,  # the reference image trainer has no mixup
        grad_clip=args.grad_clip or 0.0,
        use_class_weights=args.use_class_weights,
        num_classes=args.num_classes, seed=args.seed,
        eta_min=args.lr * 0.01,  # reference :291 cosine floor
    )

    aug_cfg = ImageAugmentConfig()
    augment_fn = (
        partial(image_augment, config=aug_cfg) if args.use_augmentation
        else (lambda generator, xb: normalize_images(xb)))

    class_weights = (train_store.class_weights(args.num_classes)
                     if args.use_class_weights else None)
    harness = Harness(model=model, cfg=cfg, class_weights=class_weights,
                      augment_fn=augment_fn, eval_transform=normalize_images,
                      device=device)
    print(f"Using device: {harness.device}")
    state = harness.init_state()
    state, start_epoch, initial_best, sched_state = load_resume(args, state)

    model_config = {
        "model_size": args.model_size, "img_size": args.img_size,
        "patch_size": args.patch_size, "embed_dim": args.embed_dim,
        "depth": args.depth, "heads": args.heads, "mlp_dim": args.mlp_dim,
        "num_classes": args.num_classes, "dropout": args.dropout,
        "use_pretrained": args.use_pretrained,
    }
    training_config = {
        "epochs": args.epochs, "batch_size": args.batch_size, "lr": args.lr,
        "weight_decay": args.weight_decay, "optimizer": args.optimizer,
        "scheduler": args.scheduler, "label_smoothing": args.label_smoothing,
        "use_class_weights": args.use_class_weights, "seed": args.seed,
        "data_fraction": args.data_fraction,
    }
    config = {"model": model_config, "training": training_config,
              "data": {"train_dir": args.train_dir, "val_dir": args.val_dir,
                       "train_samples": len(train_store),
                       "val_samples": len(val_store)}}

    base = create_experiment_name(
        {"depth": args.depth, "heads": args.heads, "dropout": args.dropout},
        training_config, is_latent=False, is_pretrained=args.use_pretrained,
    )
    experiment_name = f"{base}_frac{int(args.data_fraction * 100)}"
    logger = ExperimentLogger(experiment_name, base_dir=args.experiments_dir)
    logger.log_config(config)

    results = fit(harness, state, train_store.images, train_store.labels,
                  val_store.images, val_store.labels, logger,
                  start_epoch=start_epoch, initial_best_f1=initial_best,
                  scheduler_state=sched_state)
    final = dict(results["final_metrics"], data_fraction=args.data_fraction)
    logger.log_experiment_summary(final)
    logger.close()
    print(f"\nBest F1 macro: {results['best_f1']:.4f}")
    print(f"Experiment saved to: {logger.get_experiment_path()}")
    results["experiment_path"] = logger.get_experiment_path()
    return results


if __name__ == "__main__":
    main(build_parser().parse_args())
