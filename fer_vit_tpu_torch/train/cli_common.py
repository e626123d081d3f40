"""Shared argparse groups and run plumbing for the latent-model trainer CLIs.

Port of ``fer_vit_tpu/train/cli_common.py``: each CLI builds its model and
``TrainConfig``, then :func:`run_latent_training` does the rest (harness,
resume, logger, fit, summary). Where the JAX module builds a data-parallel
mesh over several devices, the port runs data-parallel over a process group
of more than one process (:func:`fer_vit_tpu_torch.core.distributed.initialize`;
the harness splits each global batch and sums the gradients), and rank 0
alone writes the logs and checkpoints.
"""

from __future__ import annotations

import argparse
from functools import partial
from typing import Optional

import torch

from fer_vit_tpu_torch.core import distributed
from fer_vit_tpu_torch.core.dtypes import DeviceLike
from fer_vit_tpu_torch.data.latent_augment import (get_latent_train_transforms,
                                                   latent_augment)
from fer_vit_tpu_torch.data.latent_store import train_val_arrays
from fer_vit_tpu_torch.train.harness import Harness, TrainConfig
from fer_vit_tpu_torch.train.loop import fit
from fer_vit_tpu_torch.utils.experiment_logger import ExperimentLogger


def add_data_args(parser: argparse.ArgumentParser, augmentation: bool = True):
    parser.add_argument("--latent_train_dir", required=True)
    parser.add_argument("--latent_val_dir", required=True)
    parser.add_argument("--data_fraction", type=float, default=1.0)
    if augmentation:
        parser.add_argument("--use_augmentation", action="store_true")
        parser.add_argument("--latent_noise", type=float, default=0.1)
        parser.add_argument("--latent_mask", type=float, default=0.1)


def add_training_args(parser: argparse.ArgumentParser, mixup: bool = True):
    parser.add_argument("--epochs", type=int, default=60)
    parser.add_argument("--batch_size", type=int, default=64)
    parser.add_argument("--lr", type=float, default=1e-4)
    parser.add_argument("--weight_decay", type=float, default=1e-2)
    parser.add_argument("--scheduler", choices=["none", "cosine", "plateau"],
                        default="plateau")
    parser.add_argument("--use_class_weights", action="store_true")
    parser.add_argument("--label_smoothing", type=float, default=0.1)
    if mixup:
        parser.add_argument("--mixup", type=float, default=1.0)


def add_misc_args(parser: argparse.ArgumentParser):
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--experiments_dir", default="experiments")
    parser.add_argument("--no_bf16", action="store_true",
                        help="force f32 compute even on CUDA")
    parser.add_argument("--resume", default=None,
                        help="checkpoint path (last_model.pt) to resume from "
                             "— full state: params, optimizer, epoch")
    parser.add_argument("--debug_nans", action="store_true",
                        help="enable autograd anomaly detection (errors at "
                             "the first backward op giving a NaN)")


def policy_from_args(args) -> Optional[torch.dtype]:
    """The compute dtype: f32 with ``--no_bf16``, else None (bf16 on CUDA,
    f32 on the CPU). Parameters stay f32 either way. ``--debug_nans``
    turns on autograd's anomaly detection (it raises at the first backward
    op that gives a NaN)."""
    if getattr(args, "debug_nans", False):
        torch.autograd.set_detect_anomaly(True)
    return torch.float32 if args.no_bf16 else None


def augment_from_args(args):
    if getattr(args, "use_augmentation", False):
        return get_latent_train_transforms(
            noise_std=args.latent_noise,
            scale_range=(0.9, 1.1),
            mask_prob=args.latent_mask,
        )
    return None


def load_resume(args, state):
    """Restore (state, start_epoch, initial_best_f1, scheduler_state) from
    ``--resume``: the model, the optimizer, the epoch, the best-F1 seed and
    the exact scheduler state."""
    resume_path = getattr(args, "resume", None)
    if not resume_path:
        return state, 1, 0.0, None
    loaded = ExperimentLogger.load_checkpoint(resume_path, state=state)
    initial_best = float(loaded["metrics"].get("best_f1_macro")
                         or loaded["metrics"].get("f1_macro") or 0.0)
    print(f"Resumed from {resume_path} at epoch {loaded['epoch']} "
          f"(best f1 {initial_best:.4f})")
    return (loaded["state"], loaded["epoch"] + 1, initial_best,
            loaded.get("scheduler_state"))


class _NullLogger:
    """The logger of a rank other than 0: it writes nothing."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


def run_latent_training(
    args,
    model: torch.nn.Module,
    cfg: TrainConfig,
    experiment_name: str,
    config: dict,
    train_store,
    val_store,
    lr_mult=None,
    init_params_patch=None,
    wd_mask=None,
    lr_group_mults=None,
    device: DeviceLike = None,
) -> dict:
    """Common tail of every latent trainer: harness, logging, fit, summary.
    ``init_params_patch(model)`` (e.g. a pretrained trunk's graft) changes
    the freshly initialised model in place, after init and before
    ``--resume``. ``device`` defaults to CUDA and raises without it."""
    class_weights = (
        train_store.class_weights(cfg.num_classes)
        if args.use_class_weights else None
    )
    if class_weights is not None:
        print(f"Class weights: {class_weights}")

    augment_fn = (partial(latent_augment, config=cfg.augment)
                  if cfg.augment is not None and cfg.augment.enabled
                  else None)
    harness = Harness(model=model, cfg=cfg, class_weights=class_weights,
                      lr_mult=lr_mult, wd_mask=wd_mask, augment_fn=augment_fn,
                      device=device)
    print(f"Using device: {harness.device}")
    if distributed.data_parallel():
        print(f"Data-parallel over {distributed.world_size()} processes "
              f"(rank {distributed.rank()})")
    state = harness.init_state()
    if init_params_patch is not None:
        init_params_patch(state.model)
    state, start_epoch, initial_best, sched_state = load_resume(args, state)

    rank0 = distributed.rank() == 0
    logger = (ExperimentLogger(experiment_name, base_dir=args.experiments_dir)
              if rank0 else _NullLogger())
    logger.log_config(config)
    results = fit(
        harness, state,
        train_store.latents, train_store.labels,
        val_store.latents, val_store.labels,
        logger,
        start_epoch=start_epoch,
        initial_best_f1=initial_best,
        scheduler_state=sched_state,
        lr_group_mults=lr_group_mults,
        verbose=rank0,
    )
    final = dict(results["final_metrics"],
                 data_fraction=getattr(args, "data_fraction", 1.0))
    logger.log_experiment_summary(final)
    logger.close()
    print(f"\nBest F1 macro: {results['best_f1']:.4f}")
    print(f"Experiment results: {logger.get_experiment_path()}")
    results["experiment_path"] = logger.get_experiment_path()
    return results


def load_stores(args):
    train_store, val_store = train_val_arrays(
        args.latent_train_dir, args.latent_val_dir,
        getattr(args, "data_fraction", 1.0), args.seed,
    )
    print(f"Train samples: {len(train_store)}  Val samples: {len(val_store)}")
    if getattr(args, "seq_len", 0) <= 0 and hasattr(args, "seq_len"):
        args.seq_len = train_store.seq_len
        print(f"Inferred seq_len from latents: {args.seq_len}")
    return train_store, val_store
