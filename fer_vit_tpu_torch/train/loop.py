"""The fit loop shared by the trainer CLIs.

Port of ``fer_vit_tpu/train/loop.py``, with the reference's per-epoch
protocol (reference: train/train_latent_vit.py:307-382): train epoch ->
eval -> the 6 metrics -> LR log -> parameter and gradient histograms every
10 epochs -> best checkpoint on val macro-F1 -> scheduler step -> the final
classification report and confusion matrix. The loss sums and confusion
matrices are read from the device once per epoch.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from fer_vit_tpu_torch import EMOTION_NAMES
from fer_vit_tpu_torch.train.harness import Harness, TrainState
from fer_vit_tpu_torch.train.losses import cross_entropy
from fer_vit_tpu_torch.train.schedulers import make_scheduler
from fer_vit_tpu_torch.utils.experiment_logger import ExperimentLogger
from fer_vit_tpu_torch.utils.metrics import (classification_report,
                                             metrics_from_confusion)


def grad_snapshot(harness: Harness, state: TrainState, xb, yb,
                  class_weights) -> Dict[str, torch.Tensor]:
    """Gradients of the plain CE loss (eval mode) on one batch, by
    parameter name, for the every-10-epoch gradient histograms (reference:
    train/train_latent_vit.py:342-344). The parameters' ``.grad`` are left
    as they were."""
    model = state.model
    model.eval()
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    loss = cross_entropy(model(xb), yb, class_weights,
                         harness.cfg.label_smoothing)
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return {n: g for (n, _), g in zip(named, grads)}


def epoch_rng(seed: int, epoch: int) -> np.random.Generator:
    """The host generator of one epoch's draws: a function of the seed and
    the epoch alone, so a resumed run draws what an uninterrupted one
    would."""
    return np.random.default_rng([seed, epoch])


def fit(
    harness: Harness,
    state: TrainState,
    train_x: np.ndarray,
    train_y: np.ndarray,
    val_x: np.ndarray,
    val_y: np.ndarray,
    logger: ExperimentLogger,
    best_metric: str = "f1_macro",
    hist_every: int = 10,
    verbose: bool = True,
    start_epoch: int = 1,
    initial_best_f1: float = 0.0,
    scheduler_state: Dict | None = None,
    lr_group_mults=None,
) -> Dict:
    # The checkpoint summary key ('best_f1_macro'), the resume seed
    # (initial_best_f1) and the plateau scheduler's monitored quantity all
    # encode macro-F1 (the reference's fixed best criterion); reject
    # anything else rather than silently mixing metrics.
    if best_metric != "f1_macro":
        raise ValueError(
            f"best_metric={best_metric!r} unsupported: checkpoint summary, "
            "resume seeding and plateau stepping are wired to 'f1_macro'")
    cfg = harness.cfg
    dev = harness.device
    # the latent set lives on the device for the whole run
    train_x = torch.as_tensor(np.asarray(train_x, np.float32), device=dev)
    train_y = torch.as_tensor(np.asarray(train_y, np.int64), device=dev)
    val_x = torch.as_tensor(np.asarray(val_x, np.float32), device=dev)
    val_y = torch.as_tensor(np.asarray(val_y, np.int64), device=dev)
    class_weights = harness.class_weight_tensor()

    sched = make_scheduler(cfg.scheduler, cfg.lr, cfg.epochs, eta_min=cfg.eta_min)

    best_f1 = initial_best_f1
    history = []
    if scheduler_state is not None:
        # Exact resume: checkpoints carry Scheduler.state_dict() captured
        # after that epoch's step, so restoring it replays the identical LR
        # sequence (incl. plateau decay history).
        sched.load_state_dict(scheduler_state)
    else:
        # Checkpoints without scheduler state: re-observe best_f1 once
        # (approximate: plateau decays are lost; 'none' and 'cosine' are
        # closed-form in the epoch index and replay exactly).
        if start_epoch > 1 and cfg.scheduler == "plateau":
            print(
                "WARNING: resuming from a checkpoint without saved "
                "scheduler state — plateau decay history is lost; the LR "
                "sequence will NOT exactly match an uninterrupted run.",
                flush=True)
        for past in range(1, start_epoch):
            sched.step(best_f1 if past == start_epoch - 1 else None)
    val_cm = None
    for epoch in range(start_epoch, cfg.epochs + 1):
        lr = sched.epoch_lr(epoch)
        train_loss, train_cm = harness.train_epoch(
            state, epoch_rng(cfg.seed, epoch), train_x, train_y, lr,
            class_weights)
        val_loss, val_cm = harness.eval_epoch(state, val_x, val_y,
                                              class_weights)

        tm = metrics_from_confusion(train_cm.cpu().numpy())
        vm = metrics_from_confusion(val_cm.cpu().numpy())
        metrics = {
            "train_loss": float(train_loss),
            "train_acc": tm["accuracy"],
            "train_f1": tm["f1_macro"],
            "val_loss": float(val_loss),
            "val_acc": vm["accuracy"],
            "val_f1": vm["f1_macro"],
        }
        history.append(metrics)
        if verbose:
            print(
                f"Epoch {epoch}/{cfg.epochs}: "
                f"train_loss={metrics['train_loss']:.4f} "
                f"train_acc={metrics['train_acc']:.4f} "
                f"train_f1={metrics['train_f1']:.4f} "
                f"val_loss={metrics['val_loss']:.4f} "
                f"val_acc={metrics['val_acc']:.4f} "
                f"val_f1={metrics['val_f1']:.4f}"
            )
        logger.log_metrics(metrics, epoch)
        # layer-wise-LR runs emit the reference's per-group tags
        # (Learning_Rate/Group_i, reference utils/experiment_logger.py:173-177)
        logger.log_learning_rate(
            [lr * m for m in lr_group_mults] if lr_group_mults else lr,
            epoch)

        if hist_every and epoch % hist_every == 0:
            bs = min(cfg.batch_size, train_x.shape[0])
            grads = grad_snapshot(harness, state, train_x[:bs],
                                  train_y[:bs], class_weights)
            logger.log_parameters(dict(state.model.named_parameters()),
                                  epoch)
            logger.log_gradients(grads, epoch)

        current = vm[best_metric]
        is_best = current > best_f1
        if is_best:
            best_f1 = current
            if verbose:
                print(f"  → Best model (F1: {best_f1:.4f})")
        # Step the scheduler before checkpointing so the saved
        # scheduler_state is exactly the state a resume at epoch+1 needs.
        sched.step(metrics["val_f1"])

        # every epoch: last_model.pt holds the final epoch (so --resume
        # loses nothing after the last improvement), best_model.pt the best
        val_summary = {
            "loss": metrics["val_loss"],
            "accuracy": metrics["val_acc"],
            "f1_macro": metrics["val_f1"],
            "f1_weighted": vm["f1_weighted"],
            # running best, so resume restores best-model tracking exactly
            "best_f1_macro": best_f1,
        }
        logger.save_checkpoint(state, epoch, val_summary, is_best,
                               scheduler_state=sched.state_dict())

    # Final evaluation + report (reference: train_latent_vit.py:358-382).
    # The last epoch already evaluated this exact state, so only evaluate
    # when no epoch ran (resuming at or past cfg.epochs).
    if val_cm is None:
        _, val_cm = harness.eval_epoch(state, val_x, val_y, class_weights)
    val_cm = val_cm.cpu().numpy()
    vm = metrics_from_confusion(val_cm)
    names = [n.capitalize() for n in EMOTION_NAMES]
    if verbose:
        print("\nClassification Report:")
        print(classification_report(val_cm, names))
    logger.log_confusion_matrix(None, None, names, cfg.epochs, cm=val_cm)
    final_metrics = {
        "accuracy": vm["accuracy"],
        "f1_macro": vm["f1_macro"],
        "f1_weighted": vm["f1_weighted"],
        "best_f1_macro": best_f1,
    }
    return {
        "state": state,
        "best_f1": best_f1,
        "final_metrics": final_metrics,
        "final_confusion": val_cm,
        "history": history,
    }
