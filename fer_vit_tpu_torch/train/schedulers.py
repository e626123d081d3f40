"""Epoch-level LR schedulers with torch semantics.

A copy of ``fer_vit_tpu/train/schedulers.py`` (the port imports nothing of
the JAX package), so that checkpoints hold the same scheduler JSON. The
reference steps schedulers once per epoch (reference:
train/train_latent_vit.py:352-356): ``cosine`` = CosineAnnealingLR(T_max=
epochs) (eta_min 0 for latent trainers, lr·0.01 for the image trainer,
reference train/train_image_vit.py:288-293), ``plateau`` =
ReduceLROnPlateau(mode=max, patience=5, factor=0.5), ``warmup_cosine`` =
LambdaLR with linear warmup over min(10, epochs//10) epochs then cosine
(reference train/train_image_vit.py:302-312).

The harness sets each epoch's LR on the optimizer's param groups before the
epoch runs, so data-dependent schedules (plateau) need nothing more.
"""

from __future__ import annotations

import math
from typing import Optional


class Scheduler:
    """Base: constant LR."""

    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.lr = base_lr

    def epoch_lr(self, epoch: int) -> float:
        """LR to use for 1-indexed ``epoch`` (call before the epoch runs)."""
        return self.lr

    def step(self, metric: Optional[float] = None) -> None:
        """Called after each epoch (torch ``scheduler.step()`` position)."""

    def state_dict(self) -> dict:
        """Serializable state for exact resume (torch scheduler analogue).
        Closed-form schedules (cosine, warmup_cosine) derive the LR purely
        from the epoch index, so the base dict suffices for them."""
        return {"lr": self.lr}

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d["lr"])


class CosineScheduler(Scheduler):
    def __init__(self, base_lr: float, t_max: int, eta_min: float = 0.0):
        super().__init__(base_lr)
        self.t_max = t_max
        self.eta_min = eta_min

    def epoch_lr(self, epoch: int) -> float:
        # torch: epoch 1 uses base lr; epoch e uses the (e-1)-step closed form.
        k = epoch - 1
        return self.eta_min + (self.base_lr - self.eta_min) * 0.5 * (
            1 + math.cos(math.pi * k / self.t_max)
        )


class PlateauScheduler(Scheduler):
    """ReduceLROnPlateau(mode='max', patience=5, factor=0.5, threshold=1e-4
    rel) — torch defaults plus the reference's explicit arguments."""

    def __init__(self, base_lr: float, patience: int = 5, factor: float = 0.5,
                 threshold: float = 1e-4):
        super().__init__(base_lr)
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.best = -math.inf
        self.num_bad = 0

    def step(self, metric: Optional[float] = None) -> None:
        if metric is None:
            return
        # torch threshold_mode='rel', mode='max': better iff a > best*(1+eps)
        if metric > self.best * (1 + self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr *= self.factor
                self.num_bad = 0

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: dict) -> None:
        self.lr = float(d["lr"])
        self.best = float(d.get("best", -math.inf))
        self.num_bad = int(d.get("num_bad", 0))


class WarmupCosineScheduler(Scheduler):
    def __init__(self, base_lr: float, epochs: int):
        super().__init__(base_lr)
        self.epochs = epochs
        self.warmup = min(10, epochs // 10)

    def epoch_lr(self, epoch: int) -> float:
        k = epoch - 1  # torch LambdaLR last_epoch counter
        if self.warmup > 0 and k < self.warmup:
            return self.base_lr * (k + 1) / self.warmup
        denom = max(self.epochs - self.warmup, 1)
        progress = (k - self.warmup) / denom
        return self.base_lr * 0.5 * (1 + math.cos(math.pi * progress))


def make_scheduler(name: str, base_lr: float, epochs: int,
                   eta_min: float = 0.0) -> Scheduler:
    if name in (None, "none"):
        return Scheduler(base_lr)
    if name == "cosine":
        return CosineScheduler(base_lr, t_max=epochs, eta_min=eta_min)
    if name == "plateau":
        return PlateauScheduler(base_lr)
    if name == "warmup_cosine":
        return WarmupCosineScheduler(base_lr, epochs)
    raise ValueError(f"unknown scheduler: {name!r}")
