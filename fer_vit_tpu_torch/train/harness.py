"""The shared training engine: train and eval epochs over a data set that
lives on the device (w+ latents, or uint8 images).

Port of ``fer_vit_tpu/train/harness.py``. Every reference trainer shares one
template: seeded determinism, class-balanced subsetting, inverse-frequency
class weights, AdamW with none/cosine/plateau schedules, mixup with a second
clean forward for the train metrics (reference:
train/train_latent_vit.py:108-148), best checkpoint on val macro-F1.

* The whole latent set is on the device; an epoch gathers each batch by
  index from it. The last partial batch is padded to the batch size and
  masked, so the loss and the metrics count every sample once.
* The loss sums and the confusion matrix stay device tensors for the whole
  epoch: nothing is read back per step.
* The random draws are split from the step: :meth:`Harness.draw` gives the
  mixup ratio and the partner permutation of a batch (from a host numpy
  ``Generator``), and :meth:`Harness.train_step` takes them as arguments,
  so a test can feed it the draws the JAX harness made. Augmentation noise
  comes from a ``torch.Generator`` on the device; dropout from torch's
  default generator.
* ``augment_fn(generator, xb)`` (the latent trainer's latent augmentation,
  the image trainer's augmentation and normalisation) runs on each
  training batch, and ``eval_transform(xb)`` (the image trainer's
  normalisation) before every eval and prediction forward: the image set
  stays uint8 on the device and each batch is transformed there.
* Per-parameter LR multipliers (``lr_mult``) and the weight-decay mask
  (``wd_mask``), both keyed by parameter name, become the optimizer's param
  groups; each epoch sets every group's LR to the epoch's LR times its
  multiplier. A multiplier of 0 freezes: the forward is the same, only the
  update differs.
* Models whose ``forward`` takes ``mask`` (the BatchNorm nets) get the
  batch's row mask in every training forward, so the pad rows of the last
  batch stay out of the batch statistics (as the JAX harness decides by
  signature). Training forwards run in ``train()`` mode and update the
  running statistics, the clean post-step forward too (the JAX step
  threads the loss forward's statistics into it and keeps what it
  returns); evaluation and predictions run in ``eval()`` mode on them.
* Data parallelism (JAX: the step jitted over a mesh's data axis): when a
  process group is up
  (:func:`fer_vit_tpu_torch.core.distributed.initialize`), every rank
  draws the same shuffle and mixup, builds the same global batch, and runs
  the forward on its slice of it (:func:`process_local_batch_slice`). The
  loss is the global batch's: the weight sums of the cross entropy are
  summed over the group before the division, and each rank's loss is its
  share of the numerator over that global sum, so summing the ranks'
  gradients (all-reduced before the update) gives the gradient of the
  global loss. ``MaskedBatchNorm`` takes its moments over the global batch
  too. The epoch's loss sums and confusion matrices are summed over the
  group at the end. Dropout masks are drawn per rank.
"""

from __future__ import annotations

import dataclasses
import inspect
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from fer_vit_tpu_torch.core import distributed
from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device
from fer_vit_tpu_torch.data.latent_augment import LatentAugmentConfig
from fer_vit_tpu_torch.train.losses import cross_entropy, cross_entropy_parts
from fer_vit_tpu_torch.utils.metrics import confusion_update


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    epochs: int = 60
    batch_size: int = 64
    lr: float = 1e-4
    weight_decay: float = 1e-2
    optimizer: str = "adamw"  # adamw | sgd
    momentum: float = 0.9  # sgd only
    scheduler: str = "plateau"  # none | cosine | plateau | warmup_cosine
    label_smoothing: float = 0.1
    mixup: float = 1.0  # Beta(α, α); 0 disables
    grad_clip: float = 0.0  # 0 disables
    use_class_weights: bool = False
    num_classes: int = 7
    seed: int = 42
    # the latent augmentation, as data: the latent trainers hand it to the
    # harness as ``augment_fn`` (``cli_common.run_latent_training``)
    augment: Optional[LatentAugmentConfig] = None
    eta_min: float = 0.0  # cosine floor (image trainer uses lr*0.01)
    # Train-metric source: the reference LATENT trainers run a clean
    # no-grad forward after the step unconditionally (even with mixup 0,
    # reference train/train_latent_vit.py:138-141) while the image/hybrid
    # trainers take metrics from the training forward itself. None = auto
    # (clean forward iff mixup > 0); latent trainers pass True.
    clean_metrics_forward: Optional[bool] = None


@dataclasses.dataclass
class TrainState:
    """The model (f32 parameters) and its optimizer, updated in place."""

    model: nn.Module
    optimizer: torch.optim.Optimizer

    def state_dict(self) -> dict:
        return {"model": self.model.state_dict(),
                "optimizer": self.optimizer.state_dict()}

    def load_state_dict(self, d: Mapping) -> None:
        self.model.load_state_dict(d["model"])
        self.optimizer.load_state_dict(d["optimizer"])


def param_groups(model: nn.Module, cfg: TrainConfig,
                 lr_mult: Optional[Mapping[str, float]] = None,
                 wd_mask: Optional[Mapping[str, bool]] = None) -> list:
    """The model's parameters grouped by (LR multiplier, weight decay), in
    the order of first appearance. A name missing from ``lr_mult`` has
    multiplier 1; one missing from ``wd_mask`` is decayed. As in the JAX
    package, the mask applies to AdamW only (its SGD decays every leaf)."""
    groups: Dict[Tuple[float, float], dict] = {}
    for name, p in model.named_parameters():
        mult = 1.0 if lr_mult is None else float(lr_mult.get(name, 1.0))
        decayed = cfg.optimizer != "adamw" or wd_mask is None or bool(
            wd_mask.get(name, True))
        wd = cfg.weight_decay if decayed else 0.0
        g = groups.setdefault((mult, wd), {"params": [], "lr_mult": mult,
                                           "lr": cfg.lr * mult,
                                           "weight_decay": wd})
        g["params"].append(p)
    return list(groups.values())


def make_optimizer(cfg: TrainConfig, model: nn.Module,
                   lr_mult: Optional[Mapping[str, float]] = None,
                   wd_mask: Optional[Mapping[str, bool]] = None
                   ) -> torch.optim.Optimizer:
    """The optimizer over :func:`param_groups`; each step sets every
    group's ``lr`` to the epoch's lr times the group's ``lr_mult``.

    AdamW: the JAX package runs ``optax.adamw(1.0)`` and scales its update
    by the epoch's lr, so p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd *
    p). ``torch.optim.AdamW`` with the same lr and wd takes p <- p * (1 - lr
    * wd), then p <- p - lr * m_hat / (sqrt(v_hat) + eps), with m and v from
    the gradient alone: the same step. SGD: torch's SGD with momentum adds
    wd * p to the gradient, keeps buf = momentum * buf + g (buf = g on the
    first step) and takes p <- p - lr * buf, as optax's
    add_decayed_weights -> trace -> scale(-1) times lr."""
    groups = param_groups(model, cfg, lr_mult, wd_mask)
    if cfg.optimizer == "adamw":
        return torch.optim.AdamW(groups, lr=cfg.lr, betas=(0.9, 0.999),
                                 eps=1e-8, weight_decay=cfg.weight_decay)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(groups, lr=cfg.lr, momentum=cfg.momentum,
                               weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer: {cfg.optimizer!r}")


def clip_grad_global_norm_(params, max_norm: float) -> None:
    """``optax.clip_by_global_norm``: when the global norm g of the
    gradients reaches ``max_norm``, each becomes t / g * max_norm. On the
    device, with no host sync."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g.float()) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


@dataclasses.dataclass(eq=False)
class Harness:
    """Train and eval epochs for one model and config.

    ``lr_mult`` (parameter name -> multiplier; 0 freezes), ``wd_mask``
    (parameter name -> False for no weight decay), ``augment_fn`` and
    ``eval_transform`` are optional. ``device``
    defaults to CUDA and raises without it; ``device="cpu"`` for the
    CPU."""

    model: nn.Module
    cfg: TrainConfig
    class_weights: Optional[np.ndarray] = None
    lr_mult: Optional[Mapping[str, float]] = None
    wd_mask: Optional[Mapping[str, bool]] = None
    device: DeviceLike = None
    # (generator, xb) -> xb, before each training forward
    augment_fn: Optional[Callable] = None
    # (xb) -> xb, before eval and prediction forwards
    eval_transform: Optional[Callable] = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        try:
            params = inspect.signature(self.model.forward).parameters
        except (TypeError, ValueError):
            params = {}
        self.accepts_mask = "mask" in params
        n = distributed.world_size()
        if self.cfg.batch_size % n:
            raise ValueError(f"batch_size ({self.cfg.batch_size}) must be a "
                             f"multiple of the process group's size ({n})")

    def _ce(self, logits, labels, class_weights, mask) -> torch.Tensor:
        """The cross entropy of the global batch; with data parallelism,
        this rank's share of it (its numerator over the group's weight
        sum)."""
        if not distributed.data_parallel():
            return cross_entropy(logits, labels, class_weights,
                                 self.cfg.label_smoothing, mask)
        num, den = cross_entropy_parts(logits, labels, class_weights,
                                       self.cfg.label_smoothing, mask)
        den = distributed.all_reduce_sum_(den.detach().clone())
        return num / den.clamp_min(1e-12)

    @staticmethod
    def _local(*tensors):
        """This rank's slice of each global-batch tensor (all of it
        without data parallelism)."""
        if not distributed.data_parallel():
            return tensors
        sl = distributed.process_local_batch_slice(tensors[0].shape[0])
        return tuple(t[sl] for t in tensors)

    @staticmethod
    def _global_loss(loss: torch.Tensor) -> torch.Tensor:
        """The global batch's loss from this rank's share of it."""
        loss = loss.detach()
        if distributed.data_parallel():
            loss = distributed.all_reduce_sum_(loss.clone())
        return loss

    def _train_forward(self, model: nn.Module, x: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
        return model(x, mask=mask) if self.accepts_mask else model(x)

    # -- state --------------------------------------------------------------

    def init_state(self) -> TrainState:
        """The model on the device (f32 parameters) and a fresh optimizer."""
        model = self.model.to(self.device)
        return TrainState(model, make_optimizer(self.cfg, model, self.lr_mult,
                                                self.wd_mask))

    def class_weight_tensor(self) -> Optional[torch.Tensor]:
        if self.class_weights is None:
            return None
        return torch.as_tensor(np.asarray(self.class_weights, np.float32),
                               device=self.device)

    # -- single steps -------------------------------------------------------

    def draw(self, rng: np.random.Generator,
             b: int) -> Tuple[float, torch.Tensor]:
        """One step's mixup draws: lam ~ Beta(mixup, mixup) rounded to f32
        (1 without mixup) and the partner permutation perm0 of b rows."""
        mixup = self.cfg.mixup
        lam = float(np.float32(rng.beta(mixup, mixup))) if mixup > 0 else 1.0
        perm0 = torch.from_numpy(rng.permutation(b)).to(self.device)
        return lam, perm0

    def train_step(self, state: TrainState, xb: torch.Tensor,
                   yb: torch.Tensor, mask: torch.Tensor, lr: float,
                   lam: float, perm0: torch.Tensor,
                   class_weights: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """One optimizer step on a (B, L, D) batch with row mask ``mask``
        (bool); ``lam`` and ``perm0`` from :meth:`draw`, ``generator`` for
        the augmentation. Returns the step's device-side stats; the
        parameters' ``.grad`` keep this step's gradients."""
        cfg = self.cfg
        model = state.model
        if self.augment_fn is not None:
            xb = self.augment_fn(generator, xb)

        b = xb.shape[0]
        # Pad-safe pairing: a row keeps its sampled partner only when both
        # rows are real; otherwise it mixes with itself (its input stays
        # exact and lam*CE + (1-lam)*CE is its plain CE). Pad rows are
        # zeroed so their values are deterministic. For full batches perm
        # == perm0, the reference's randperm mixing.
        perm = torch.where(mask & mask[perm0], perm0,
                           torch.arange(b, device=xb.device))
        xb = xb * mask.view((b,) + (1,) * (xb.dim() - 1)).to(xb.dtype)
        x_mixed = lam * xb + (1.0 - lam) * xb[perm]
        yb_perm = yb[perm]
        # with data parallelism, this rank's slice of the global batch
        x_mixed, xb, yb, yb_perm, mask = self._local(x_mixed, xb, yb,
                                                     yb_perm, mask)

        model.train()
        logits = self._train_forward(model, x_mixed, mask)
        loss_a = self._ce(logits, yb, class_weights, mask)
        # after the redirect both label streams share the row's own
        # validity (real rows mix with real rows, pads with pads)
        loss_b = self._ce(logits, yb_perm, class_weights, mask)
        loss = lam * loss_a + (1.0 - lam) * loss_b

        opt = state.optimizer
        for g in opt.param_groups:
            g["lr"] = lr * g["lr_mult"]
        opt.zero_grad(set_to_none=True)
        loss.backward()
        if distributed.data_parallel():
            distributed.all_reduce_grads_(model.parameters())
        if cfg.grad_clip > 0:
            clip_grad_global_norm_(model.parameters(), cfg.grad_clip)
        opt.step()

        clean_fwd = (cfg.mixup > 0 if cfg.clean_metrics_forward is None
                     else cfg.clean_metrics_forward)
        with torch.no_grad():
            if clean_fwd:
                # clean post-step forward in train mode for the train
                # metrics (reference: train/train_latent_vit.py:138-141);
                # it updates the running statistics a second time
                preds = self._train_forward(model, xb, mask).argmax(dim=-1)
            else:
                preds = logits.argmax(dim=-1)
            n_valid = mask.float().sum()
            return {"loss_sum": self._global_loss(loss) * n_valid,
                    "n": n_valid, "preds": preds, "labels": yb,
                    "mask": mask}

    def eval_input(self, xb: torch.Tensor) -> torch.Tensor:
        """``xb`` as the eval forwards take it (``eval_transform``)."""
        return xb if self.eval_transform is None else self.eval_transform(xb)

    @torch.no_grad()
    def eval_step(self, state: TrainState, xb, yb, mask,
                  class_weights=None) -> Dict[str, torch.Tensor]:
        state.model.eval()
        xb, yb, mask = self._local(xb, yb, mask)
        logits = state.model(self.eval_input(xb))
        loss = self._ce(logits, yb, class_weights, mask)
        n_valid = mask.float().sum()
        return {"loss_sum": self._global_loss(loss) * n_valid, "n": n_valid,
                "preds": logits.argmax(dim=-1), "labels": yb, "mask": mask,
                "logits": logits}

    # -- whole epochs ---------------------------------------------------------

    def batched_indices(self, rng: Optional[np.random.Generator],
                        n: int) -> torch.Tensor:
        """(steps, B) sample indices on the device, padded with -1;
        shuffled when ``rng`` is given."""
        bs = self.cfg.batch_size
        steps = -(-n // bs)
        idx = np.full(steps * bs, -1, np.int64)
        idx[:n] = rng.permutation(n) if rng is not None else np.arange(n)
        return torch.from_numpy(idx.reshape(steps, bs)).to(self.device)

    def _epoch(self, idx: torch.Tensor, data_x, data_y, step_fn):
        c = self.cfg.num_classes
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        loss_sum, n_sum = zero.clone(), zero.clone()
        cm = torch.zeros((c, c), dtype=torch.float32, device=self.device)
        for idx_b in idx:
            mask = idx_b >= 0
            safe = idx_b.clamp_min(0)
            stats = step_fn(data_x.index_select(0, safe),
                            data_y.index_select(0, safe), mask)
            cm = confusion_update(cm, stats["preds"], stats["labels"],
                                  stats["mask"])
            loss_sum += stats["loss_sum"]
            n_sum += stats["n"]
        if distributed.data_parallel():
            for t in (loss_sum, n_sum, cm):
                distributed.all_reduce_sum_(t)
        return loss_sum / n_sum.clamp_min(1.0), cm

    def train_epoch(self, state: TrainState, rng: np.random.Generator,
                    data_x: torch.Tensor, data_y: torch.Tensor, lr: float,
                    class_weights: Optional[torch.Tensor] = None):
        """One epoch: shuffle, then a step per batch. ``rng`` draws the
        shuffle, each step's mixup and the seed of the augmentation's
        device generator. Returns (mean loss, confusion matrix), both device
        tensors."""
        idx = self.batched_indices(rng, data_x.shape[0])
        gen = None
        if self.augment_fn is not None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(int(rng.integers(2 ** 62)))

        def step(xb, yb, mask):
            lam, perm0 = self.draw(rng, xb.shape[0])
            return self.train_step(state, xb, yb, mask, lr, lam, perm0,
                                   class_weights, gen)

        return self._epoch(idx, data_x, data_y, step)

    def eval_epoch(self, state: TrainState, data_x: torch.Tensor,
                   data_y: torch.Tensor,
                   class_weights: Optional[torch.Tensor] = None):
        """(mean loss, confusion matrix) over the set, in order."""
        idx = self.batched_indices(None, data_x.shape[0])
        return self._epoch(
            idx, data_x, data_y,
            lambda xb, yb, mask: self.eval_step(state, xb, yb, mask,
                                                class_weights))

    @torch.no_grad()
    def predictions(self, state: TrainState, data_x,
                    batch_size: Optional[int] = None):
        """Predictions and probabilities over a whole set (host arrays),
        in chunks of the batch size with the last chunk zero-padded."""
        bs = batch_size or self.cfg.batch_size
        state.model.eval()
        outs = []
        for i in range(0, data_x.shape[0], bs):
            xb = torch.as_tensor(data_x[i:i + bs]).to(self.device)
            valid = xb.shape[0]
            if valid < bs:
                xb = torch.cat([xb, xb.new_zeros((bs - valid,)
                                                 + tuple(xb.shape[1:]))])
            outs.append(state.model(self.eval_input(xb))[:valid]
                        .float().cpu())
        logits = (torch.cat(outs) if outs
                  else torch.zeros((0, self.cfg.num_classes)))
        probs = torch.softmax(logits, dim=-1)
        return logits.argmax(dim=-1).numpy(), probs.numpy()
