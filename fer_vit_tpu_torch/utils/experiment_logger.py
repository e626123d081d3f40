"""Experiment management and logging: the reference's on-disk contract.

Port of ``fer_vit_tpu/utils/experiment_logger.py``. The eval and plotting
tools read this layout, so it is frozen:

* run dirs:  ``experiments/<exp_name>/<YYYYmmdd_HHMMSS>/{checkpoints,logs}``
* scalar tags (``logs/scalars.jsonl``, and TensorBoard where
  ``torch.utils.tensorboard`` imports): the unified 6-metric set
  (``train_loss`` … ``val_f1``), ``Learning_Rate/Group_{i}``,
  ``Parameters/<name>``, ``Gradients/<name>``, ``Gradient_Norm/<name>``
* ``config.json`` at run start; ``experiment_summary.json`` with
  ``{experiment_name, run_id, duration_seconds, final_metrics, config}``
* ``checkpoints/last_model.pt`` on every save, ``best_model.pt`` on
  improvement, each holding ``{epoch, state, metrics, config, run_id}``
  (plus ``scheduler_state`` when present), with ``metrics``, ``config`` and
  ``scheduler_state`` as JSON strings.

``state`` is the model's and the optimizer's ``state_dict``s (``{"model":
..., "optimizer": ...}``), written with ``torch.save``; the JAX package
stores its TrainState as Flax msgpack under the same file names and keys.
"""

from __future__ import annotations

import json
import os
import time
from datetime import datetime
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

try:  # TensorBoard events where the writer imports; scalars.jsonl always
    from torch.utils.tensorboard import SummaryWriter

    _TB_AVAILABLE = True
except Exception:  # pragma: no cover
    SummaryWriter = None
    _TB_AVAILABLE = False


def _host(t) -> np.ndarray:
    return t.detach().float().cpu().numpy() if torch.is_tensor(t) \
        else np.asarray(t)


class ExperimentLogger:
    """Drop-in equivalent of the reference logger (same public methods)."""

    def __init__(self, experiment_name: str, base_dir: str = "experiments"):
        self.experiment_name = experiment_name
        self.base_dir = base_dir
        self.experiment_dir = os.path.join(base_dir, experiment_name)
        timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
        self.run_dir = os.path.join(self.experiment_dir, timestamp)
        os.makedirs(os.path.join(self.run_dir, "checkpoints"), exist_ok=True)
        os.makedirs(os.path.join(self.run_dir, "logs"), exist_ok=True)

        self._log_dir = os.path.join(self.run_dir, "logs")
        self.writer = SummaryWriter(self._log_dir) if _TB_AVAILABLE else None
        self._scalar_file = open(
            os.path.join(self._log_dir, "scalars.jsonl"), "a", encoding="utf-8",
            buffering=1,  # line-buffered: a crash must not lose logged scalars
        )
        self.config: Dict[str, Any] = {}
        self.start_time = time.time()

    # -- scalars ------------------------------------------------------------

    def _add_scalar(self, tag: str, value: float, step: int) -> None:
        if self.writer is not None:
            self.writer.add_scalar(tag, value, step)
        self._scalar_file.write(
            json.dumps({"tag": tag, "value": float(value), "step": int(step)}) + "\n"
        )

    def log_config(self, config: Dict[str, Any]) -> None:
        self.config = config
        path = os.path.join(self.run_dir, "config.json")
        with open(path, "w") as f:
            json.dump(config, f, indent=2)
        print(f"Config saved to {path}")

    def log_metrics(self, metrics: Dict[str, float], step: int) -> None:
        for key, value in metrics.items():
            self._add_scalar(key, float(value), step)

    def log_learning_rate(self, lr_by_group, epoch: int) -> None:
        """lr_by_group: float or list of per-group lrs (layer-wise LR)."""
        if not isinstance(lr_by_group, (list, tuple)):
            lr_by_group = [lr_by_group]
        for i, lr in enumerate(lr_by_group):
            self._add_scalar(f"Learning_Rate/Group_{i}", float(lr), epoch)

    def log_parameters(self, params: Mapping[str, torch.Tensor],
                       epoch: int) -> None:
        """``params``: dotted name -> tensor (``named_parameters``)."""
        if self.writer is None:
            return
        for name, arr in params.items():
            self.writer.add_histogram(f"Parameters/{name}", _host(arr), epoch)

    def log_gradients(self, grads: Mapping[str, torch.Tensor],
                      epoch: int) -> None:
        for name, arr in grads.items():
            arr = _host(arr)
            if self.writer is not None:
                self.writer.add_histogram(f"Gradients/{name}", arr, epoch)
            self._add_scalar(
                f"Gradient_Norm/{name}", float(np.linalg.norm(arr)), epoch
            )

    def log_confusion_matrix(self, y_true, y_pred, class_names, epoch: int,
                             cm: Optional[np.ndarray] = None) -> None:
        """Accepts either label arrays (reference signature) or a precomputed
        confusion matrix via ``cm=``."""
        if cm is None:
            c = len(class_names)
            cm = np.zeros((c, c), dtype=np.int64)
            for t, p in zip(np.asarray(y_true), np.asarray(y_pred)):
                cm[int(t), int(p)] += 1
        row_sums = cm.sum(axis=1, keepdims=True)
        cm_norm = np.divide(cm, np.maximum(row_sums, 1), dtype=np.float64)
        fig = self._plot_confusion_matrix(cm_norm, class_names)
        if fig is not None and self.writer is not None:
            self.writer.add_figure(f"Confusion_Matrix/Epoch_{epoch}", fig, epoch)
        np.save(os.path.join(self._log_dir, f"confusion_epoch{epoch}.npy"), cm)

    @staticmethod
    def _plot_confusion_matrix(cm: np.ndarray, class_names):
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            import seaborn as sns
        except ImportError:
            return None
        fig, ax = plt.subplots(figsize=(8, 6))
        sns.heatmap(cm, annot=True, fmt=".2f", cmap="Blues",
                    xticklabels=class_names, yticklabels=class_names, ax=ax)
        ax.set_title("Confusion Matrix")
        ax.set_xlabel("Predicted")
        ax.set_ylabel("Actual")
        plt.tight_layout()
        return fig

    # -- checkpoints --------------------------------------------------------

    def save_checkpoint(self, state, epoch: int, metrics: Dict[str, Any],
                        is_best: bool = False,
                        scheduler_state: Optional[Dict[str, Any]] = None) -> None:
        """Write last_model.pt (every call) and best_model.pt (on
        improvement). ``state`` has ``state_dict()`` (the harness's
        :class:`~fer_vit_tpu_torch.train.harness.TrainState`).
        ``scheduler_state`` rides along so that a resumed run replays the
        exact LR sequence."""
        metrics = {
            k: (float(v) if np.isscalar(v) or getattr(v, "ndim", 1) == 0 else None)
            for k, v in metrics.items()
        }
        payload = {
            "epoch": int(epoch),
            "state": state.state_dict(),
            "metrics": json.dumps(metrics),
            "config": json.dumps(self.config),
            "run_id": self.run_dir,
        }
        if scheduler_state is not None:
            payload["scheduler_state"] = json.dumps(scheduler_state)
        paths = [os.path.join(self.run_dir, "checkpoints", "last_model.pt")]
        if is_best:
            paths.append(os.path.join(self.run_dir, "checkpoints",
                                      "best_model.pt"))
        for path in paths:
            torch.save(payload, path)
        if is_best:
            print(f"Best model saved at epoch {epoch}")

    @staticmethod
    def load_checkpoint(path: str, state=None, map_location=None) -> dict:
        """Load a checkpoint. With ``state`` (a TrainState), its model and
        optimizer are restored in place and it is returned under 'state';
        else the raw state dicts are returned under 'state_dict'."""
        payload = torch.load(path, map_location=map_location or "cpu",
                             weights_only=True)
        out = {
            "epoch": payload["epoch"],
            "metrics": json.loads(payload["metrics"]),
            "config": json.loads(payload["config"]),
            "run_id": payload["run_id"],
            "scheduler_state": (
                json.loads(payload["scheduler_state"])
                if "scheduler_state" in payload else None
            ),
        }
        if state is not None:
            state.load_state_dict(payload["state"])
            out["state"] = state
        else:
            out["state_dict"] = payload["state"]
        return out

    # -- summary ------------------------------------------------------------

    def log_experiment_summary(self, final_metrics: Dict[str, float]) -> None:
        duration = time.time() - self.start_time
        summary = {
            "experiment_name": self.experiment_name,
            "run_id": self.run_dir,
            "duration_seconds": duration,
            "final_metrics": {k: float(v) for k, v in final_metrics.items()},
            "config": self.config,
        }
        path = os.path.join(self.run_dir, "experiment_summary.json")
        with open(path, "w") as f:
            json.dump(summary, f, indent=2)
        print(f"Experiment summary saved to {path}")
        print(f"Total duration: {duration:.2f} seconds")

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
        self._scalar_file.close()

    def get_experiment_path(self) -> str:
        return self.run_dir


def create_experiment_name(model_config: Dict[str, Any],
                           training_config: Dict[str, Any],
                           is_latent: bool = True,
                           is_pretrained: bool = False) -> str:
    """Auto experiment naming, identical to the reference
    (utils/experiment_logger.py:223-255)."""
    kind = "latent_vit" if is_latent else "image_vit"
    model_name = (
        f"{kind}_d{model_config.get('depth', 6)}"
        f"_h{model_config.get('heads', 8)}"
        f"_do{model_config.get('dropout', 0.1)}"
    )
    lr = training_config.get("lr", 1e-4)
    batch_size = training_config.get("batch_size", 64)
    epochs = training_config.get("epochs", 60)
    mixup = training_config.get("mixup", 1.0)
    if is_latent:
        training_name = f"lr{lr}_bs{batch_size}_ep{epochs}_Mixup{mixup}"
    elif is_pretrained:
        training_name = f"lr{lr}_bs{batch_size}_ep{epochs}_pretrained"
    else:
        training_name = f"lr{lr}_bs{batch_size}_ep{epochs}"
    encoder_info = ""
    if "encoder_type" in training_config:
        encoder_info = f"_{training_config['encoder_type']}"
    return f"{model_name}_{training_name}{encoder_info}"
