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
from collections import Counter
from datetime import datetime
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

from fer_vit_tpu_torch.interop.torch_state import read_port_payload

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

    def log_learning_curves(self, train_loss: float,
                            val_metrics: Dict[str, float],
                            epoch: int) -> None:
        """Reference API (utils/experiment_logger.py:54-62)."""
        self._add_scalar("Loss/Train", float(train_loss), epoch)
        for key, value in val_metrics.items():
            if key in ("accuracy", "f1_macro", "f1_weighted"):
                self._add_scalar(f"Validation/{key}", float(value), epoch)

    def log_model_architecture(self, model: torch.nn.Module,
                               input_shape) -> str:
        """The reference's TensorBoard graph (``add_graph`` on a
        ``(1, *input_shape)`` input) as text: a parameter table (the state
        dict's dotted names without the buffers, shape, #params) with its
        TOTAL, then the module tree (``str(model)``) and a count of module
        types, written as TensorBoard text under ``Model/Architecture`` and
        to ``logs/model_architecture.txt``. Returns the text."""
        buffers = {name for name, _ in model.named_buffers()}
        lines = [f"Model: {type(model).__name__}",
                 f"Input shape: (1, {', '.join(str(s) for s in input_shape)})",
                 "", "Parameters:",
                 f"  {'name':<60} {'shape':<20} {'#params':>12}"]
        total = 0
        for name, t in model.state_dict().items():
            if name in buffers:
                continue
            total += t.numel()
            shape = str(tuple(t.shape))
            lines.append(f"  {name:<60} {shape:<20} {t.numel():>12,}")
        lines += [f"  {'TOTAL':<60} {'':<20} {total:>12,}", ""]
        types = Counter(type(m).__name__ for m in model.modules())
        lines.append(f"Modules: {sum(types.values())}")
        lines.append("Module types: " + ", ".join(
            f"{k}×{v}" for k, v in sorted(types.items(),
                                          key=lambda kv: (-kv[1], kv[0]))))
        lines += ["", "Module tree:", str(model)]
        summary = "\n".join(lines)
        with open(os.path.join(self._log_dir, "model_architecture.txt"),
                  "w", encoding="utf-8") as f:
            f.write(summary + "\n")
        if self.writer is not None:
            self.writer.add_text("Model/Architecture",
                                 "```\n" + summary + "\n```")
        return summary

    def log_hyperparameters(self, hparams: Dict[str, Any],
                            metrics: Dict[str, float]) -> None:
        """Reference API (:70-72); TensorBoard hparams where the writer
        takes them, and ``logs/hparams.json`` always."""
        if self.writer is not None:
            try:
                self.writer.add_hparams(
                    {k: v for k, v in hparams.items()
                     if isinstance(v, (int, float, str, bool))},
                    {k: float(v) for k, v in metrics.items()},
                )
            except Exception as e:  # TB's hparams plugin is optional
                print(f"TensorBoard hparams not written: {e}")
        with open(os.path.join(self._log_dir, "hparams.json"), "w") as f:
            json.dump({"hparams": hparams, "metrics": metrics}, f,
                      indent=2, default=str)

    def log_attention_weights(self, attention_weights, epoch: int,
                              sample_idx: int = 0) -> None:
        """Reference API (:148-163): heatmap of attention weights, to
        TensorBoard and ``logs/attention_s{sample}_e{epoch}.png``; nothing
        without matplotlib."""
        try:
            import matplotlib

            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            return
        fig, ax = plt.subplots(figsize=(10, 6))
        im = ax.imshow(_host(attention_weights), cmap="viridis",
                       aspect="auto")
        ax.set_title(f"Attention Weights - Sample {sample_idx}")
        ax.set_xlabel("Latent Token Index")
        ax.set_ylabel("Attention Head")
        fig.colorbar(im, ax=ax)
        fig.tight_layout()
        if self.writer is not None:
            self.writer.add_figure(f"Attention/Sample_{sample_idx}", fig,
                                   epoch)
        fig.savefig(os.path.join(self._log_dir,
                                 f"attention_s{sample_idx}_e{epoch}.png"),
                    dpi=120)
        plt.close(fig)

    def log_images(self, latents, labels, predictions, epoch: int,
                   max_images: int = 8) -> None:
        """Reference API (:184-192): latent statistics histograms (the
        inputs are latents, not images)."""
        del labels, predictions, max_images
        arr = _host(latents)
        if self.writer is not None:
            self.writer.add_histogram("Latent_Statistics/Mean",
                                      arr.mean(axis=(1, 2)), epoch)
            self.writer.add_histogram("Latent_Statistics/Std",
                                      arr.std(axis=(1, 2)), epoch)

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
        out = read_port_payload(torch.load(
            path, map_location=map_location or "cpu", weights_only=True))
        if state is not None:
            state.load_state_dict(out["state"])
            out["state"] = state
        else:
            out["state_dict"] = out.pop("state")
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


def load_experiment_config(experiment_path: str) -> Dict[str, Any]:
    config_path = os.path.join(experiment_path, "config.json")
    with open(config_path, "r") as f:
        return json.load(f)


def compare_experiments(experiment_dirs,
                        metric: str = "f1_macro") -> Dict[str, float]:
    """Compare final metrics across runs (reference: :268-281)."""
    results: Dict[str, float] = {}
    for exp_dir in experiment_dirs:
        summary_path = os.path.join(exp_dir, "experiment_summary.json")
        if os.path.exists(summary_path):
            with open(summary_path) as f:
                summary = json.load(f)
            name = summary.get("experiment_name", os.path.basename(exp_dir))
            results[name] = summary.get("final_metrics", {}).get(metric, 0.0)
    return results
