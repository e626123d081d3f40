"""Evaluate a trained latent-model checkpoint.

Port of ``fer_vit_tpu/eval/evaluate_model.py`` (reference:
eval/evaluate_model.py): the model loads through
:func:`fer_vit_tpu_torch.interop.checkpoints.load_model`; then test
metrics, confusion matrices (normalised and counts), per-class
precision/recall/F1 bars, prediction-confidence histograms, CLS-token
similarity figures and two JSON files: ``evaluation_report.json`` and the
reference's frozen ``evaluation_results.json``.

CLI (the reference's flags; ``--device`` picks the device, CUDA unless
``--device cpu``)::

    python -m fer_vit_tpu_torch.eval.evaluate_model \
        --checkpoint_path best_model.pt --latent_test_dir latents/test
"""

from __future__ import annotations

import argparse
import json
import os
import re
from typing import Callable, Optional

import numpy as np
import torch

from fer_vit_tpu_torch import EMOTION_NAMES
from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device
from fer_vit_tpu_torch.interop import checkpoints
from fer_vit_tpu_torch.utils.metrics import (classification_report,
                                             classification_report_dict,
                                             confusion_update,
                                             metrics_from_confusion)

# the transformer layers whose outputs the attention figure reads:
# LatentViT's ``transformer.layers.{i}`` (LatentViTv2: under ``backbone.``)
# and the hybrid's timm blocks ``transformer.{i}``
LAYER_NAME = re.compile(r"(?:^|\.)transformer\.(?:layers\.)?(\d+)$")


def predict_arrays(model: torch.nn.Module, x: np.ndarray, labels: np.ndarray,
                   batch_size: int, device: torch.device,
                   transform: Optional[Callable] = None):
    """(predictions, probabilities, confusion matrix) of ``model`` in eval
    mode over host array ``x`` in batches (the last one short, not padded);
    ``transform`` maps each batch on the device before the model."""
    model = model.to(device).eval()
    preds, probs = [], []
    cm = torch.zeros((7, 7), device=device)
    with torch.inference_mode():
        for i in range(0, len(x), batch_size):
            xb = torch.as_tensor(x[i:i + batch_size]).to(device)
            logits = model(xb if transform is None else transform(xb))
            p = torch.argmax(logits, dim=-1)
            probs.append(torch.softmax(logits.float(), dim=-1).cpu().numpy())
            preds.append(p.cpu().numpy())
            yb = torch.as_tensor(labels[i:i + batch_size]).to(device)
            cm = confusion_update(cm, p, yb,
                                  torch.ones_like(p, dtype=cm.dtype))
    return np.concatenate(preds), np.concatenate(probs), cm.cpu().numpy()


def evaluate(model: torch.nn.Module, store, batch_size: int = 32,
             device: DeviceLike = None):
    """-> (predictions, probabilities, confusion_matrix) over a
    :class:`~fer_vit_tpu_torch.data.latent_store.LatentStore`; ``device``
    defaults to CUDA."""
    return predict_arrays(model, store.latents, store.labels, batch_size,
                          resolve_device(device))


def _plots(cm, probs, preds, labels, out_dir) -> bool:
    """The five figures (JAX file names); False, and nothing written, when
    matplotlib or seaborn does not import."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import seaborn as sns
    except ImportError:
        return False
    names = [n.capitalize() for n in EMOTION_NAMES]

    # normalized + counts confusion matrices
    for norm, fname in ((True, "confusion_matrix_normalized.png"),
                        (False, "confusion_matrix_counts.png")):
        fig, ax = plt.subplots(figsize=(8, 6))
        data = cm / np.maximum(cm.sum(1, keepdims=True), 1) if norm else cm
        sns.heatmap(data, annot=True, fmt=".2f" if norm else ".0f",
                    cmap="Blues", xticklabels=names, yticklabels=names, ax=ax)
        ax.set_xlabel("Predicted")
        ax.set_ylabel("Actual")
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, fname), dpi=120)
        plt.close(fig)

    # combined two-panel figure under the reference's filename
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(16, 6))
    sns.heatmap(cm / np.maximum(cm.sum(1, keepdims=True), 1), annot=True,
                fmt=".2%", cmap="Blues", xticklabels=names,
                yticklabels=names, ax=ax1)
    ax1.set_title("Confusion Matrix (Normalized)")
    sns.heatmap(cm, annot=True, fmt=".0f", cmap="Greens",
                xticklabels=names, yticklabels=names, ax=ax2)
    ax2.set_title("Confusion Matrix (Counts)")
    for ax in (ax1, ax2):
        ax.set_xlabel("Predicted")
        ax.set_ylabel("Actual")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "confusion_matrix.png"), dpi=120)
    plt.close(fig)

    # per-class precision/recall/F1 bars
    m = metrics_from_confusion(cm)
    x = np.arange(7)
    fig, ax = plt.subplots(figsize=(10, 5))
    for i, key in enumerate(("precision", "recall", "f1")):
        ax.bar(x + (i - 1) * 0.25, m[key], width=0.25, label=key)
    ax.set_xticks(x, names)
    ax.legend()
    ax.set_title("Per-class metrics")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "class_metrics.png"), dpi=120)
    plt.close(fig)

    # confidence histograms (correct vs incorrect)
    conf = probs.max(axis=1)
    correct = preds == labels
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.hist(conf[correct], bins=30, alpha=0.6, label="correct")
    ax.hist(conf[~correct], bins=30, alpha=0.6, label="incorrect")
    ax.set_xlabel("Prediction confidence")
    ax.legend()
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "prediction_confidence.png"), dpi=120)
    plt.close(fig)
    return True


def cls_similarities(model: torch.nn.Module, x: torch.Tensor):
    """Per transformer layer (sorted by index), the cosine similarity of
    each sample's CLS token to each w+ token in that layer's output: (N,
    layers, L) f32, or None for a model without transformer layers (the
    CNNs). The outputs are read by forward hooks, the counterpart of the
    JAX ``capture_intermediates``."""
    layers = sorted((int(m.group(1)), mod) for name, mod in
                    model.named_modules() if (m := LAYER_NAME.search(name)))
    if not layers:
        return None
    outs = {}
    hooks = [mod.register_forward_hook(
        lambda _m, _i, out, idx=idx: outs.__setitem__(idx, out))
        for idx, mod in layers]
    try:
        with torch.inference_mode():
            model.eval()(x)
    finally:
        for h in hooks:
            h.remove()
    sims = []
    for idx, _ in layers:
        h = outs[idx].float().cpu().numpy()  # (N, L+1, D)
        cls, toks = h[:, :1], h[:, 1:]
        denom = (np.linalg.norm(toks, axis=2)
                 * np.maximum(np.linalg.norm(cls, axis=2), 1e-8))
        sims.append(np.einsum("nld,nd->nl", toks, cls[:, 0])
                    / np.maximum(denom, 1e-8))
    return np.stack(sims, axis=1).astype(np.float32)


def visualize_attention(model: torch.nn.Module, sample_latents: np.ndarray,
                        out_dir: str, n_samples: int = 5,
                        device: DeviceLike = None) -> None:
    """CLS-token similarity "attention" figures, ``attention_sample_{s}.png``
    (:func:`cls_similarities`); nothing without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    dev = resolve_device(device)
    x = torch.as_tensor(sample_latents[:n_samples]).to(dev)
    sims = cls_similarities(model.to(dev), x)
    if sims is None:
        print("attention viz skipped: no transformer layer captures found")
        return
    for s in range(sims.shape[0]):
        fig, ax = plt.subplots(figsize=(10, 4))
        im = ax.imshow(sims[s], cmap="viridis", aspect="auto")
        ax.set_xlabel("Latent Token Index")
        ax.set_ylabel("Transformer Layer")
        ax.set_title(f"CLS-token similarity — sample {s}")
        fig.colorbar(im, ax=ax)
        fig.tight_layout()
        fig.savefig(os.path.join(out_dir, f"attention_sample_{s}.png"),
                    dpi=120)
        plt.close(fig)


def results_summary(cm: np.ndarray, config: dict, checkpoint_path: str,
                    n: int) -> dict:
    """``evaluation_results.json``: the reference's frozen schema, which
    downstream tooling reads."""
    names = [name.capitalize() for name in EMOTION_NAMES]
    return {
        "accuracy": metrics_from_confusion(cm)["accuracy"],
        "classification_report": classification_report_dict(cm, names),
        "model_config": config.get("model", config),
        "checkpoint_path": checkpoint_path,
        "test_dataset_size": n,
    }


def write_json(path: str, obj: dict) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def build_parser() -> argparse.ArgumentParser:
    """The reference's CLI; ``--device`` selects the device (CUDA unless
    ``cpu``)."""
    parser = argparse.ArgumentParser(description="Evaluate trained model")
    parser.add_argument("--checkpoint_path", required=True)
    parser.add_argument("--latent_test_dir", required=True)
    parser.add_argument("--output_dir", default="eval_results")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--visualize_samples", type=int, default=5)
    return parser


def main(args) -> dict:
    from fer_vit_tpu_torch.data.latent_store import LatentStore

    dev = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    model, config = checkpoints.load_model(args.checkpoint_path)
    store = LatentStore.load(args.latent_test_dir)
    preds, probs, cm = evaluate(model, store, args.batch_size, dev)

    m = metrics_from_confusion(cm)
    names = [n.capitalize() for n in EMOTION_NAMES]
    print("\nClassification Report:")
    print(classification_report(cm, names))

    _plots(cm, probs, preds, store.labels, args.output_dir)
    if args.visualize_samples > 0:
        visualize_attention(model, store.latents, args.output_dir,
                            args.visualize_samples, dev)

    report = {
        "checkpoint": args.checkpoint_path,
        "test_dir": args.latent_test_dir,
        "num_samples": len(store),
        "accuracy": m["accuracy"],
        "f1_macro": m["f1_macro"],
        "f1_weighted": m["f1_weighted"],
        "per_class": {
            EMOTION_NAMES[i]: {
                "precision": float(m["precision"][i]),
                "recall": float(m["recall"][i]),
                "f1": float(m["f1"][i]),
                "support": int(m["support"][i]),
            }
            for i in range(7)
        },
        "config": config,
    }
    report_path = os.path.join(args.output_dir, "evaluation_report.json")
    write_json(report_path, report)
    print(f"\nReport saved to {report_path}")
    results_path = os.path.join(args.output_dir, "evaluation_results.json")
    write_json(results_path, results_summary(cm, config,
                                             args.checkpoint_path,
                                             len(store)))
    print(f"Summary: {results_path}")
    return report


if __name__ == "__main__":
    main(build_parser().parse_args())
