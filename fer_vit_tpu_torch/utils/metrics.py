"""Classification metrics from a confusion matrix kept on the device.

Port of ``fer_vit_tpu/utils/metrics.py``. The train and eval epochs add each
batch into a (C, C) confusion matrix on the device (:func:`confusion_update`,
no host sync per step); the numpy reductions below derive accuracy, macro-F1,
weighted-F1 and per-class precision/recall/F1 from it once per epoch. They
equal sklearn's values, which are exact functions of the confusion matrix.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def confusion_update(cm: torch.Tensor, preds: torch.Tensor,
                     labels: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """Add a batch to a (C, C) confusion matrix (rows true, columns
    predicted). ``weights`` masks padding."""
    c = cm.shape[0]
    idx = labels.long() * c + preds.long()
    upd = torch.zeros(c * c, dtype=cm.dtype, device=cm.device)
    upd.index_add_(0, idx, weights.to(cm.dtype))
    return cm + upd.view(c, c)


def metrics_from_confusion(cm: np.ndarray) -> Dict[str, float]:
    """accuracy, f1_macro, f1_weighted, per-class precision/recall/f1."""
    cm = np.asarray(cm, dtype=np.float64)
    support = cm.sum(axis=1)  # true counts per class
    pred_count = cm.sum(axis=0)
    tp = np.diag(cm)
    total = cm.sum()

    with np.errstate(divide="ignore", invalid="ignore"):
        precision = np.where(pred_count > 0, tp / pred_count, 0.0)
        recall = np.where(support > 0, tp / support, 0.0)
        denom = precision + recall
        f1 = np.where(denom > 0, 2 * precision * recall / denom, 0.0)

    accuracy = float(tp.sum() / total) if total > 0 else 0.0
    # sklearn's macro average (labels=None) runs over the union of observed
    # true and predicted labels, not the fixed class set: a class absent
    # from both must not deflate macro-F1 (it drives best-ckpt selection).
    present = (support > 0) | (pred_count > 0)
    f1_macro = float(f1[present].mean()) if present.any() else 0.0
    f1_weighted = float((f1 * support).sum() / total) if total > 0 else 0.0
    return {
        "present": present,
        "accuracy": accuracy,
        "f1_macro": f1_macro,
        "f1_weighted": f1_weighted,
        "precision": precision,
        "recall": recall,
        "f1": f1,
        "support": support,
    }


def classification_report_dict(cm: np.ndarray,
                               class_names: Sequence[str]) -> Dict:
    """sklearn ``classification_report(..., output_dict=True)`` from the
    confusion matrix; the key names ('f1-score', 'macro avg', 'weighted
    avg') are a frozen contract of the eval JSON."""
    m = metrics_from_confusion(cm)
    present = m["present"]
    total = float(m["support"].sum())
    out = {
        name: {
            "precision": float(m["precision"][i]),
            "recall": float(m["recall"][i]),
            "f1-score": float(m["f1"][i]),
            "support": float(m["support"][i]),
        }
        for i, name in enumerate(class_names)
    }
    out["accuracy"] = float(m["accuracy"])
    p_macro = float(m["precision"][present].mean()) if present.any() else 0.0
    r_macro = float(m["recall"][present].mean()) if present.any() else 0.0
    out["macro avg"] = {"precision": p_macro, "recall": r_macro,
                        "f1-score": float(m["f1_macro"]), "support": total}
    w = m["support"] / max(total, 1.0)
    out["weighted avg"] = {
        "precision": float((m["precision"] * w).sum()),
        "recall": float((m["recall"] * w).sum()),
        "f1-score": float(m["f1_weighted"]), "support": total,
    }
    return out


def classification_report(cm: np.ndarray, class_names: Sequence[str]) -> str:
    """sklearn-style text report from the confusion matrix."""
    m = metrics_from_confusion(cm)
    lines = [f"{'':>12s} {'precision':>9s} {'recall':>9s} {'f1-score':>9s} {'support':>9s}", ""]
    for i, name in enumerate(class_names):
        lines.append(
            f"{name:>12s} {m['precision'][i]:9.2f} {m['recall'][i]:9.2f} "
            f"{m['f1'][i]:9.2f} {int(m['support'][i]):9d}"
        )
    total = int(m["support"].sum())
    present = m["present"]
    lines.append("")
    lines.append(f"{'accuracy':>12s} {'':9s} {'':9s} {m['accuracy']:9.2f} {total:9d}")
    p_macro = m["precision"][present].mean() if present.any() else 0.0
    r_macro = m["recall"][present].mean() if present.any() else 0.0
    lines.append(
        f"{'macro avg':>12s} {p_macro:9.2f} {r_macro:9.2f} "
        f"{m['f1_macro']:9.2f} {total:9d}"
    )
    w = m["support"] / max(total, 1)
    lines.append(
        f"{'weighted avg':>12s} {(m['precision'] * w).sum():9.2f} "
        f"{(m['recall'] * w).sum():9.2f} {m['f1_weighted']:9.2f} {total:9d}"
    )
    return "\n".join(lines)
