"""Plot learning curves from TensorBoard-exported CSVs (Step/Value columns)
or the experiment dirs' ``logs/scalars.jsonl`` files.

Port of ``fer_vit_tpu/eval/plot_logs.py`` (reference: eval/plot_logs.py);
the CSV branch needs pandas, as there. Usage::

    python -m fer_vit_tpu_torch.eval.plot_logs -f run/logs/scalars.jsonl
"""

from __future__ import annotations

import argparse
import json
import os


def _load_curve(path: str, tag: str = "val_acc"):
    """→ (steps, values) from a CSV (Step,Value) or scalars.jsonl."""
    if path.endswith(".jsonl"):
        steps, values = [], []
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec["tag"] == tag:
                    steps.append(rec["step"])
                    values.append(rec["value"])
        return steps, values
    import pandas as pd

    df = pd.read_csv(path)
    df.columns = [c.strip() for c in df.columns]
    if "Step" not in df.columns or "Value" not in df.columns:
        raise ValueError(f"{path}: missing Step/Value columns")
    return df["Step"].tolist(), df["Value"].tolist()


def plot_learning_curves(file_paths, custom_labels=None, tag: str = "val_acc",
                         save_path: str | None = None):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 6))
    for i, file_path in enumerate(file_paths):
        if not os.path.exists(file_path):
            print(f"warning: file not found: {file_path}")
            continue
        steps, values = _load_curve(file_path, tag)
        label = (custom_labels[i] if custom_labels and i < len(custom_labels)
                 else os.path.basename(file_path))
        plt.plot(steps, values, marker=".", label=label)
    plt.xlabel("Epoch (Step)")
    plt.ylabel("Accuracy")
    plt.grid(True, which="both", linestyle="--", alpha=0.7)
    plt.legend()
    plt.tight_layout()
    out = save_path or "learning_curves.png"
    plt.savefig(out, dpi=150)
    print(f"Saved: {out}")
    plt.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description="Plot learning-log curves")
    parser.add_argument("-f", "--files", nargs="+", required=True)
    parser.add_argument("-l", "--labels", nargs="+")
    parser.add_argument("--tag", default="val_acc")
    parser.add_argument("--save_path", default=None)
    args = parser.parse_args()
    plot_learning_curves(args.files, args.labels, args.tag, args.save_path)
