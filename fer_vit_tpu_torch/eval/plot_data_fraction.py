"""Data-efficiency comparison figure (accuracy vs training-data fraction).

Port of ``fer_vit_tpu/eval/plot_data_fraction.py`` (reference:
eval/plot_data_fraction.py — its accuracy table is hardcoded from the
authors' runs). Values can be overridden from a JSON file of
``{series_name: [acc@10, acc@25, acc@50, acc@100]}``.
"""

from __future__ import annotations

import argparse
import json

FRACTIONS = [10, 25, 50, 100]
# Reference baseline numbers (eval/plot_data_fraction.py:6-9 / BASELINE.md).
DEFAULT_SERIES = {
    "Image ViT (Pre-trained on ImageNet)": ([0.47, 0.58, 0.66, 0.70],
                                            "o-", "#f1c40f", 2),
    "Latent ViT (Proposed)": ([0.40, 0.45, 0.50, 0.54], "o-", "#2980b9", 3),
    "Latent CNN": ([0.14, 0.38, 0.44, 0.48], "s--", "#7f8c8d", 2),
    "Image ViT (Scratch)": ([0.23, 0.30, 0.36, 0.46], "^--", "#e67e22", 2),
}


def plot(series=None, out_path: str = "data_efficiency_final.png"):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(10, 6))
    for label, spec in (series or DEFAULT_SERIES).items():
        if isinstance(spec, tuple):
            values, style, color, lw = spec
            plt.plot(FRACTIONS, values, style, color=color, label=label,
                     linewidth=lw, markersize=8)
        else:
            plt.plot(FRACTIONS, spec, "o-", label=label, markersize=8)
    plt.xlabel("Training Data Fraction (%)", fontsize=12)
    plt.ylabel("Test Accuracy", fontsize=12)
    plt.ylim(0, 0.8)
    plt.xticks(FRACTIONS, [f"{x}%" for x in FRACTIONS])
    plt.grid(True, linestyle="--", alpha=0.7)
    plt.legend(fontsize=11)
    plt.tight_layout()
    plt.savefig(out_path, dpi=300)
    print(f"Saved: {out_path}")
    plt.close()


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("--values_json", default=None,
                        help="JSON {name: [acc@10,25,50,100]} overriding defaults")
    parser.add_argument("--out", default="data_efficiency_final.png")
    args = parser.parse_args()
    series = None
    if args.values_json:
        with open(args.values_json) as f:
            series = json.load(f)
    plot(series, args.out)
