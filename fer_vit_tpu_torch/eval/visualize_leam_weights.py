"""Visualize learned LEAM layer weights from a checkpoint.

Port of ``fer_vit_tpu/eval/visualize_leam_weights.py`` (reference:
eval/visualize_leam_weights.py): read ``leam.layer_weights``, sigmoid it,
and draw the Coarse/Medium/Fine coloured bar chart. Reads the port's own
checkpoints, the JAX trainers' msgpack files and reference-format torch
files (:func:`fer_vit_tpu_torch.interop.checkpoints.read_checkpoint`).

Usage::

    python -m fer_vit_tpu_torch.eval.visualize_leam_weights last_model.pt
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from fer_vit_tpu_torch.interop.checkpoints import read_checkpoint

# Figure-contract constants (colours, 3.5/11.5 boundaries, labels, figsize,
# dpi) of the reference figure: (colour, span in w+ layers, legend text).
GROUPS = [
    ("#e74c3c", 4, "Coarse (layers 1-4: structure)"),
    ("#2ecc71", 8, "Medium (layers 5-12: expression)"),
    ("#3498db", 6, "Fine (layers 13-18: texture)"),
]
NO_LEAM = "checkpoint has no LEAM module (train with --use_leam)"


def extract_leam_weights(checkpoint_path: str) -> np.ndarray:
    """-> post-sigmoid (18,) weights from a LatentViTv2 checkpoint."""
    sd = read_checkpoint(checkpoint_path)["state_dict"]
    if "leam.layer_weights" not in sd:
        raise KeyError(NO_LEAM)
    raw_weights = sd["leam.layer_weights"].detach().float().numpy()
    return 1.0 / (1.0 + np.exp(-raw_weights))


def visualize_leam_weights(checkpoint_path: str,
                           save_path: Optional[str] = None) -> np.ndarray:
    weights = extract_leam_weights(checkpoint_path)
    n = len(weights)

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.patches as mpatches
    import matplotlib.pyplot as plt

    bar_colors = [c for c, span, _ in GROUPS for _ in range(span)][:n]
    fig, ax = plt.subplots(figsize=(12, 5))
    ax.bar(range(n), weights, color=bar_colors)
    boundary = -0.5
    for _, span, _label in GROUPS[:-1]:
        boundary += span
        ax.axvline(x=boundary, color="black", linestyle="--", linewidth=0.8)
    ax.legend(
        handles=[mpatches.Patch(color=c, label=lbl) for c, _, lbl in GROUPS],
        loc="upper right",
    )
    ax.set(
        xlabel="StyleGAN Layer Index",
        ylabel="LEAM Weight (after sigmoid)",
        title="LEAM: Learned Layer Importance Weights",
        xticks=range(n),
        xticklabels=[str(i + 1) for i in range(n)],
        ylim=(0, 1.0),
    )
    ax.grid(axis="y", alpha=0.3)
    fig.tight_layout()
    out = save_path or "leam_weights.png"
    fig.savefig(out, dpi=300, bbox_inches="tight")
    print(f"Saved: {out}")
    plt.close(fig)
    return weights


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        description="Visualize LEAM weights from a checkpoint")
    parser.add_argument("checkpoint")
    parser.add_argument("--save_path", default=None)
    args = parser.parse_args()
    visualize_leam_weights(args.checkpoint, args.save_path)
