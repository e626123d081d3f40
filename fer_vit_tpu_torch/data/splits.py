"""Dataset splitting utilities.

A copy of ``fer_vit_tpu/data/splits.py``. The legacy reference
preprocessing kept a stratified train/val split (reference:
preprocessing.py:120-199, sklearn train_test_split with stratify=labels).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def stratified_split_indices(
    labels: np.ndarray, val_fraction: float = 0.2, seed: int = 42
) -> Tuple[np.ndarray, np.ndarray]:
    """Per-class proportional split → (train_idx, val_idx), both sorted.

    Matches sklearn's stratified semantics (each class contributes
    round(n_c · val_fraction) validation samples, at least 1 when the class
    has ≥2 samples).
    """
    labels = np.asarray(labels)
    rng = np.random.RandomState(seed)
    train_idx, val_idx = [], []
    for cls in np.unique(labels):
        idx = np.nonzero(labels == cls)[0]
        perm = rng.permutation(idx)
        n_val = int(round(len(idx) * val_fraction))
        if len(idx) >= 2:
            n_val = min(max(n_val, 1), len(idx) - 1)
        val_idx.extend(perm[:n_val])
        train_idx.extend(perm[n_val:])
    return (np.asarray(sorted(train_idx), np.int64),
            np.asarray(sorted(val_idx), np.int64))
