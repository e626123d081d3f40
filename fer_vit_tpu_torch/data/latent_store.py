"""The latent set as two host arrays, loaded once.

Port of ``fer_vit_tpu/data/latent_store.py`` (host-side numpy, as there).
The reference reads one ``.pt`` file per sample through DataLoader workers
every epoch (reference: data/latent_dataset.py:52-136); here the whole set
is loaded once into ``(N, L, D)`` latents and ``(N,)`` labels, which the
training harness puts on the device, so no epoch does host I/O
(FER2013-scale ≈ 35k × 18 × 512 × 4 B ≈ 1.3 GB).

Supported sources:
* a directory of reference-format ``.pt`` files ``{latent, label[, img_path]}``
  (read with ``torch.load(weights_only=True)``, once; a pack is cached next
  to them);
* a packed ``.npz`` with ``latents``/``labels``[/``paths``] (written by
  :func:`pack_latent_dir` or :mod:`fer_vit_tpu_torch.data.generate_latents`);
* a directory containing such ``.npz`` shards.
"""

from __future__ import annotations

import dataclasses
import os
from collections import Counter
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from fer_vit_tpu_torch import EMOTION_NAMES

PACK_NAME = "latents_pack.npz"


@dataclasses.dataclass
class LatentStore:
    latents: np.ndarray  # (N, L, D) float32
    labels: np.ndarray  # (N,) int32
    total: Optional[int] = None  # pre-subset sample count (None = unsubset)
    # source image path per sample when the on-disk format carries it
    # (reference .pt records' 'img_path'; generate_latents packs' 'paths')
    # — the AFS DiskImageProvider (provider B) needs these
    img_paths: Optional[np.ndarray] = None  # (N,) str

    def __len__(self) -> int:
        return self.latents.shape[0]

    @property
    def total_samples(self) -> int:
        """Size of the full dataset before any --data_fraction subsetting
        (the reference's config key ``data.train_samples_total``,
        reference: train/train_latent_vit.py)."""
        return self.total if self.total is not None else len(self)

    @property
    def seq_len(self) -> int:
        return self.latents.shape[1]

    @property
    def latent_dim(self) -> int:
        return self.latents.shape[2]

    def get_class_counts(self) -> Dict[int, int]:
        return dict(sorted(Counter(self.labels.tolist()).items()))

    @staticmethod
    def get_class_names() -> Dict[int, str]:
        return dict(enumerate(EMOTION_NAMES))

    # -- loading ------------------------------------------------------------

    @classmethod
    def load(cls, path: str, pack_cache: bool = True) -> "LatentStore":
        """Load latents from a .npz pack, a dir of .npz shards, or a dir of
        reference .pt files (slow path; optionally caches a pack next to it)."""
        if os.path.isfile(path):
            return cls._load_npz([path])
        if not os.path.isdir(path):
            raise FileNotFoundError(f"Latent directory not found: {path}")

        pack = os.path.join(path, PACK_NAME)
        if os.path.exists(pack):
            return cls._load_npz([pack])
        npz_files = sorted(
            os.path.join(path, f) for f in os.listdir(path) if f.endswith(".npz")
        )
        if npz_files:
            return cls._load_npz(npz_files)

        pt_files = sorted(
            os.path.join(path, f) for f in os.listdir(path) if f.endswith(".pt")
        )
        if not pt_files:
            raise ValueError(f"No .npz or .pt latent files found in {path}")
        store = cls._load_pt(pt_files)
        if pack_cache:
            try:
                extra = ({"paths": store.img_paths}
                         if store.img_paths is not None else {})
                np.savez(pack, latents=store.latents, labels=store.labels,
                         **extra)
            except OSError:
                pass  # read-only data dir: fine, just skip the cache
        print(f"Loaded {len(store)} latent samples from {path}")
        return store

    @classmethod
    def _load_npz(cls, files) -> "LatentStore":
        lat, lab, paths = [], [], []
        for f in files:
            with np.load(f) as data:
                lat.append(np.asarray(data["latents"], dtype=np.float32))
                lab.append(np.asarray(data["labels"], dtype=np.int32))
                if "paths" in data.files:
                    paths.append(np.asarray(data["paths"], dtype=str))
        latents = np.concatenate(lat)
        img_paths = (np.concatenate(paths)
                     if paths and sum(p.shape[0] for p in paths)
                     == latents.shape[0] else None)
        store = cls(latents, np.concatenate(lab), img_paths=img_paths)
        print(f"Loaded {len(store)} latent samples from {len(files)} pack(s)")
        return store

    @classmethod
    def _load_pt(cls, files) -> "LatentStore":
        out_lat, out_lab, out_paths = [], [], []
        for f in files:
            data = torch.load(f, map_location="cpu", weights_only=True)
            out_lat.append(np.asarray(data["latent"], dtype=np.float32))
            out_lab.append(int(data["label"]))
            out_paths.append(str(data.get("img_path", "")))
        img_paths = (np.asarray(out_paths, dtype=str)
                     if all(out_paths) else None)
        return cls(np.stack(out_lat), np.asarray(out_lab, dtype=np.int32),
                   img_paths=img_paths)

    # -- subsetting / weighting --------------------------------------------

    def balanced_subset_indices(self, fraction: float, seed: int = 42) -> np.ndarray:
        """Class-balanced subsampling: per class keep max(1, int(n·frac)),
        chosen with a seed-reset RNG per class — reproducing the reference's
        selection semantics exactly (reference: train/train_latent_vit.py:43-77,
        including the per-class np.random.seed at :67)."""
        if fraction >= 1.0:
            return np.arange(len(self))
        selected = []
        for class_id in sorted(set(self.labels.tolist())):
            indices = np.nonzero(self.labels == class_id)[0]
            n_select = max(1, int(len(indices) * fraction))
            rng = np.random.RandomState(seed)
            selected.extend(rng.choice(indices, n_select, replace=False))
        return np.asarray(sorted(selected), dtype=np.int64)

    def subset(self, indices: np.ndarray) -> "LatentStore":
        return LatentStore(self.latents[indices], self.labels[indices],
                           total=self.total_samples,
                           img_paths=(self.img_paths[indices]
                                      if self.img_paths is not None
                                      else None))

    def class_weights(self, num_classes: int = 7) -> np.ndarray:
        """Inverse-frequency weights total/(C·count) (reference:
        train/train_latent_vit.py:80-105)."""
        counts = Counter(self.labels.tolist())
        total = len(self)
        return np.asarray(
            [
                total / (num_classes * counts[i]) if counts.get(i) else 1.0
                for i in range(num_classes)
            ],
            dtype=np.float32,
        )


def pack_latent_dir(latent_dir: str, out_path: Optional[str] = None) -> str:
    """One-time conversion: reference .pt dir → packed .npz."""
    store = LatentStore.load(latent_dir, pack_cache=False)
    out_path = out_path or os.path.join(latent_dir, PACK_NAME)
    np.savez(out_path, latents=store.latents, labels=store.labels)
    return out_path


def train_val_arrays(
    train_dir: str, val_dir: str, data_fraction: float = 1.0, seed: int = 42
) -> Tuple[LatentStore, LatentStore]:
    train = LatentStore.load(train_dir)
    val = LatentStore.load(val_dir)
    if data_fraction < 1.0:
        idx = train.balanced_subset_indices(data_fraction, seed)
        train = train.subset(idx)
    return train, val
