"""InterFaceGAN-style latent decomposition into expression and identity parts.

Port of ``fer_vit_tpu/models/latent_decomposer.py`` (reference:
models_fer_vit/latent_decomposer.py:30-174). The class directions are a
constant (C, L, D) array, each L2-normalised over L * D, held as a
non-persistent buffer: not a parameter, and not in the state dict.

    proj = w_flat @ dirs^T                    (B, C), f32
    all_classes: w_expr = proj @ dirs         the sum of the projections
    max_class:   only the direction of the class with the largest |proj|
    w_id = w - w_expr

The projections run in f32 whatever the input's dtype (the JAX module's
``preferred_element_type``); w_expr is cast back to it. Directions load
from the ``.npz`` files of ``fer_vit_tpu/analysis/expression_directions.py``
or from the reference's ``.pt`` files.
"""

from __future__ import annotations

from typing import Literal, Tuple

import numpy as np
import torch
from torch import nn

OutputMode = Literal["expr_only", "id_only", "enhanced", "concat"]
DecomposeMode = Literal["all_classes", "max_class"]


def normalize_directions(dirs: np.ndarray) -> np.ndarray:
    """Each class direction L2-normalised over the flattened L * D (reference:
    latent_decomposer.py:57-65)."""
    c = dirs.shape[0]
    flat = np.asarray(dirs).reshape(c, -1).astype(np.float32)
    flat = flat / (np.linalg.norm(flat, axis=1, keepdims=True) + 1e-12)
    return flat.reshape(dirs.shape)


class LatentDecomposer(nn.Module):
    """Normalised class directions (C, seq_len, latent_dim) and the
    decomposition; ``from_array`` and ``from_file`` normalise."""

    def __init__(self, directions: np.ndarray, seq_len: int = 18,
                 latent_dim: int = 512):
        super().__init__()
        self.seq_len = seq_len
        self.latent_dim = latent_dim
        self.register_buffer(
            "directions", torch.from_numpy(np.array(directions, np.float32)),
            persistent=False)

    @property
    def num_classes(self) -> int:
        return self.directions.shape[0]

    @classmethod
    def from_array(cls, dirs: np.ndarray, seq_len: int = 18,
                   latent_dim: int = 512) -> "LatentDecomposer":
        return cls(normalize_directions(np.asarray(dirs)), seq_len,
                   latent_dim)

    @classmethod
    def from_file(cls, path: str) -> "LatentDecomposer":
        """Directions from an ``.npz`` (``directions``, ``seq_len``,
        ``latent_dim``) or a reference ``.pt`` (``{'directions': {class:
        (L, D) tensor}, 'seq_len', 'latent_dim'}``, reference
        latent_analysis/compute_expression_direction.py:119-142)."""
        if str(path).endswith(".npz"):
            with np.load(path) as data:
                dirs = np.asarray(data["directions"])
                seq_len = int(data["seq_len"]) if "seq_len" in data else 18
                latent_dim = (int(data["latent_dim"]) if "latent_dim" in data
                              else 512)
        else:
            data = torch.load(path, map_location="cpu", weights_only=True)
            dmap = data["directions"]
            dirs = np.stack([np.asarray(dmap[i].detach().float())
                             for i in range(len(dmap))])
            seq_len = int(data.get("seq_len", 18))
            latent_dim = int(data.get("latent_dim", 512))
        return cls.from_array(dirs, seq_len, latent_dim)

    def _flat(self) -> torch.Tensor:
        return self.directions.reshape(self.num_classes, -1)

    def get_expression_scores(self, w_plus: torch.Tensor) -> torch.Tensor:
        """(B, L, D) -> per-class SVM decision scores (B, C), f32."""
        return w_plus.reshape(w_plus.shape[0], -1).float() @ self._flat().t()

    def decompose(self, w_plus: torch.Tensor,
                  mode: DecomposeMode = "all_classes"
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(B, L, D) -> (w_expr, w_id), each (B, L, D) in w_plus's dtype."""
        dirs = self._flat()
        proj = self.get_expression_scores(w_plus)
        if mode == "all_classes":
            w_expr = proj @ dirs
        elif mode == "max_class":
            best = proj.abs().argmax(dim=1)
            w_expr = proj.gather(1, best[:, None]) * dirs[best]
        else:
            raise ValueError(f"Unknown mode: {mode!r}")
        w_expr = w_expr.reshape(w_plus.shape[0], self.seq_len,
                                self.latent_dim).to(w_plus.dtype)
        return w_expr, w_plus - w_expr

    def forward(self, w_plus: torch.Tensor,
                output_mode: OutputMode = "expr_only",
                enhance_alpha: float = 2.0,
                decompose_mode: DecomposeMode = "all_classes"
                ) -> torch.Tensor:
        """The ViT-ready transform; ``concat`` doubles seq_len to 2L
        (reference: latent_decomposer.py:147-174)."""
        w_expr, w_id = self.decompose(w_plus, decompose_mode)
        if output_mode == "expr_only":
            return w_expr
        if output_mode == "id_only":
            return w_id
        if output_mode == "enhanced":
            return w_id + enhance_alpha * w_expr
        if output_mode == "concat":
            return torch.cat([w_expr, w_id], dim=1)
        raise ValueError(f"Unknown output_mode: {output_mode!r}")
