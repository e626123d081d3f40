"""LatentViTv2: LatentViT with optional w+ preprocessing modules.

Port of ``fer_vit_tpu/models/latent_vit_v2.py`` (reference:
models_fer_vit/latent_vit_v2.py:7-101). The order is SPE -> LWN -> LEAM ->
the LatentViT backbone (the reference's code order). Parameters carry the
reference's names: ``spe.*``, ``lwn.*``, ``leam.*``, ``backbone.*``. The
backbone is :class:`~fer_vit_tpu_torch.models.latent_vit.LatentViT`, whose
transformer layers start as deep copies of one (torch's
``nn.TransformerEncoder``), as the JAX module's ``torch_clone_init =
"full"``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fer_vit_tpu_torch.core.dtypes import compute_dtype
from fer_vit_tpu_torch.models.latent_vit import LatentViT
from fer_vit_tpu_torch.nn.preprocessing import LEAM, LayerWiseNorm, SemanticPE


class LatentViTv2(nn.Module):
    """``dtype`` is the compute dtype (None: bf16 on CUDA, f32 elsewhere);
    parameters are f32. ``generator`` draws the initial weights."""

    def __init__(self, latent_dim: int = 512, seq_len: int = 18,
                 embed_dim: int = 512, depth: int = 6, heads: int = 8,
                 mlp_dim: int = 2048, num_classes: int = 7,
                 dropout: float = 0.1, use_lwn: bool = False,
                 use_lwn_residual: bool = False, use_spe: bool = False,
                 use_leam: bool = False, *,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.flags = dict(use_lwn=use_lwn, use_lwn_residual=use_lwn_residual,
                          use_spe=use_spe, use_leam=use_leam)
        self.spe = (SemanticPE(latent_dim, seq_len, generator)
                    if use_spe else None)
        self.lwn = (LayerWiseNorm(seq_len, latent_dim, use_lwn_residual)
                    if use_lwn else None)
        self.leam = LEAM(seq_len) if use_leam else None
        self.backbone = LatentViT(
            latent_dim=latent_dim, seq_len=seq_len, embed_dim=embed_dim,
            depth=depth, heads=heads, mlp_dim=mlp_dim,
            num_classes=num_classes, dropout=dropout, dtype=dtype,
            generator=generator)

    def forward(self, w_plus: torch.Tensor) -> torch.Tensor:
        """(B, seq_len, latent_dim) -> logits (B, num_classes) f32."""
        x = w_plus.to(compute_dtype(w_plus.device, self.dtype))
        for m in (self.spe, self.lwn, self.leam):
            if m is not None:
                x = m(x)
        return self.backbone(x)

    def get_config(self) -> dict:
        """Model config for experiment logs (reference:
        latent_vit_v2.py:93-101)."""
        return {"model": "LatentViTv2", **self.flags}
