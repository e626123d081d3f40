"""LatentViT — the classifier over StyleGAN w+ codes.

Port of ``fer_vit_tpu/models/latent_vit.py`` (reference LatentViT):
(B, L, latent_dim) -> Linear -> prepend CLS -> + learned positions ->
depth x post-norm transformer (ReLU FFN) -> LayerNorm + Linear on the CLS
token -> f32 logits. Parameter names follow the reference
(``input_proj``, ``cls_token``, ``pos_emb``, ``transformer.layers.{i}``,
``mlp_head.0/1``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fer_vit_tpu_torch.core.dtypes import compute_dtype
from fer_vit_tpu_torch.nn.initializers import reset_linear_
from fer_vit_tpu_torch.nn.transformer import (TransformerEncoder, layer_norm,
                                              linear)


class LatentViT(nn.Module):
    """``dtype`` is the compute dtype (None: bf16 on CUDA, f32 elsewhere);
    parameters are f32. ``generator`` draws the initial weights
    (``cls_token`` and ``pos_emb`` from randn, as the reference)."""

    def __init__(self, latent_dim: int = 512, seq_len: int = 18,
                 embed_dim: int = 512, depth: int = 6, heads: int = 8,
                 mlp_dim: int = 2048, num_classes: int = 7,
                 dropout: float = 0.1, *,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.input_proj = nn.Linear(latent_dim, embed_dim)
        reset_linear_(self.input_proj, generator)
        self.cls_token = nn.Parameter(
            torch.randn(1, 1, embed_dim, generator=generator))
        self.pos_emb = nn.Parameter(
            torch.randn(1, seq_len + 1, embed_dim, generator=generator))
        self.transformer = TransformerEncoder(
            depth, embed_dim, heads, mlp_dim, dropout, "relu", False,
            generator)
        self.mlp_head = nn.Sequential(nn.LayerNorm(embed_dim, eps=1e-5),
                                      nn.Linear(embed_dim, num_classes))
        reset_linear_(self.mlp_head[1], generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, seq_len, latent_dim) -> logits (B, num_classes) f32."""
        dt = compute_dtype(x.device, self.dtype)
        x = linear(x.to(dt), self.input_proj)
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_emb.to(dt)
        x = self.transformer(x)
        cls_out = layer_norm(x[:, 0], self.mlp_head[0])
        return linear(cls_out, self.mlp_head[1]).float()
