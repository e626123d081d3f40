"""Scaled dot-product attention (plain PyTorch; no kernel).

Port of ``fer_vit_tpu/ops/attention.py``: ``softmax(Q K^T / sqrt(Dh)) V``
over (B, H, L, Dh), with dropout on the attention weights as
``torch.nn.MultiheadAttention`` applies it. The scores and the softmax are
f32 whatever the input dtype (the products of bf16 operands are exact in
f32); the weights are cast back to the input dtype before the product with V,
which accumulates in f32; the result is in the input dtype.

This is the path for short sequences (LatentViT's 19 tokens) and for
attention with dropout; from 128 tokens on, without dropout, the transformer
layer calls the fused kernel of :mod:`fer_vit_tpu_torch.ops.flash_attention`,
whose plain version is this function.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, dropout_p: float = 0.0,
                          training: bool = False) -> torch.Tensor:
    dt = q.dtype
    scale = 1.0 / math.sqrt(q.shape[-1])
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    weights = torch.softmax(scores, dim=-1)
    if dropout_p > 0.0 and training:
        weights = F.dropout(weights, dropout_p, training=True)
    out = torch.matmul(weights.to(dt).float(), v.float())
    return out.to(dt)
