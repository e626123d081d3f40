"""Transformer encoder stack with the semantics of
``torch.nn.TransformerEncoderLayer``, written from plain ops.

Port of ``fer_vit_tpu/nn/transformer.py``::

    post-norm:  x = LN1(x + Drop(SelfAttn(x)));  x = LN2(x + Drop(FFN(x)))
    pre-norm:   x = x + Drop(SelfAttn(LN1(x)));  x = x + Drop(FFN(LN2(x)))

Parameters carry torch's names (``self_attn.in_proj_weight``,
``self_attn.out_proj``, ``linear1/2``, ``norm1/2``), but the forward is the
JAX package's: every matmul and bias add runs in the compute dtype (the
dtype of the input), LayerNorm (eps 1e-5) in f32. ``torch.nn``'s own layer
is not used: its eval fast path has numerics of its own.

Attention follows the JAX layer's dispatch rule: without active dropout and
from 128 tokens on it goes through the fused kernel
(:func:`fer_vit_tpu_torch.ops.flash_attention.fused_attention`, which takes
its plain version for CPU tensors), otherwise through the plain
``dot_product_attention``.
"""

from __future__ import annotations

import copy
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from fer_vit_tpu_torch.nn.initializers import (reset_linear_, uniform_,
                                               vit_linear_init_)
from fer_vit_tpu_torch.ops.attention import dot_product_attention
from fer_vit_tpu_torch.ops.flash_attention import fused_attention

# The JAX layer's threshold (fer_vit_tpu/nn/transformer.py): from this
# sequence length on, attention without dropout takes the fused kernel.
FUSED_MIN_LEN = 128


def linear(x: torch.Tensor, m: nn.Linear) -> torch.Tensor:
    """``x @ W^T + b`` in x's dtype (matmul, then the bias add)."""
    dt = x.dtype
    return x @ m.weight.t().to(dt) + m.bias.to(dt)


def layer_norm(x: torch.Tensor, m: nn.LayerNorm) -> torch.Tensor:
    return F.layer_norm(x.float(), m.normalized_shape, m.weight.float(),
                        m.bias.float(), m.eps).to(x.dtype)


class MultiheadSelfAttention(nn.Module):
    """Packed-qkv self-attention with ``torch.nn.MultiheadAttention``'s
    parameters: ``in_proj_weight`` (3D, D) rows q, k, v; ``in_proj_bias``;
    ``out_proj``. Init as torch's: xavier-uniform in_proj, zero biases."""

    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout = dropout
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim,
                                                       embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        uniform_(self.in_proj_weight, math.sqrt(6.0 / (4 * embed_dim)),
                 generator)
        reset_linear_(self.out_proj, generator)
        with torch.no_grad():
            self.out_proj.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length, d = x.shape
        dt = x.dtype
        qkv = x @ self.in_proj_weight.t().to(dt) + self.in_proj_bias.to(dt)
        q, k, v = (t.reshape(b, length, self.num_heads, -1).transpose(1, 2)
                   for t in qkv.chunk(3, dim=-1))
        if length >= FUSED_MIN_LEN and not (self.dropout > 0.0
                                            and self.training):
            out = fused_attention(q, k, v)
        else:
            out = dot_product_attention(q, k, v, dropout_p=self.dropout,
                                        training=self.training)
        return linear(out.transpose(1, 2).reshape(b, length, d),
                      self.out_proj)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int,
                 dropout: float = 0.1, activation: str = "relu",
                 norm_first: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if activation not in ("relu", "gelu"):
            raise ValueError(f"unknown activation: {activation!r}")
        self.activation = activation
        self.norm_first = norm_first
        self.self_attn = MultiheadSelfAttention(embed_dim, num_heads,
                                                dropout, generator)
        self.linear1 = nn.Linear(embed_dim, mlp_dim)
        self.linear2 = nn.Linear(mlp_dim, embed_dim)
        reset_linear_(self.linear1, generator)
        reset_linear_(self.linear2, generator)
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-5)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-5)
        self.dropout = nn.Dropout(dropout)

    def _ffn(self, h: torch.Tensor) -> torch.Tensor:
        h = linear(h, self.linear1)
        # exact (erf) GELU, as torch's layer uses
        h = F.relu(h) if self.activation == "relu" else F.gelu(h)
        return linear(self.dropout(h), self.linear2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        drop = self.dropout
        if self.norm_first:
            x = x + drop(self.self_attn(layer_norm(x, self.norm1)))
            return x + drop(self._ffn(layer_norm(x, self.norm2)))
        x = layer_norm(x + drop(self.self_attn(x)), self.norm1)
        return layer_norm(x + drop(self._ffn(x)), self.norm2)


class TransformerEncoder(nn.Module):
    """``depth`` layers. Like ``torch.nn.TransformerEncoder``, the layers are
    deep copies of one, so all start identical. ``vit_linear_init`` then
    re-draws every nn.Linear of every layer (``linear1``, ``linear2``,
    ``self_attn.out_proj``) independently, trunc_normal(0.02) with zero
    biases, as the reference ImageViT's ``_init_weights`` does: only
    ``in_proj_weight`` stays identical across layers."""

    def __init__(self, depth: int, embed_dim: int, num_heads: int,
                 mlp_dim: int, dropout: float = 0.1,
                 activation: str = "relu", norm_first: bool = False,
                 generator: Optional[torch.Generator] = None,
                 vit_linear_init: bool = False):
        super().__init__()
        layer = TransformerEncoderLayer(embed_dim, num_heads, mlp_dim,
                                        dropout, activation, norm_first,
                                        generator)
        self.layers = nn.ModuleList(copy.deepcopy(layer)
                                    for _ in range(depth))
        if vit_linear_init:
            for lay in self.layers:
                for m in (lay.linear1, lay.linear2, lay.self_attn.out_proj):
                    vit_linear_init_(m, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x
