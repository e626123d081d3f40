"""timm's ViT trunk: its sizes and its pre-norm block.

The part of ``fer_vit_tpu/models/hybrid_latent_vit.py`` that
:class:`fer_vit_tpu_torch.models.timm_vit.TimmViT` needs:
``TIMM_VIT_CONFIGS`` (vit_{tiny,small,base}_patch16_224), ``TimmAttention``
(packed qkv Linear, plain softmax attention, output projection) and
``TimmBlock`` (x = x + attn(norm1(x)); x = x + mlp(norm2(x)), LayerNorm eps
1e-6, exact GELU). Parameters carry timm's names (``norm1``, ``attn.qkv``,
``attn.proj``, ``norm2``, ``mlp.fc1``, ``mlp.fc2``), so timm's state dicts
load as they are. The HybridLatentViT model itself is not ported yet.

As in the JAX module, attention is the plain ``dot_product_attention`` at
every sequence length: the JAX ``TimmAttention`` never calls the fused
kernel. Matmuls and bias adds run in the input's dtype, LayerNorm in f32
(``fer_vit_tpu_torch/nn/transformer.py``'s helpers).

Init (the JAX module's): trunc_normal(0.02) for every Linear weight, zero
biases, LayerNorms at identity.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from fer_vit_tpu_torch.nn.initializers import vit_linear_init_
from fer_vit_tpu_torch.nn.transformer import layer_norm, linear
from fer_vit_tpu_torch.ops.attention import dot_product_attention

# timm vit_{tiny,small,base}_patch16_224 trunk dims.
TIMM_VIT_CONFIGS: Dict[str, Dict[str, int]] = {
    "tiny": dict(embed_dim=192, depth=12, num_heads=3, mlp_dim=768),
    "small": dict(embed_dim=384, depth=12, num_heads=6, mlp_dim=1536),
    "base": dict(embed_dim=768, depth=12, num_heads=12, mlp_dim=3072),
}


class TimmAttention(nn.Module):
    """timm ViT attention: packed qkv Linear, then the output projection."""

    def __init__(self, embed_dim: int, num_heads: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(embed_dim, 3 * embed_dim)
        self.proj = nn.Linear(embed_dim, embed_dim)
        vit_linear_init_(self.qkv, generator)
        vit_linear_init_(self.proj, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, length, d = x.shape
        q, k, v = (t.reshape(b, length, self.num_heads, -1).transpose(1, 2)
                   for t in linear(x, self.qkv).chunk(3, dim=-1))
        out = dot_product_attention(q, k, v)
        return linear(out.transpose(1, 2).reshape(b, length, d), self.proj)


class Mlp(nn.Module):
    """fc1 -> exact GELU -> fc2 (timm's ``Mlp``)."""

    def __init__(self, embed_dim: int, mlp_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fc1 = nn.Linear(embed_dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, embed_dim)
        vit_linear_init_(self.fc1, generator)
        vit_linear_init_(self.fc2, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return linear(F.gelu(linear(x, self.fc1)), self.fc2)


class TimmBlock(nn.Module):
    """Pre-norm transformer block matching timm ``Block``."""

    def __init__(self, embed_dim: int, num_heads: int, mlp_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.attn = TimmAttention(embed_dim, num_heads, generator)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.mlp = Mlp(embed_dim, mlp_dim, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(layer_norm(x, self.norm1))
        return x + self.mlp(layer_norm(x, self.norm2))
