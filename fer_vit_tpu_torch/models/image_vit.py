"""ImageViT — the standard ViT over face images.

Port of ``fer_vit_tpu/models/image_vit.py`` (reference ImageViT): NHWC
(B, H, W, C) images -> patch embedding (a stride = kernel = patch conv) ->
prepend CLS -> + learned positions -> dropout -> depth x post-norm
transformer (exact GELU FFN) -> LayerNorm + Linear on the CLS token -> f32
logits. Parameter names follow the reference (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``transformer.layers.{i}``, ``norm``, ``head``).

At 224 px and patch 16 the sequence is 197 tokens, so every attention goes
through the fused kernel (``fer_vit_tpu_torch/ops/flash_attention.py``). The
patch embedding and the dense layers are plain large products, as the JAX
package leaves them to XLA.

Init (the reference's ``_init_weights``): trunc_normal(0.02) for
``cls_token``, ``pos_embed``, the head and every nn.Linear of the layers
(zero biases); the patch conv keeps torch's conv default; ``in_proj_weight``
keeps torch's xavier-uniform, identical across layers.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from fer_vit_tpu_torch.core.dtypes import compute_dtype
from fer_vit_tpu_torch.nn.initializers import (torch_conv_kernel_init_,
                                               torch_linear_bias_init_,
                                               trunc_normal_,
                                               vit_linear_init_)
from fer_vit_tpu_torch.nn.transformer import (TransformerEncoder, layer_norm,
                                              linear)


class PatchEmbedding(nn.Module):
    """(B, H, W, C) -> (B, N, embed_dim) patch tokens, in x's dtype."""

    def __init__(self, patch_size: int = 16, in_channels: int = 3,
                 embed_dim: int = 768,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size,
                              stride=patch_size)
        torch_conv_kernel_init_(self.proj.weight, generator)
        torch_linear_bias_init_(self.proj.bias,
                                in_channels * patch_size * patch_size,
                                generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """The conv as one product: each patch's (p, p, C) pixels against
        the kernel in (kh, kw, C) order, then the bias add. Pixels past the
        last whole patch are dropped (a VALID conv)."""
        p = self.patch_size
        b, h, w, c = x.shape
        h, w = h // p * p, w // p * p
        dt = x.dtype
        patches = (x[:, :h, :w].reshape(b, h // p, p, w // p, p, c)
                   .permute(0, 1, 3, 2, 4, 5)
                   .reshape(b, (h // p) * (w // p), p * p * c))
        kernel = self.proj.weight.permute(0, 2, 3, 1).reshape(
            self.proj.out_channels, -1)
        return patches @ kernel.t().to(dt) + self.proj.bias.to(dt)


class ImageViT(nn.Module):
    """``dtype`` is the compute dtype (None: bf16 on CUDA, f32 elsewhere);
    parameters are f32. ``generator`` draws the initial weights."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 in_channels: int = 3, embed_dim: int = 768, depth: int = 12,
                 heads: int = 12, mlp_dim: int = 3072, num_classes: int = 7,
                 dropout: float = 0.1, *,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.img_size = img_size
        self.num_classes = num_classes
        self.dtype = dtype
        self.n_patches = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbedding(patch_size, in_channels,
                                          embed_dim, generator)
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.empty(1, self.n_patches + 1, embed_dim))
        trunc_normal_(self.cls_token, 0.02, generator)
        trunc_normal_(self.pos_embed, 0.02, generator)
        self.pos_drop = nn.Dropout(dropout)
        self.transformer = TransformerEncoder(
            depth, embed_dim, heads, mlp_dim, dropout, "gelu", False,
            generator, vit_linear_init=True)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.head = nn.Linear(embed_dim, num_classes)
        vit_linear_init_(self.head, generator)

    def tokens(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images -> (B, N + 1, D) tokens in the compute dtype:
        patch embedding, CLS, positions, dropout."""
        dt = compute_dtype(x.device, self.dtype)
        x = self.patch_embed(x.to(dt))
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        return self.pos_drop(torch.cat([cls, x], dim=1)
                             + self.pos_embed.to(dt))

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, C) images -> the normalised CLS features (B, D)."""
        return layer_norm(self.transformer(self.tokens(x))[:, 0], self.norm)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, C) NHWC images -> logits (B, num_classes) f32."""
        return linear(self.features(x), self.head).float()


# the image trainer's ``--model_size`` presets (ViT/16 widths)
PRESETS = {
    "tiny": dict(embed_dim=192, depth=12, heads=3, mlp_dim=768),
    "small": dict(embed_dim=384, depth=12, heads=6, mlp_dim=1536),
    "base": dict(embed_dim=768, depth=12, heads=12, mlp_dim=3072),
}


def create_vit_tiny(num_classes: int = 7, img_size: int = 224,
                    **kw) -> ImageViT:
    """ViT-Tiny/16 (~5M parameters)."""
    return ImageViT(img_size=img_size, patch_size=16,
                    num_classes=num_classes, **PRESETS["tiny"], **kw)


def create_vit_small(num_classes: int = 7, img_size: int = 224,
                     **kw) -> ImageViT:
    """ViT-Small/16 (~22M parameters)."""
    return ImageViT(img_size=img_size, patch_size=16,
                    num_classes=num_classes, **PRESETS["small"], **kw)


def create_vit_base(num_classes: int = 7, img_size: int = 224,
                    **kw) -> ImageViT:
    """ViT-Base/16 (~86M parameters)."""
    return ImageViT(img_size=img_size, patch_size=16,
                    num_classes=num_classes, **PRESETS["base"], **kw)
