"""timm-architecture ViT for images (vit_{tiny,small,base}_patch16_224).

Port of ``fer_vit_tpu/models/timm_vit.py``, the model the image trainer's
``--use_pretrained`` builds: NHWC images -> patch embedding (a stride =
kernel = 16 conv, as one product) -> prepend CLS -> + positions -> depth x
pre-norm :class:`~fer_vit_tpu_torch.models.hybrid_latent_vit.TimmBlock` ->
LayerNorm (eps 1e-6) -> head on the CLS token -> f32 logits. No dropout.
Parameters carry timm's names (``patch_embed.proj``, ``cls_token``,
``pos_embed``, ``blocks.{i}``, ``norm``, ``head``).

ImageNet weights come from a converted ``.npz`` in the JAX package's layout
(``fer_vit_tpu/encoders/convert_timm.py`` writes it): :func:`create_timm_vit`
with ``pretrained_npz`` returns a patch that copies every entry but the
classifier ``head`` into the model.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from fer_vit_tpu_torch.core.dtypes import compute_dtype
from fer_vit_tpu_torch.models.hybrid_latent_vit import (TIMM_VIT_CONFIGS,
                                                        TimmBlock)
from fer_vit_tpu_torch.models.image_vit import PatchEmbedding
from fer_vit_tpu_torch.nn.initializers import trunc_normal_, vit_linear_init_
from fer_vit_tpu_torch.nn.transformer import layer_norm, linear


class TimmViT(nn.Module):
    """``dtype`` is the compute dtype (None: bf16 on CUDA, f32 elsewhere);
    parameters are f32. ``generator`` draws the initial weights: all
    trunc_normal(0.02) with zero biases, as the JAX module's init."""

    def __init__(self, img_size: int = 224, patch_size: int = 16,
                 embed_dim: int = 384, depth: int = 12, num_heads: int = 6,
                 mlp_dim: int = 1536, num_classes: int = 7, *,
                 dtype: Optional[torch.dtype] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.img_size = img_size
        self.num_classes = num_classes
        self.dtype = dtype
        self.n_patches = (img_size // patch_size) ** 2
        self.patch_embed = PatchEmbedding(patch_size, 3, embed_dim, generator)
        trunc_normal_(self.patch_embed.proj.weight, 0.02, generator)
        with torch.no_grad():
            self.patch_embed.proj.bias.zero_()
        self.cls_token = nn.Parameter(torch.empty(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.empty(1, self.n_patches + 1, embed_dim))
        trunc_normal_(self.cls_token, 0.02, generator)
        trunc_normal_(self.pos_embed, 0.02, generator)
        self.blocks = nn.ModuleList(
            TimmBlock(embed_dim, num_heads, mlp_dim, generator)
            for _ in range(depth))
        self.norm = nn.LayerNorm(embed_dim, eps=1e-6)
        self.head = nn.Linear(embed_dim, num_classes)
        vit_linear_init_(self.head, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) NHWC images -> logits (B, num_classes) f32."""
        dt = compute_dtype(x.device, self.dtype)
        x = self.patch_embed(x.to(dt))
        cls = self.cls_token.to(dt).expand(x.shape[0], -1, -1)
        x = torch.cat([cls, x], dim=1) + self.pos_embed.to(dt)
        for block in self.blocks:
            x = block(x)
        return linear(layer_norm(x, self.norm)[:, 0], self.head).float()


def create_timm_vit(model_size: str = "small", num_classes: int = 7,
                    img_size: int = 224,
                    pretrained_npz: Optional[str] = None, **kw
                    ) -> Tuple[TimmViT, Optional[Callable[[TimmViT], TimmViT]]]:
    """(model, patch): ``patch`` is None without ``pretrained_npz``, else a
    function that copies the file's weights into a model in place (all but
    ``head``, which stays fresh for the 7 classes) and returns it.
    ``kw``: ``dtype`` and ``generator`` of :class:`TimmViT`."""
    cfg = TIMM_VIT_CONFIGS[model_size]
    model = TimmViT(img_size=img_size, num_classes=num_classes,
                    embed_dim=cfg["embed_dim"], depth=cfg["depth"],
                    num_heads=cfg["num_heads"], mlp_dim=cfg["mlp_dim"], **kw)
    if pretrained_npz is None:
        return model, None

    from fer_vit_tpu_torch.interop.from_jax import (
        load_npz_variables, timm_vit_state_dict_from_jax)

    pretrained = load_npz_variables(pretrained_npz)["params"]

    def patch(m: TimmViT) -> TimmViT:
        sd = timm_vit_state_dict_from_jax(
            {k: v for k, v in pretrained.items() if k != "head"})
        # as the JAX patch: entries the model lacks (blocks past its depth)
        # are skipped, the ones it has must fit their shapes
        own = m.state_dict()
        m.load_state_dict({k: v for k, v in sd.items() if k in own},
                          strict=False)
        return m

    return model, patch
