"""The classifiers: over w+ codes (LatentViT, LatentViTv2, the latent CNNs,
HybridLatentViT, ExpressionAwareViT) and over images (ImageViT, and TimmViT
for the image trainer's ``--use_pretrained`` and the legacy ``vit_fer``
trainer)."""

from fer_vit_tpu_torch.models.expression_aware_vit import ExpressionAwareViT
from fer_vit_tpu_torch.models.hybrid_latent_vit import (
    HybridLatentViT, create_hybrid_latent_vit)
from fer_vit_tpu_torch.models.image_vit import (ImageViT, create_vit_base,
                                                create_vit_small,
                                                create_vit_tiny)
from fer_vit_tpu_torch.models.latent_cnn import (LatentCNN, LatentCNN2D,
                                                 LatentCNNDeep,
                                                 LatentCNNLight,
                                                 create_latent_cnn)
from fer_vit_tpu_torch.models.latent_decomposer import LatentDecomposer
from fer_vit_tpu_torch.models.latent_vit import LatentViT
from fer_vit_tpu_torch.models.latent_vit_v2 import LatentViTv2
from fer_vit_tpu_torch.models.timm_vit import TimmViT, create_timm_vit

__all__ = ["ExpressionAwareViT", "HybridLatentViT", "ImageViT", "LatentCNN",
           "LatentCNN2D", "LatentCNNDeep", "LatentCNNLight",
           "LatentDecomposer", "LatentViT", "LatentViTv2", "TimmViT",
           "create_hybrid_latent_vit", "create_latent_cnn",
           "create_timm_vit", "create_vit_base", "create_vit_small",
           "create_vit_tiny"]
