"""The classifiers: over w+ codes (LatentViT) and over images (ImageViT)."""

from fer_vit_tpu_torch.models.image_vit import (ImageViT, create_vit_base,
                                                create_vit_small,
                                                create_vit_tiny)
from fer_vit_tpu_torch.models.latent_vit import LatentViT

__all__ = ["ImageViT", "LatentViT", "create_vit_base", "create_vit_small",
           "create_vit_tiny"]
