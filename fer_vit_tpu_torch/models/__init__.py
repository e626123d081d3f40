"""The classifiers: over w+ codes (LatentViT) and over images (ImageViT, and
TimmViT for the image trainer's ``--use_pretrained``)."""

from fer_vit_tpu_torch.models.image_vit import (ImageViT, create_vit_base,
                                                create_vit_small,
                                                create_vit_tiny)
from fer_vit_tpu_torch.models.latent_vit import LatentViT
from fer_vit_tpu_torch.models.timm_vit import TimmViT, create_timm_vit

__all__ = ["ImageViT", "LatentViT", "TimmViT", "create_timm_vit",
           "create_vit_base", "create_vit_small", "create_vit_tiny"]
