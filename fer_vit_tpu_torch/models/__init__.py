"""The classifiers over w+ codes."""

from fer_vit_tpu_torch.models.latent_vit import LatentViT

__all__ = ["LatentViT"]
