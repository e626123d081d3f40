"""Latent-space augmentation on the device.

Port of ``fer_vit_tpu/data/latent_augment.py``: the reference
``LatentAugment``'s three transforms (reference: data/latent_dataset.py:6-49)
applied inside the training step to a whole (B, L, D) batch: additive
Gaussian noise, a global scale U(min, max) per sample, and an element-wise
keep mask with keep probability 1 - mask_prob and no rescaling. The draws
come from the ``torch.Generator`` passed in (on the latents' device);
:func:`apply_latent_augment` is the arithmetic given the draws.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class LatentAugmentConfig:
    noise_std: float = 0.0
    scale_min: float = 1.0
    scale_max: float = 1.0
    mask_prob: float = 0.0

    @property
    def enabled(self) -> bool:
        return (
            self.noise_std > 0
            or self.mask_prob > 0
            or self.scales
        )

    @property
    def scales(self) -> bool:
        return (self.scale_min, self.scale_max) != (1.0, 1.0)


def get_latent_train_transforms(
    noise_std: float = 0.1,
    scale_range=(0.9, 1.1),
    mask_prob: float = 0.1,
) -> LatentAugmentConfig:
    """Mirror of the reference factory (data/latent_dataset.py:139-152)."""
    return LatentAugmentConfig(
        noise_std=noise_std,
        scale_min=scale_range[0],
        scale_max=scale_range[1],
        mask_prob=mask_prob,
    )


def apply_latent_augment(latents: torch.Tensor, config: LatentAugmentConfig,
                         noise: Optional[torch.Tensor],
                         scale: Optional[torch.Tensor],
                         keep_u: Optional[torch.Tensor]) -> torch.Tensor:
    """The transforms given their draws: ``noise`` N(0, 1) of the latents'
    shape, ``scale`` (B, 1, 1) in [min, max), ``keep_u`` U(0, 1) of the
    latents' shape (an element is kept where it exceeds mask_prob). A draw
    whose transform is off is not read."""
    out = latents
    if config.noise_std > 0:
        out = out + config.noise_std * noise
    if config.scales:
        out = out * scale
    if config.mask_prob > 0:
        out = out * (keep_u > config.mask_prob).to(out.dtype)
    return out


def latent_augment(generator: torch.Generator, latents: torch.Tensor,
                   config: LatentAugmentConfig) -> torch.Tensor:
    """Augment a (B, L, D) batch: each sample gets independent noise, its
    own global scale (the reference draws one scalar per sample) and an
    element-wise keep mask."""
    if not config.enabled:
        return latents
    kw = dict(generator=generator, device=latents.device, dtype=latents.dtype)
    noise = scale = keep_u = None
    if config.noise_std > 0:
        noise = torch.randn(latents.shape, **kw)
    if config.scales:
        u = torch.rand((latents.shape[0], 1, 1), **kw)
        scale = config.scale_min + u * (config.scale_max - config.scale_min)
    if config.mask_prob > 0:
        keep_u = torch.rand(latents.shape, **kw)
    return apply_latent_augment(latents, config, noise, scale, keep_u)
