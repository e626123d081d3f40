"""Eval-time image normalisation for the image route.

Port of the eval transform of ``fer_vit_tpu/data/image_pipeline.py``
(reference ``get_val_transforms``): resize (``jax.image.resize`` linear,
antialiased when shrinking) and ImageNet mean/std, on NHWC batches. The
training augmentation (``image_augment``) belongs to ImageViT training and is
not ported yet.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from fer_vit_tpu_torch.encoders.psp import resize_images

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def normalize_images(images: torch.Tensor, out_size: Optional[int] = None,
                     dtype: torch.dtype = torch.float32,
                     already_01: bool = False) -> torch.Tensor:
    """(B, H, W, 3) images -> resized to ``out_size`` (if given) and
    ImageNet-normalised, in ``dtype``. Unless ``already_01``, uint8 inputs
    are divided by 255 and other inputs are taken as [0, 1]."""
    x = images.float()
    if not already_01 and images.dtype == torch.uint8:
        x = x / 255.0
    if out_size is not None:
        x = resize_images(x, out_size)
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    std = torch.from_numpy(IMAGENET_STD).to(x.device)
    return ((x - mean) / std).to(dtype)
