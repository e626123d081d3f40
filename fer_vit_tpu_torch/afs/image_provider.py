"""Reference-image providers for AFS training.

Port of ``fer_vit_tpu/afs/image_provider.py``:

* :class:`GeneratedImageProvider` (strategy A): decode the w+ latents with
  the frozen StyleGAN2 generator and pool them to 256 px, on the device;
* :class:`DiskImageProvider` (strategy B): load the original images from
  the paths stored with each latent, optionally under another root, with
  PIL on the host.

Both return (B, 256, 256, 3) NHWC tensors in [-1, 1].
"""

from __future__ import annotations

import abc
import os
from typing import List, Optional

import numpy as np
import torch

from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device
from fer_vit_tpu_torch.encoders.stylegan2 import Generator, face_pool


class ImageProvider(abc.ABC):
    @abc.abstractmethod
    def get_images(self, w_batch: torch.Tensor,
                   img_paths: Optional[List[str]]) -> torch.Tensor:
        ...


class GeneratedImageProvider(ImageProvider):
    """The generator (frozen, in its compute dtype) and ``face_pool``; the
    images come back in f32, with no autograd graph."""

    def __init__(self, generator: Generator, out_size: int = 256):
        self.generator = generator
        self.out_size = out_size

    @torch.no_grad()
    def get_images(self, w_batch, img_paths=None):
        img, _ = self.generator([w_batch], input_is_latent=True,
                                randomize_noise=False)
        return face_pool(img, self.out_size).float()


class DiskImageProvider(ImageProvider):
    """PIL ``convert("RGB").resize((size, size), BILINEAR)``, then (x / 255
    - 0.5) / 0.5 in numpy f32 (the JAX package's arithmetic, so the arrays
    are equal bit for bit), uploaded to ``device`` (CUDA unless the CPU is
    named). An unreadable path raises, as the reference's ``Image.open``
    does."""

    def __init__(self, img_root: Optional[str] = None, size: int = 256,
                 device: DeviceLike = None):
        self.img_root = img_root
        self.size = size
        self.device = resolve_device(device)

    def _remap(self, path: str) -> str:
        if self.img_root is None:
            return os.path.abspath(path)
        # rebuild from the last two components, img_root/class_dir/filename,
        # so class-directory datasets resolve and same-named files in two
        # classes cannot collide (reference afs/image_provider.py:108-113)
        parts = os.path.normpath(path).split(os.sep)
        return os.path.join(self.img_root, *parts[-2:])

    def load(self, img_paths: List[str]) -> np.ndarray:
        """(B, size, size, 3) f32 in [-1, 1], on the host."""
        from PIL import Image

        imgs = np.zeros((len(img_paths), self.size, self.size, 3),
                        np.float32)
        for i, p in enumerate(img_paths):
            with Image.open(self._remap(p)) as im:
                im = im.convert("RGB").resize((self.size, self.size),
                                              Image.BILINEAR)
                imgs[i] = np.asarray(im, np.float32)
        return (imgs / 255.0 - 0.5) / 0.5

    def get_images(self, w_batch, img_paths):
        if img_paths is None:
            raise ValueError("DiskImageProvider needs img_paths "
                             "(latents must carry 'img_path')")
        return torch.from_numpy(self.load(img_paths)).to(self.device)
