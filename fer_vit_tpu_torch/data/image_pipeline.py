"""Image data pipeline: a uint8 image store, the train-time augmentation and
the eval-time normalisation, on NHWC batches on the device.

Port of ``fer_vit_tpu/data/image_pipeline.py`` (reference
data/image_dataset.py: class-dir FER2013 images, ImageNet normalisation;
train augmentations at :139-161: horizontal flip, +-15 degree rotation,
colour jitter 0.2/0.2/0.2/0.1, affine translate +-0.1 and scale 0.9-1.1; a
corrupt file becomes a black image, :125-130), with the JAX package's
constants and order of operations:

* :func:`collect_inputs` lists the image files under given paths, the
  command lines' ``--input``.
* :class:`ImageStore` decodes a class-dir tree once into one uint8 array;
  the trainer keeps it on the device for the whole run.
* Rotation, translation and scale make one inverse-mapped affine warp with
  bilinear sampling and zero fill (one gather, not two interpolations).
* Colour jitter runs in RGB with the grayscale and YIQ identities, in the
  fixed order brightness -> contrast -> saturation -> hue.
* The output is ImageNet-normalised (mean/std), f32 unless asked otherwise.

The augmentation is split in two so that a test can feed it another
framework's random numbers: :func:`draw_augment` draws a batch's flips,
angles, shifts, scales and jitter factors from an explicit
``torch.Generator``, and :func:`apply_augment` applies given draws.
:func:`image_augment` is the two in turn.
"""

from __future__ import annotations

import dataclasses
import math
import os
from collections import Counter
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from fer_vit_tpu_torch import EMOTION_TO_INDEX
from fer_vit_tpu_torch.encoders.psp import resize_images

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)
IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".webp")


def collect_inputs(inputs: Sequence[str]) -> List[str]:
    """Files and/or directories (recursive) -> ordered unique image paths:
    the predict CLI's and ``image_packs``' ``--input``."""
    out: List[str] = []
    for item in inputs:
        if os.path.isdir(item):
            for root, dirs, files in os.walk(item):
                dirs.sort()  # deterministic traversal across filesystems
                out += [os.path.join(root, name) for name in sorted(files)
                        if name.lower().endswith(IMAGE_EXTS)]
        elif os.path.isfile(item):
            out.append(item)
        else:
            raise FileNotFoundError(f"--input entry not found: {item}")
    return list(dict.fromkeys(out))


@dataclasses.dataclass
class ImageStore:
    """uint8 (N, H, W, 3) images and int32 labels."""

    images: np.ndarray
    labels: np.ndarray

    def __len__(self) -> int:
        return self.images.shape[0]

    def get_class_counts(self) -> Dict[int, int]:
        return dict(sorted(Counter(self.labels.tolist()).items()))

    def class_weights(self, num_classes: int = 7) -> np.ndarray:
        counts = Counter(self.labels.tolist())
        total = len(self)
        return np.asarray(
            [total / (num_classes * counts[i]) if counts.get(i) else 1.0
             for i in range(num_classes)], np.float32)

    def balanced_subset_indices(self, fraction: float,
                                seed: int = 42) -> np.ndarray:
        if fraction >= 1.0:
            return np.arange(len(self))
        selected: List[int] = []
        for class_id in sorted(set(self.labels.tolist())):
            indices = np.nonzero(self.labels == class_id)[0]
            n_select = max(1, int(len(indices) * fraction))
            rng = np.random.RandomState(seed)
            selected.extend(rng.choice(indices, n_select, replace=False))
        return np.asarray(sorted(selected), dtype=np.int64)

    def subset(self, indices: np.ndarray) -> "ImageStore":
        return ImageStore(self.images[indices], self.labels[indices])

    @classmethod
    def load(cls, data_root: str, img_size: int = 224,
             use_native: Optional[bool] = None) -> "ImageStore":
        """Decode a class-dir image tree once into a uint8 array, with the
        native decoder (:mod:`fer_vit_tpu_torch.data.native_decode`) where
        it builds and ``use_native`` is not False, else per-file PIL."""
        paths: List[Tuple[str, int]] = []
        for cls_name, label in sorted(EMOTION_TO_INDEX.items(),
                                      key=lambda kv: kv[1]):
            cls_dir = os.path.join(data_root, cls_name)
            if not os.path.isdir(cls_dir):
                continue
            for fname in sorted(os.listdir(cls_dir)):
                if fname.lower().endswith(IMAGE_EXTS):
                    paths.append((os.path.join(cls_dir, fname), label))
        if not paths:
            raise ValueError(f"No images found in {data_root}")

        labels = np.asarray([label for _, label in paths], np.int32)

        from fer_vit_tpu_torch.data import native_decode

        if use_native is None:
            use_native = native_decode.available()
        if use_native:
            images = native_decode.decode_batch(
                [p for p, _ in paths], img_size)
        else:
            from PIL import Image

            images = np.zeros((len(paths), img_size, img_size, 3), np.uint8)
            for i, (p, _) in enumerate(paths):
                try:
                    with Image.open(p) as im:
                        im = im.convert("RGB").resize(
                            (img_size, img_size), Image.BILINEAR)
                        images[i] = np.asarray(im, np.uint8)
                except Exception:
                    pass  # black-image fallback (reference :125-130)
        print(f"Loaded {len(paths)} images from {data_root}"
              f" ({'native' if use_native else 'PIL'} decode)")
        return cls(images, labels)


@dataclasses.dataclass(frozen=True)
class ImageAugmentConfig:
    """Reference train transforms (data/image_dataset.py:139-161)."""

    horizontal_flip: float = 0.5
    rotation_degrees: float = 15.0
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    hue: float = 0.1
    translate: float = 0.1
    scale_min: float = 0.9
    scale_max: float = 1.1


def _affine_warp(images: torch.Tensor, angle: torch.Tensor,
                 tx: torch.Tensor, ty: torch.Tensor,
                 scale: torch.Tensor) -> torch.Tensor:
    """Per-sample inverse-mapped affine warp with bilinear sampling and zero
    fill. images (B, H, W, C) f32; angle in radians; tx/ty in pixels; one
    scale per sample. A neighbour counts where its unclipped index lies in
    the image."""
    b, h, w, c = images.shape
    dev = images.device
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    yy = torch.arange(h, dtype=torch.float32, device=dev)[None, :, None] - cy
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, None, :] - cx

    cos = torch.cos(angle)[:, None, None]
    sin = torch.sin(angle)[:, None, None]
    inv_s = 1.0 / scale[:, None, None]
    dx = xx - tx[:, None, None]
    dy = yy - ty[:, None, None]
    # inverse transform: rotate by -angle, scale by 1/s, shift by -t
    src_x = (cos * dx + sin * dy) * inv_s + cx
    src_y = (-sin * dx + cos * dy) * inv_s + cy

    x0 = torch.floor(src_x)
    y0 = torch.floor(src_y)
    wx = (src_x - x0)[..., None]
    wy = (src_y - y0)[..., None]
    batch_idx = torch.arange(b, device=dev)[:, None, None]

    def gather(yi, xi):
        yi_c = yi.long().clamp(0, h - 1)
        xi_c = xi.long().clamp(0, w - 1)
        vals = images[batch_idx, yi_c, xi_c]  # (B, H, W, C)
        valid = (yi >= 0) & (yi <= h - 1) & (xi >= 0) & (xi <= w - 1)
        return vals * valid[..., None].to(images.dtype)

    return (gather(y0, x0) * (1 - wy) * (1 - wx)
            + gather(y0, x0 + 1) * (1 - wy) * wx
            + gather(y0 + 1, x0) * wy * (1 - wx)
            + gather(y0 + 1, x0 + 1) * wy * wx)


def _rgb_to_gray(x: torch.Tensor) -> torch.Tensor:
    coef = torch.tensor([0.299, 0.587, 0.114], dtype=x.dtype,
                        device=x.device)
    return torch.sum(x * coef, dim=-1, keepdim=True)


def _adjust_hue(x: torch.Tensor, factor: torch.Tensor) -> torch.Tensor:
    """Hue rotation via the YIQ identity (factor in turns, +-0.5 max)."""
    theta = (factor * 2.0 * math.pi)[:, None, None, None]
    y = _rgb_to_gray(x)
    i = 0.596 * x[..., 0:1] - 0.274 * x[..., 1:2] - 0.322 * x[..., 2:3]
    q = 0.211 * x[..., 0:1] - 0.523 * x[..., 1:2] + 0.312 * x[..., 2:3]
    cos, sin = torch.cos(theta), torch.sin(theta)
    i2 = i * cos - q * sin
    q2 = i * sin + q * cos
    r = y + 0.956 * i2 + 0.621 * q2
    g = y - 0.272 * i2 - 0.647 * q2
    b = y - 1.106 * i2 + 1.703 * q2
    return torch.clamp(torch.cat([r, g, b], dim=-1), 0.0, 1.0)


def draw_augment(generator: Optional[torch.Generator], b: int, h: int,
                 w: int, config: ImageAugmentConfig,
                 device=None) -> Dict[str, torch.Tensor]:
    """One batch's random draws, each (b,): ``flip`` (bool), ``angle``
    (radians), ``tx`` and ``ty`` (pixels of a (h, w) image), ``scale``, and
    the factors ``brightness``, ``contrast``, ``saturation`` and ``hue``
    (turns), each uniform over the config's range."""
    dev = generator.device if generator is not None else device

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(b, generator=generator,
                                           device=dev)

    deg, t = config.rotation_degrees, config.translate
    return {
        "flip": torch.rand(b, generator=generator, device=dev)
        < config.horizontal_flip,
        "angle": uniform(-deg, deg) * (math.pi / 180.0),
        "tx": uniform(-t, t) * w,
        "ty": uniform(-t, t) * h,
        "scale": uniform(config.scale_min, config.scale_max),
        "brightness": uniform(1 - config.brightness, 1 + config.brightness),
        "contrast": uniform(1 - config.contrast, 1 + config.contrast),
        "saturation": uniform(1 - config.saturation, 1 + config.saturation),
        "hue": uniform(-config.hue, config.hue),
    }


def apply_augment(images: torch.Tensor, draws: Dict[str, torch.Tensor],
                  config: ImageAugmentConfig, out_size: Optional[int] = None,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """uint8 (0-255) or float (0-1) (B, H, W, 3) images and the draws of
    :func:`draw_augment` -> flip, warp, colour jitter, ImageNet
    normalisation, as ``fer_vit_tpu/data/image_pipeline.py::image_augment``.
    A jitter whose strength is 0 in the config is skipped."""
    x = images.float() / (255.0 if images.dtype == torch.uint8 else 1.0)

    def factor(name):
        return draws[name].to(x.device).view(-1, 1, 1, 1)

    flip = draws["flip"].to(x.device).view(-1, 1, 1, 1)
    x = torch.where(flip, x.flip(2), x)
    x = _affine_warp(x, *(draws[k].to(x.device)
                          for k in ("angle", "tx", "ty", "scale")))
    if config.brightness > 0:
        x = torch.clamp(x * factor("brightness"), 0.0, 1.0)
    if config.contrast > 0:
        mean_gray = torch.mean(_rgb_to_gray(x), dim=(1, 2, 3), keepdim=True)
        x = torch.clamp((x - mean_gray) * factor("contrast") + mean_gray,
                        0.0, 1.0)
    if config.saturation > 0:
        gray = _rgb_to_gray(x)
        x = torch.clamp((x - gray) * factor("saturation") + gray, 0.0, 1.0)
    if config.hue > 0:
        x = _adjust_hue(x, draws["hue"].to(x.device))
    return normalize_images(x, out_size=out_size, dtype=dtype,
                            already_01=True)


def image_augment(generator: Optional[torch.Generator],
                  images: torch.Tensor, config: ImageAugmentConfig,
                  out_size: Optional[int] = None,
                  dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The train-time augmentation and normalisation of a batch, with draws
    from ``generator`` (on the images' device)."""
    b, h, w = images.shape[:3]
    draws = draw_augment(generator, b, h, w, config, images.device)
    return apply_augment(images, draws, config, out_size, dtype)


def normalize_images(images: torch.Tensor, out_size: Optional[int] = None,
                     dtype: torch.dtype = torch.float32,
                     already_01: bool = False) -> torch.Tensor:
    """Eval-time transform (reference get_val_transforms): (B, H, W, 3)
    images -> resized to ``out_size`` (if given; ``jax.image.resize``
    linear, antialiased when shrinking) and ImageNet-normalised, in
    ``dtype``. Unless ``already_01``, uint8 inputs are divided by 255 and
    other inputs are taken as [0, 1]."""
    x = images.float()
    if not already_01 and images.dtype == torch.uint8:
        x = x / 255.0
    if out_size is not None:
        x = resize_images(x, out_size)
    mean = torch.from_numpy(IMAGENET_MEAN).to(x.device)
    std = torch.from_numpy(IMAGENET_STD).to(x.device)
    return ((x - mean) / std).to(dtype)


def get_train_transforms(img_size: int = 224) -> ImageAugmentConfig:
    """Mirror of reference get_train_transforms (image_dataset.py:139-161)."""
    del img_size  # size is applied at store/normalize time
    return ImageAugmentConfig()


def get_val_transforms(img_size: int = 224) -> None:
    del img_size
    return None
