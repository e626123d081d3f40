"""Batch inference: images -> (labels, probs).

Port of ``fer_vit_tpu/serve.py``'s ``Predictor``, with its two routes: the
latent route (preprocess -> pSp encode -> classify, for classifiers over w+
codes) and the image route (ImageNet normalisation -> ImageViT); both end in
an f32 softmax and argmax, at one fixed batch size. Requests of any length are cut into chunks padded to ``batch_size``,
and up to ``pipeline_depth`` chunks are in flight: CUDA work is queued
without waiting, and fetching an older chunk's results to the host is the
only wait. The answers do not depend on the depth.
"""

from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

from fer_vit_tpu_torch import NUM_CLASSES
from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device
from fer_vit_tpu_torch.data.image_pipeline import normalize_images
from fer_vit_tpu_torch.encoders.psp import preprocess_images, to_unit_floats


class Predictor:
    """End-to-end FER inference.

    ``model`` is a classifier with its weights loaded. Over w+ codes (e.g.
    :class:`fer_vit_tpu_torch.models.LatentViT`) it needs ``psp``, an
    :class:`fer_vit_tpu_torch.encoders.psp.EncoderWrapper` on the same
    ``device``. With ``image_route=True`` the model takes images (e.g.
    :class:`fer_vit_tpu_torch.models.ImageViT`), needs no encoder, and
    ``input_size`` defaults to the model's ``img_size``. ``device`` defaults
    to CUDA; ``device="cpu"`` for the CPU."""

    def __init__(self, model: torch.nn.Module, *, psp=None,
                 batch_size: int = 64, image_route: bool = False,
                 input_size: Optional[int] = None,
                 pipeline_depth: int = 2, device: DeviceLike = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        self.image_route = bool(image_route)
        if self.image_route:
            size = int(input_size or getattr(model, "img_size", 224))
        else:
            if psp is None:
                raise ValueError("latent classifiers need a pSp encoder: "
                                 "pass psp=EncoderWrapper(...)")
            size = psp.encoder.input_size
            if input_size is not None and int(input_size) != size:
                # preprocess always resizes to the encoder's size; a
                # different input_size would mean a silent double resample
                raise ValueError(
                    f"latent route: input_size ({input_size}) must equal "
                    f"the pSp encoder's input size ({size})")
        self.device = resolve_device(device)
        if psp is not None and psp.device != self.device:
            raise ValueError(f"psp is on {psp.device}, the predictor on "
                             f"{self.device}")
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.psp = None if self.image_route else psp
        self._model_name = type(model).__name__
        self.batch_size = int(batch_size)
        self.pipeline_depth = int(pipeline_depth)
        self.num_classes = int(getattr(model, "num_classes", NUM_CLASSES))
        self.input_size = size

    def describe(self) -> dict:
        return {
            "route": "image" if self.image_route else "latent",
            "model": self._model_name,
            "batch_size": self.batch_size,
            "input_size": self.input_size,
            "num_classes": self.num_classes,
            "device": str(self.device),
        }

    def _forward(self, images: torch.Tensor):
        with torch.inference_mode():
            if self.image_route:
                logits = self.model(normalize_images(
                    to_unit_floats(images), out_size=self.input_size,
                    already_01=True))
            else:
                x = preprocess_images(images, size=self.input_size)
                logits = self.model(self.psp.encoder(x))
            probs = torch.softmax(logits.float(), dim=-1)
            return torch.argmax(logits, dim=-1), probs

    def predict(self, images) -> Tuple[np.ndarray, np.ndarray]:
        """(N, S, S, 3) images (uint8 0-255, or float 0-1 / 0-255) ->
        (labels (N,) int32, probs (N, C) f32). N is arbitrary: chunks are
        padded to ``batch_size``."""
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        if images.ndim != 4 or images.shape[-1] != 3:
            raise ValueError(
                f"expected (N, H, W, 3) images, got {images.shape}")

        def chunks():
            for i in range(0, len(images), self.batch_size):
                chunk = images[i:i + self.batch_size]
                k = len(chunk)
                if k < self.batch_size:
                    pad = np.zeros((self.batch_size - k,) + chunk.shape[1:],
                                   chunk.dtype)
                    chunk = np.concatenate([chunk, pad])
                yield chunk, k

        return self._run_pipelined(chunks())

    def _run_pipelined(self, batch_iter) -> Tuple[np.ndarray, np.ndarray]:
        labels_out: List[np.ndarray] = []
        probs_out: List[np.ndarray] = []
        inflight: deque = deque()

        def drain_one() -> None:
            k0, l0, p0, _ = inflight.popleft()
            labels_out.append(l0[:k0].cpu().numpy().astype(np.int32))
            probs_out.append(p0[:k0].cpu().numpy().astype(np.float32))

        for imgs, k in batch_iter:
            host, dev = self._put(imgs)
            labels, probs = self._forward(dev)
            # the pinned host buffer stays referenced until its copy is done
            inflight.append((k, labels, probs, host))
            if len(inflight) > self.pipeline_depth:
                drain_one()
        while inflight:
            drain_one()
        if not labels_out:
            return (np.zeros((0,), np.int32),
                    np.zeros((0, self.num_classes), np.float32))
        return np.concatenate(labels_out), np.concatenate(probs_out)

    def _put(self, chunk: np.ndarray):
        host = torch.from_numpy(np.ascontiguousarray(chunk))
        if self.device.type != "cuda":
            return host, host.to(self.device)
        host = host.pin_memory()
        return host, host.to(self.device, non_blocking=True)

    def warmup(self) -> None:
        """Build the kernels and warm the libraries before serving."""
        self.predict(np.zeros((1, self.input_size, self.input_size, 3),
                              np.uint8))
