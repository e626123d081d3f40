"""Batch inference: images -> (labels, probs), latent route.

Port of ``fer_vit_tpu/serve.py``'s ``Predictor`` for latent classifiers:
preprocess -> pSp encode -> classify -> softmax and argmax, at one fixed batch
size. Requests of any length are cut into chunks padded to ``batch_size``,
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
from fer_vit_tpu_torch.encoders.psp import preprocess_images


class Predictor:
    """End-to-end FER inference for a latent classifier.

    ``model`` is a classifier over w+ codes with its weights loaded (e.g.
    :class:`fer_vit_tpu_torch.models.LatentViT`); ``psp`` an
    :class:`fer_vit_tpu_torch.encoders.psp.EncoderWrapper` on the same
    ``device`` (default CUDA; ``device="cpu"`` for the CPU)."""

    def __init__(self, model: torch.nn.Module, *, psp=None,
                 batch_size: int = 64, input_size: Optional[int] = None,
                 pipeline_depth: int = 2, device: DeviceLike = None):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if psp is None:
            raise ValueError("latent classifiers need a pSp encoder: pass "
                             "psp=EncoderWrapper(...)")
        enc = psp.encoder
        if input_size is not None and int(input_size) != enc.input_size:
            # preprocess always resizes to the encoder's size; a different
            # input_size would mean a silent double resample
            raise ValueError(
                f"latent route: input_size ({input_size}) must equal the pSp "
                f"encoder's input size ({enc.input_size})")
        self.device = resolve_device(device)
        if psp.device != self.device:
            raise ValueError(f"psp is on {psp.device}, the predictor on "
                             f"{self.device}")
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.psp = psp
        self._model_name = type(model).__name__
        self.batch_size = int(batch_size)
        self.pipeline_depth = int(pipeline_depth)
        self.num_classes = int(getattr(model, "num_classes", NUM_CLASSES))
        self.input_size = enc.input_size

    def describe(self) -> dict:
        return {
            "route": "latent",
            "model": self._model_name,
            "batch_size": self.batch_size,
            "input_size": self.input_size,
            "num_classes": self.num_classes,
            "device": str(self.device),
        }

    def _forward(self, images: torch.Tensor):
        with torch.inference_mode():
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
