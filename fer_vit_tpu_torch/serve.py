"""Batch inference, the predict CLI and the HTTP server.

Port of ``fer_vit_tpu/serve.py``. :class:`Predictor` runs one function of
``(B, S, S, 3) images`` at one fixed batch size, on one of three routes:
the latent route (preprocess -> pSp encode -> classify, for classifiers
over w+ codes) and the image route (ImageNet normalisation -> ImageViT or
TimmViT), both ``-> (labels, probs)`` (:class:`PredictFn`, an f32 softmax
and argmax); and the reconstruction route, the whole pSp model (pSp encode
-> StyleGAN2 decode -> face pool -> uint8), ``-> (B, 256, 256, 3)`` uint8
images (:class:`ReconstructFn`). Requests of any length are cut into
chunks padded to ``batch_size``, and up to ``pipeline_depth`` chunks are in
flight: CUDA work is queued without waiting, and fetching an older chunk's
answers to the host, straight into the call's answer arrays, is the only
wait. The answers do not depend on the depth.

* :meth:`Predictor.from_checkpoint` loads a trained checkpoint (the port's
  own, a JAX trainer's msgpack file or a reference-format torch file) and
  routes it by its config; :meth:`Predictor.from_exported` loads an AOT
  artifact (:mod:`fer_vit_tpu_torch.export`) and runs it without the model
  code.
* ``mesh=`` (:func:`fer_vit_tpu_torch.core.mesh.make_mesh`) keeps a replica
  of the classifier (and the encoder) on each device of the mesh's data
  axis; each padded chunk is split into equal shards, every shard is
  launched before any result is fetched, and the results are gathered in
  order.
* :meth:`Predictor.predict_files` decodes image files on a background
  thread and :meth:`Predictor.predict_packed` reads pre-decoded packs
  (:mod:`fer_vit_tpu_torch.data.image_packs`).
* :class:`Batcher` coalesces concurrent single-image requests into device
  batches, and :func:`make_server` serves them over HTTP (``GET /healthz``,
  ``POST /predict``, ``POST /predict_batch``).

The CLIs, with the JAX CLIs' flags, and the reconstruction CLI, which
writes an image pack (:mod:`fer_vit_tpu_torch.data.image_packs`)::

    python -m fer_vit_tpu_torch.serve --checkpoint_path best_model.pt \\
        --psp_weights psp.npz --input faces/ --output preds.json
    python -m fer_vit_tpu_torch.serve serve --exported artifact/ --port 8000
    python -m fer_vit_tpu_torch.cli reconstruct --psp_weights psp_ffhq.pt \\
        --input faces/ --output recon_pack/
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import os
import queue
import threading
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from fer_vit_tpu_torch import EMOTION_NAMES, NUM_CLASSES
from fer_vit_tpu_torch.core.dtypes import (DeviceLike, indexed,
                                           resolve_device, same_device)
from fer_vit_tpu_torch.core.mesh import DATA_AXIS
from fer_vit_tpu_torch.utils.trace import span


def _label_name(label: int) -> str:
    return (EMOTION_NAMES[label] if 0 <= label < len(EMOTION_NAMES)
            else str(label))


def _on(device: torch.device):
    """The CUDA device context for work launched on ``device`` (a batcher
    thread starts on device 0), or nothing for the CPU."""
    return (torch.cuda.device(device) if device.type == "cuda"
            else contextlib.nullcontext())


class PredictFn(nn.Module):
    """``images (B, S, S, 3) -> (labels (B,) int64, probs (B, C) f32)``:
    the function a :class:`Predictor` runs and :mod:`fer_vit_tpu_torch.export`
    traces. With ``encoder`` (a :class:`PSpEncoder`) it is the latent route,
    without it the image route at ``input_size``. Its weights are the
    state dicts of :meth:`weight_args`, which :meth:`functional` takes as
    arguments."""

    def __init__(self, model: nn.Module, encoder: Optional[nn.Module],
                 input_size: int):
        super().__init__()
        self.model = model
        self.encoder = encoder
        self.input_size = int(input_size)

    def forward(self, images: torch.Tensor):
        if self.encoder is None:
            from fer_vit_tpu_torch.data.image_pipeline import normalize_images
            from fer_vit_tpu_torch.encoders.psp import to_unit_floats

            with span("serve.preprocess"):
                x = normalize_images(to_unit_floats(images),
                                     out_size=self.input_size,
                                     already_01=True)
            logits = self.model(x)
        else:
            from fer_vit_tpu_torch.encoders.psp import preprocess_images

            with span("serve.preprocess"):
                x = preprocess_images(images, size=self.input_size)
            logits = self.model(self.encoder(x))
        probs = torch.softmax(logits.float(), dim=-1)
        return torch.argmax(logits, dim=-1), probs

    def answers(self) -> tuple:
        """Each answer's host dtype and trailing shape: labels and probs
        (:func:`_class_answers`)."""
        return _class_answers(getattr(self.model, "num_classes",
                                      NUM_CLASSES))

    def _parts(self):
        return (("model",) if self.encoder is None
                else ("encoder", "model"))

    def weight_args(self) -> tuple:
        """The weights as arguments: one state dict per part, (encoder,
        classifier) on the latent route and (classifier,) on the image
        route, as the JAX predictor's ``_fn_args``."""
        return tuple({k: v.detach() for k, v in
                      getattr(self, part).state_dict().items()}
                     for part in self._parts())

    def functional(self, weights: Sequence[dict], images: torch.Tensor):
        """:meth:`forward` with the parameters and buffers taken from
        ``weights`` (as :meth:`weight_args` gives them)."""
        merged = {f"{part}.{k}": v
                  for part, sd in zip(self._parts(), weights)
                  for k, v in sd.items()}
        return torch.func.functional_call(self, merged, (images,))


def _class_answers(num_classes: int) -> tuple:
    """The classification routes' answers on the host: labels (int32) and
    probs (f32, ``num_classes`` wide)."""
    return (np.int32, ()), (np.float32, (int(num_classes),))


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """pSp's ``tensor2im`` on [-1, 1] images: ``(x + 1) / 2`` clamped to
    [0, 1], times 255, truncated to uint8, in x's dtype up to the cast."""
    return ((images + 1) / 2).clamp_(0, 1).mul_(255).to(torch.uint8)


class ReconstructFn(nn.Module):
    """``images (B, S, S, 3) -> (B, out_size, out_size, 3) uint8``: the whole
    pSp model, as pixel2style2pixel's ``pSp.forward`` with
    ``resize_outputs`` and ``tensor2im`` compute it: ``preprocess_images``;
    the encoder with its ``latent_avg`` (a :class:`PSpEncoder`); the
    ``generator`` (a StyleGAN2 :class:`~fer_vit_tpu_torch.encoders.
    stylegan2.Generator`) on those w+ codes with the stored noise; its
    images average-pooled to ``out_size`` in f32 (``face_pool``); then
    :func:`to_uint8`. Each forward adds its batch to ``decoded_images``
    (:meth:`stats`), the faces the generator decoded, padding included."""

    def __init__(self, encoder: nn.Module, generator: nn.Module,
                 out_size: int = 256):
        super().__init__()
        if encoder.n_styles != generator.n_latent:
            raise ValueError(
                f"the encoder gives {encoder.n_styles} styles, the "
                f"{generator.size} px generator takes {generator.n_latent}")
        if encoder.style_dim != generator.style_dim:
            raise ValueError(
                f"the encoder's styles are {encoder.style_dim}-d, the "
                f"generator's {generator.style_dim}-d")
        self.encoder = encoder
        self.generator = generator
        self.out_size = int(out_size)
        self.decoded_images = 0

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        from fer_vit_tpu_torch.encoders.psp import preprocess_images
        from fer_vit_tpu_torch.encoders.stylegan2 import face_pool

        with span("serve.preprocess"):
            x = preprocess_images(images, size=self.encoder.input_size)
        w = self.encoder(x)
        with span("psp.decode"):
            img, _ = self.generator([w], input_is_latent=True,
                                    randomize_noise=False)
        self.decoded_images += img.shape[0]
        with span("serve.postprocess"):
            return to_uint8(face_pool(img.float(), self.out_size))

    def answers(self) -> tuple:
        """The one answer's host dtype and trailing shape: uint8 faces."""
        return ((np.uint8, (self.out_size, self.out_size, 3)),)

    def stats(self) -> dict:
        return {"decoded_images": self.decoded_images}


def _replica(fn: PredictFn, device: torch.device) -> PredictFn:
    """A copy of ``fn`` on ``device``, without the cached casts
    (:func:`fer_vit_tpu_torch.core.dtypes.cast_once`) of the original."""
    rep = copy.deepcopy(fn)
    for m in rep.modules():
        m.__dict__.pop("_cast_once", None)
    return rep.to(device)


class Predictor:
    """End-to-end FER inference, or pSp reconstruction.

    ``model`` is a classifier with its weights loaded. Over w+ codes (e.g.
    :class:`fer_vit_tpu_torch.models.LatentViT`) it needs ``psp``, an
    :class:`fer_vit_tpu_torch.encoders.psp.EncoderWrapper` on the same
    ``device``. With ``image_route=True`` the model takes images (e.g.
    :class:`fer_vit_tpu_torch.models.ImageViT`), needs no encoder, and
    ``input_size`` defaults to the model's ``img_size``. With ``decoder``
    (a StyleGAN2 ``Generator`` whose ``n_latent`` is the encoder's styles)
    and ``model=None`` it is the reconstruction route: ``psp`` then the
    decoder, answering uint8 faces of ``output_size`` (:class:`ReconstructFn`;
    :meth:`from_psp` loads both halves from one pSp checkpoint).
    ``device`` defaults to CUDA; ``device="cpu"`` for the CPU. With
    ``mesh`` the predictor runs on the mesh's data devices (the first one
    holds ``model`` and ``psp``) and ``batch_size`` must be a multiple of
    their number."""

    def __init__(self, model: Optional[nn.Module], *, psp=None,
                 batch_size: int = 64, image_route: bool = False,
                 input_size: Optional[int] = None, mesh=None,
                 pipeline_depth: int = 2, device: DeviceLike = None,
                 decoder: Optional[nn.Module] = None,
                 output_size: int = 256):
        if batch_size < 1:
            raise ValueError(f"batch_size must be >= 1, got {batch_size}")
        if pipeline_depth < 1:
            raise ValueError(
                f"pipeline_depth must be >= 1, got {pipeline_depth}")
        if (decoder is None) == (model is None):
            raise ValueError("pass a classifier as model, or model=None "
                             "with a decoder (the reconstruction route)")
        if decoder is not None and image_route:
            raise ValueError("the reconstruction route starts from the pSp "
                             "encoder, not the image route")
        self.route = ("image" if image_route else
                      "latent" if decoder is None else "reconstruct")
        if self.image_route:
            size = int(input_size or getattr(model, "img_size", 224))
        else:
            if psp is None:
                raise ValueError(f"the {self.route} route needs a pSp "
                                 f"encoder: pass psp=EncoderWrapper(...)")
            size = psp.encoder.input_size
            if input_size is not None and int(input_size) != size:
                # preprocess always resizes to the encoder's size; a
                # different input_size would mean a silent double resample
                raise ValueError(
                    f"{self.route} route: input_size ({input_size}) must "
                    f"equal the pSp encoder's input size ({size})")
        self.batch_size = int(batch_size)
        self.mesh = mesh
        if mesh is None:
            devices = [resolve_device(device)]
        else:
            devices = mesh.data_devices
            n_data = mesh.shape[DATA_AXIS]
            if self.batch_size % n_data != 0:
                raise ValueError(
                    f"batch_size ({self.batch_size}) must be a multiple of "
                    f"the mesh data axis ({n_data}) for even sharding")
            if device is not None and not same_device(
                    resolve_device(device), devices[0]):
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"data device {devices[0]}")
        self.device = devices[0]
        if psp is not None and not same_device(psp.device, self.device):
            raise ValueError(f"psp is on {psp.device}, the predictor on "
                             f"{self.device}")
        self.psp = None if self.image_route else psp
        self._input_dtypes = None  # set by from_exported: pinned dtypes
        self.pipeline_depth = int(pipeline_depth)
        self.input_size = size
        if decoder is None:
            self.model = model.to(self.device).eval().requires_grad_(False)
            self._model_name = type(model).__name__
            self.num_classes = int(getattr(model, "num_classes",
                                           NUM_CLASSES))
            fn = PredictFn(self.model, None if self.psp is None
                           else self.psp.encoder, size)
        else:
            self.model = None
            self.decoder = decoder.to(self.device).eval().requires_grad_(
                False)
            self._model_name = (f"pSp ({type(decoder).__name__} "
                                f"{decoder.size} px)")
            self.num_classes = None
            self.output_size = int(output_size)
            fn = ReconstructFn(self.psp.encoder, self.decoder,
                               self.output_size)
        self._fn = fn
        self._answers = fn.answers()
        self._replicas = [(self.device, fn)] + [
            (d, _replica(fn, d)) for d in devices[1:]]

    @classmethod
    def from_checkpoint(cls, checkpoint_path: str, *,
                        psp_weights: Optional[str] = None, psp=None,
                        batch_size: int = 64, mesh=None,
                        dtype: Optional[torch.dtype] = None,
                        pipeline_depth: int = 2,
                        device: DeviceLike = None) -> "Predictor":
        """Load a trained checkpoint (the port's own, a JAX trainer's
        msgpack file or a reference-format torch file;
        :func:`fer_vit_tpu_torch.interop.checkpoints.load_model`) and route
        it: image configs take the image route,
        latent configs the pSp route, which needs ``psp`` or
        ``psp_weights`` (a converted pSp ``.npz`` in the JAX package's
        layout, or a pSp ``.pt`` checkpoint). ``dtype`` is the compute dtype
        of the classifier and the encoder (None: bf16 on CUDA, f32 on the
        CPU); ``device`` defaults to CUDA (with ``mesh``, the mesh's first
        data device)."""
        from fer_vit_tpu_torch.interop.checkpoints import load_model
        from fer_vit_tpu_torch.models.kinds import is_image_config

        device = (mesh.data_devices[0] if mesh is not None and device is None
                  else resolve_device(device))
        model, config = load_model(checkpoint_path, dtype=dtype)
        model_config = config.get("model", config)
        if is_image_config(model_config):
            return cls(model, batch_size=batch_size, image_route=True,
                       input_size=model_config.get("img_size", 224),
                       mesh=mesh, pipeline_depth=pipeline_depth,
                       device=device)
        if psp is None:
            if psp_weights is None:
                raise ValueError(
                    "this is a latent-space checkpoint; pass "
                    "psp_weights=<converted pSp .npz, or a pSp .pt> "
                    "(convert the torch checkpoint via python -m "
                    "fer_vit_tpu_torch.encoders.convert_psp)")
            from fer_vit_tpu_torch.data.generate_latents import load_encoder

            psp = load_encoder(psp_weights, device, dtype=dtype)
        return cls(model, psp=psp, batch_size=batch_size, mesh=mesh,
                   pipeline_depth=pipeline_depth, device=device)

    @classmethod
    def from_exported(cls, artifact_dir: str, *, pipeline_depth: int = 2,
                      device: DeviceLike = None) -> "Predictor":
        """Load an AOT artifact (``python -m fer_vit_tpu_torch.export``,
        :func:`fer_vit_tpu_torch.export.export_predictor`): the whole
        pipeline reloads from the exported programs and the weights file,
        with no model code on the path. The batch size, the input size and
        the input dtypes are the artifact's; each call goes to the program
        of its input dtype, and other dtypes are refused. One device only
        (an exported program is a closed single-device program): for
        data-parallel serving use ``from_checkpoint`` with a mesh.
        ``device`` defaults to CUDA."""
        from fer_vit_tpu_torch.export import load_exported

        calls_by_dtype, weight_args, meta = load_exported(artifact_dir,
                                                          device=device)
        self = cls.__new__(cls)
        self.model = self.psp = self.mesh = None
        self._model_name = meta["model"]
        self._input_dtypes = tuple(calls_by_dtype)
        self.batch_size = int(meta["batch_size"])
        self.pipeline_depth = int(pipeline_depth)
        self.route = meta["route"]
        self.num_classes = int(meta["num_classes"])
        self._answers = _class_answers(self.num_classes)
        self.input_size = int(meta["input_size"])
        self.device = resolve_device(device)
        self._calls = calls_by_dtype
        by_dtype = {getattr(torch, d.name): c
                    for d, c in calls_by_dtype.items()}
        self._replicas = [(self.device, lambda images: by_dtype[
            images.dtype](weight_args, images))]
        return self

    @classmethod
    def from_psp(cls, psp_weights: str, *,
                 decoder_weights: Optional[str] = None,
                 batch_size: int = 64, mesh=None,
                 dtype: Optional[torch.dtype] = None,
                 pipeline_depth: int = 2, output_size: int = 256,
                 device: DeviceLike = None) -> "Predictor":
        """The reconstruction route from a pSp checkpoint: the encoder and
        the decoder both from one ``.pt`` (its ``encoder.*``, ``latent_avg``
        and ``decoder.*`` entries), or the encoder from a converted ``.npz``
        and the decoder from ``decoder_weights``, a generator converted to
        ``.npz`` (``python -m fer_vit_tpu_torch.encoders.convert_stylegan2``)
        or a rosinality generator ``.pt``. The generator's size, mapping
        depth, style width and channel multiplier are read from its
        weights. ``dtype`` is the compute dtype of both halves (None: bf16
        on CUDA, f32 on the CPU)."""
        from fer_vit_tpu_torch.data.generate_latents import load_encoder
        from fer_vit_tpu_torch.encoders.stylegan2 import load_generator

        device = (mesh.data_devices[0] if mesh is not None and device is None
                  else resolve_device(device))
        if decoder_weights is None:
            if psp_weights.endswith(".npz"):
                raise ValueError(
                    "a converted pSp .npz holds the encoder alone: pass "
                    "decoder_weights=<converted generator .npz>, or the "
                    "pSp .pt")
            decoder_weights = psp_weights
        psp = load_encoder(psp_weights, device, dtype=dtype)
        decoder = load_generator(decoder_weights, dtype=dtype)
        return cls(None, psp=psp, decoder=decoder, batch_size=batch_size,
                   mesh=mesh, pipeline_depth=pipeline_depth,
                   output_size=output_size, device=device)

    @property
    def image_route(self) -> bool:
        return self.route == "image"

    def describe(self) -> dict:
        out = {
            "route": self.route,
            "model": self._model_name,
            "batch_size": self.batch_size,
            "input_size": self.input_size,
            "device": str(self.device),
        }
        if self.route == "reconstruct":
            out["output_size"] = self.output_size
        else:
            out["num_classes"] = self.num_classes
        if self.mesh is not None:
            out["mesh"] = dict(self.mesh.shape)
        return out

    def stats(self) -> dict:
        """The reconstruction route's counters, summed over the replicas:
        ``decoded_images`` (:class:`ReconstructFn`); {} on the others."""
        out: dict = {}
        for _, fn in self._replicas:
            for k, v in getattr(fn, "stats", dict)().items():
                out[k] = out.get(k, 0) + v
        return out

    def predict(self, images):
        """(N, S, S, 3) images (uint8 0-255, or float 0-1 / 0-255) -> the
        route's answers: (labels (N,) int32, probs (N, C) f32), or on the
        reconstruction route (N, out, out, 3) uint8 faces. N is arbitrary:
        chunks are padded to ``batch_size``."""
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

        return self._answer(self._run_pipelined(chunks(), len(images)))

    @staticmethod
    def _answer(parts: tuple):
        """The route's answer from :meth:`_run_pipelined`'s arrays: the one
        array of a function with one answer, else the tuple."""
        return parts[0] if len(parts) == 1 else parts

    def _run_pipelined(self, batch_iter, total: int) -> tuple:
        """Runs the padded ``(chunk, rows)`` batches of ``batch_iter``, whose
        rows add up to ``total``, and returns one array per answer of the
        route's function, of the dtype and trailing shape its ``answers()``
        declares (labels int32 and probs f32, or uint8 faces), each filled
        batch by batch, in the order of the batches."""
        out = tuple(np.empty((total,) + shape, dt)
                    for dt, shape in self._answers)
        inflight: deque = deque()
        filled = 0

        def drain_one() -> None:
            nonlocal filled
            k0, shards = inflight.popleft()
            with span("serve.drain"):
                at = filled
                for answers, _host in shards:
                    take = min(len(answers[0]), filled + k0 - at)
                    if take <= 0:
                        break
                    for dst, a in zip(out, answers):
                        # one copy from the card, cast to dst's dtype
                        torch.from_numpy(dst[at:at + take]).copy_(a[:take])
                    at += take
                filled += k0

        for imgs, k in batch_iter:
            inflight.append((k, self._launch(imgs)))
            if len(inflight) > self.pipeline_depth:
                drain_one()
        while inflight:
            drain_one()
        if filled != total:
            raise RuntimeError(f"the batches held {filled} rows, "
                               f"{total} were expected")
        return out

    def _launch(self, chunk: np.ndarray) -> list:
        """Queues one padded chunk: one equal shard per replica, each
        launched on its device before any result is fetched. Returns
        (the function's answers as a tuple, pinned host buffer) per shard;
        the buffer stays referenced until its copy is done."""
        if (self._input_dtypes is not None
                and chunk.dtype not in self._input_dtypes):
            # an artifact pins its input signatures; a silent cast could
            # change values (float 0-1 vs uint8 0-255), so refuse instead
            raise ValueError(
                f"this exported predictor pins input dtypes "
                f"{[d.name for d in self._input_dtypes]}, got "
                f"{chunk.dtype}; re-export with --input_dtypes including "
                f"{chunk.dtype}, or feed a supported dtype")
        per = len(chunk) // len(self._replicas)
        out = []
        for i, (dev, fn) in enumerate(self._replicas):
            with span("serve.put"):
                host, x = _put(chunk[i * per:(i + 1) * per], dev)
            with span("serve.forward"), _on(dev), torch.inference_mode():
                answers = fn(x)
            out.append((answers if isinstance(answers, tuple)
                        else (answers,), host))
        return out

    def predict_files(self, paths: Sequence[str], prefetch: int = 2,
                      return_decode_ok: bool = False):
        """Decode -> predict: the next batch decodes on a background thread
        (the native decoder where it builds, PIL otherwise) while the device
        runs the current one. Files decode at ``input_size``.

        ``return_decode_ok=True`` appends a bool array flagging files the
        decoder black-filled: both decoders give an all-zero image for a
        file they cannot read, so an all-black decoded image marks a failed
        decode."""
        from fer_vit_tpu_torch.data.generate_latents import _decode_batches

        items = [(p, 0) for p in paths]
        ok_out: List[np.ndarray] = []

        def batches():
            for imgs, _labels, _paths, k in _decode_batches(
                    items, self.batch_size, self.input_size,
                    prefetch=prefetch):
                if return_decode_ok:
                    ok_out.append(imgs[:k].reshape(k, -1).any(axis=1))
                yield imgs, k

        out = self._run_pipelined(batches(), len(paths))
        if return_decode_ok:
            ok = (np.concatenate(ok_out) if ok_out
                  else np.zeros((0,), bool))
            return out + (ok,)
        return self._answer(out)

    def predict_packed(self, pack_dir: str, prefetch: int = 2):
        """Predict from a pre-decoded uint8 image pack
        (:mod:`fer_vit_tpu_torch.data.image_packs`): batch assembly is a
        memory copy on a background thread."""
        from fer_vit_tpu_torch.data.image_packs import (iter_packed_batches,
                                                        read_manifest)

        manifest = read_manifest(pack_dir)
        if manifest["size"] != self.input_size:
            raise ValueError(
                f"pack decoded at {manifest['size']}px but this predictor "
                f"expects {self.input_size}px: repack with "
                f"--size {self.input_size}")
        return self._answer(self._run_pipelined(
            iter_packed_batches(pack_dir, self.batch_size,
                                prefetch=prefetch), manifest["num_images"]))

    def warmup(self) -> None:
        """Build the kernels and warm the libraries before serving."""
        self.predict(np.zeros((1, self.input_size, self.input_size, 3),
                              np.uint8))


def _put(chunk: np.ndarray, device: torch.device):
    host = torch.from_numpy(np.ascontiguousarray(chunk))
    if device.type != "cuda":
        return host, host.to(device)
    host = host.pin_memory()
    return host, host.to(device, non_blocking=True)


# -- dynamic request batching --------------------------------------------------


class _Request:
    __slots__ = ("image", "event", "result", "error", "submitted")

    def __init__(self, image: np.ndarray):
        self.image = image
        self.event = threading.Event()
        self.result: Optional[dict] = None
        self.error: Optional[Exception] = None
        self.submitted = time.perf_counter()


class QueueFullError(RuntimeError):
    """Raised by :meth:`Batcher.submit` when the pending-request queue is
    at its bound; the server answers 429 (load shedding)."""


class Batcher:
    """Coalesces concurrent single-image requests into device batches.

    A background thread blocks on the queue; from the first request it
    waits up to ``max_wait_ms`` (or until ``max_batch`` requests are queued)
    before it runs the predictor, so a burst rides one device call.

    Backpressure: at most ``max_queue`` requests may be pending (default
    ``8 * max_batch``); beyond that :meth:`submit` sheds load with
    :class:`QueueFullError`. ``submit_timeout`` is the default bound of one
    request's wait, in seconds: raise it for a server built without
    ``warmup()``, where the first request pays the kernels' build.

    Counters, always on (two ``time.perf_counter()`` reads a request), kept
    by the loop's thread (``refused`` by :meth:`submit`) and read together
    by :meth:`stats`:
    ``requests`` taken into device batches; ``device_batches``, the
    predictor calls made for them; ``queue_wait_s``, the sum over those
    requests of the time from ``submit`` to being taken from the queue;
    ``collect_s``, the sum over batches of the time from the first request
    taken to the batch closed; ``refused``, submissions shed with
    :class:`QueueFullError`. ``GET /healthz`` reports them
    (:func:`make_server`). The loop's steps are spans
    (:mod:`fer_vit_tpu_torch.utils.trace`): ``serve.collect``,
    ``serve.stack`` and ``serve.answer``, around the predictor's own."""

    def __init__(self, predictor: Predictor, max_batch: Optional[int] = None,
                 max_wait_ms: float = 5.0, max_queue: Optional[int] = None,
                 submit_timeout: float = 30.0):
        if getattr(predictor, "route", None) == "reconstruct":
            raise ValueError("the Batcher answers labels and probabilities; "
                             "the reconstruction route runs through "
                             "Predictor.predict and the reconstruct CLI")
        self.predictor = predictor
        self.max_batch = int(max_batch or predictor.batch_size)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue = int(max_queue if max_queue is not None
                             else 8 * self.max_batch)
        if self.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {self.max_queue}")
        self.submit_timeout = float(submit_timeout)
        self.requests = 0
        self.device_batches = 0  # predictor calls the loop has made
        self.queue_wait_s = 0.0
        self.collect_s = 0.0
        self.refused = 0
        self._stats_lock = threading.Lock()
        # the card the loop launches on: the predictor's, by index (a
        # thread starts on card 0 whatever the creating thread's is)
        device = getattr(predictor, "device", None)
        self._card = (indexed(device) if device is not None
                      and device.type == "cuda" else None)
        self._q: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._stop = threading.Event()
        # serialises the closed-check and the enqueue against close(), so
        # no request slips into the queue after the drain
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._loop, name="fervit-batcher", daemon=True)
        self._thread.start()

    def submit(self, image: np.ndarray,
               timeout: Optional[float] = None) -> dict:
        timeout = self.submit_timeout if timeout is None else timeout
        image = np.asarray(image)
        s = self.predictor.input_size
        if image.shape != (s, s, 3):
            # refuse a malformed submission alone: inside the batch loop a
            # wrong shape would fail every coalesced request
            raise ValueError(
                f"expected a ({s}, {s}, 3) image, got {image.shape}")
        req = _Request(image)
        with self._submit_lock:
            if self._stop.is_set():
                raise RuntimeError("batcher is closed")
            if self._q.qsize() >= self.max_queue:
                self.refused += 1
                raise QueueFullError(
                    f"request queue full ({self.max_queue} pending)")
            self._q.put(req)
        if not req.event.wait(timeout):
            raise TimeoutError(f"inference did not finish in {timeout}s")
        if req.error is not None:
            raise req.error
        return req.result

    def stats(self) -> dict:
        """The counters (see the class), as one consistent reading."""
        with self._stats_lock:
            return {"requests": self.requests,
                    "device_batches": self.device_batches,
                    "queue_wait_s": self.queue_wait_s,
                    "collect_s": self.collect_s,
                    "refused": self.refused}

    def queue_depth(self) -> int:
        """Requests waiting to be taken into a batch."""
        return self._q.qsize()

    def _loop(self) -> None:
        if self._card is not None:
            torch.cuda.set_device(self._card)
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            if first is None:
                continue
            taken = time.perf_counter()
            with span("serve.collect"):
                batch, waited = [first], taken - first.submitted
                deadline = time.monotonic() + self.max_wait_s
                while len(batch) < self.max_batch:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    try:
                        req = self._q.get(timeout=remaining)
                    except queue.Empty:
                        break
                    if req is not None:
                        batch.append(req)
                        waited += time.perf_counter() - req.submitted
                closed = time.perf_counter()
            try:
                with span("serve.stack"):
                    images = np.stack([r.image for r in batch])
                with self._stats_lock:
                    self.requests += len(batch)
                    self.device_batches += 1
                    self.queue_wait_s += waited
                    self.collect_s += closed - taken
                labels, probs = self.predictor.predict(images)
            except Exception as e:  # report to every waiter, keep serving
                for r in batch:
                    r.error = e
                    r.event.set()
                continue
            with span("serve.answer"):
                for r, label, prob in zip(batch, labels, probs):
                    r.result = {
                        "label": int(label),
                        "label_name": _label_name(int(label)),
                        "probs": [float(p) for p in prob],
                    }
                    r.event.set()

    def close(self) -> None:
        with self._submit_lock:
            self._stop.set()
            self._q.put(None)
        self._thread.join(timeout=5.0)
        # fail any request still queued when the loop ended, rather than
        # leave its waiter to wait out its timeout
        while True:
            try:
                req = self._q.get_nowait()
            except queue.Empty:
                break
            if req is not None:
                req.error = RuntimeError("batcher is closed")
                req.event.set()


# -- HTTP server ----------------------------------------------------------------


def _decode_request_image(body: bytes, size: int) -> np.ndarray:
    """Request bytes (any format PIL reads) -> (size, size, 3) uint8."""
    from PIL import Image

    with Image.open(io.BytesIO(body)) as im:
        im = im.convert("RGB").resize((size, size), Image.BILINEAR)
        return np.asarray(im, dtype=np.uint8)


# request-body cap: an encoded face is a few MB at most; a larger body is a
# mistake or an attempt to exhaust memory, refused before it is read
MAX_REQUEST_BYTES = 32 * 1024 * 1024


def _health(predictor, batcher: Batcher) -> dict:
    device = getattr(predictor, "device", None)
    out = {"ok": True,
           "platform": None if device is None else device.type,
           "model": predictor.describe(),
           "batcher": dict(batcher.stats(),
                           queue_depth=batcher.queue_depth())}
    if device is not None and device.type == "cuda":
        out["device_name"] = torch.cuda.get_device_name(device)
    return out


def make_server(predictor: Predictor, host: str = "127.0.0.1",
                port: int = 8000, max_batch: Optional[int] = None,
                max_wait_ms: float = 5.0, quiet: bool = True,
                max_queue: Optional[int] = None,
                submit_timeout: float = 30.0):
    """A ``ThreadingHTTPServer`` over ``predictor`` (``.batcher`` attached
    for shutdown).

    Routes: ``GET /healthz`` -> the platform (``cuda`` or ``cpu``), the
    card's name, the model and ``"batcher"``: the batcher's counters
    (:meth:`Batcher.stats`) and its queue depth, which an operator polls
    for the load and the time requests wait (two readings' difference over
    their interval is the window's); ``POST /predict`` with raw image bytes ->
    ``{"label", "label_name", "probs"}``; ``POST /predict_batch`` with one
    uint8 ``.npy`` of (N, S, S, 3) -> ``{"predictions": [...]}`` from one
    predictor call. More than ``max_queue`` pending requests -> 429 with
    ``Retry-After``; a request older than ``submit_timeout`` seconds -> 503.
    Call ``predictor.warmup()`` first (the CLI does), or raise
    ``submit_timeout`` past the kernels' build."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    batcher = Batcher(predictor, max_batch=max_batch,
                      max_wait_ms=max_wait_ms, max_queue=max_queue,
                      submit_timeout=submit_timeout)

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *fmt_args):  # noqa: N802
            if not quiet:
                BaseHTTPRequestHandler.log_message(self, fmt, *fmt_args)

        def _json(self, code: int, obj: dict, headers=()) -> None:
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _length(self) -> int:
            try:
                return int(self.headers.get("Content-Length", 0))
            except ValueError:
                return 0

        def do_GET(self):  # noqa: N802
            if self.path in ("/healthz", "/health"):
                self._json(200, _health(predictor, batcher))
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):  # noqa: N802
            if self.path == "/predict_batch":
                self._predict_batch()
                return
            if self.path != "/predict":
                self._json(404, {"error": f"no route {self.path}"})
                return
            length = self._length()
            if length <= 0:
                self._json(400, {"error": "empty body; POST image bytes"})
                return
            if length > MAX_REQUEST_BYTES:
                self._json(413, {"error": (
                    f"body too large ({length} bytes; "
                    f"max {MAX_REQUEST_BYTES})")})
                return
            body = self.rfile.read(length)
            try:
                image = _decode_request_image(body, predictor.input_size)
            except Exception as e:
                self._json(400, {"error": f"undecodable image: {e}"})
                return
            try:
                result = batcher.submit(image)
            except QueueFullError as e:
                self._json(429, {"error": str(e)}, [("Retry-After", "1")])
                return
            except TimeoutError as e:
                self._json(503, {"error": str(e)})
                return
            except Exception as e:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._json(200, result)

        def _predict_batch(self) -> None:
            """Bulk route: one ``.npy`` of (N, S, S, 3) uint8 -> one
            predictor call -> a JSON list, for clients that hold whole
            arrays."""
            length = self._length()
            if length <= 0 or length > MAX_REQUEST_BYTES:
                self._json(400 if length <= 0 else 413,
                           {"error": f"bad Content-Length {length} "
                                     f"(max {MAX_REQUEST_BYTES})"})
                return
            try:
                images = np.load(io.BytesIO(self.rfile.read(length)),
                                 allow_pickle=False)
            except Exception as e:
                self._json(400, {"error": f"not a .npy payload: {e}"})
                return
            s = predictor.input_size
            if (images.ndim != 4 or images.shape[1:] != (s, s, 3)
                    or images.dtype != np.uint8):
                self._json(400, {"error": (
                    f"expected uint8 (N, {s}, {s}, 3), got "
                    f"{images.dtype} {images.shape}")})
                return
            try:
                labels, probs = predictor.predict(images)
            except Exception as e:
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._json(200, {"predictions": [
                {"label": int(l), "label_name": _label_name(int(l)),
                 "probs": [float(p) for p in pr]}
                for l, pr in zip(labels, probs)]})

    # the standard library's listen backlog is 5: a burst of 32 clients
    # overflows the accept queue and they see connection resets before the
    # batcher can shed load, so the backlog is raised past max_queue and
    # backpressure is the 429 path
    class _Server(ThreadingHTTPServer):
        request_queue_size = max(128, batcher.max_queue + batcher.max_batch)

    server = _Server((host, port), Handler)
    server.batcher = batcher
    return server


# -- the predict CLI -----------------------------------------------------------


def build_predict_parser() -> argparse.ArgumentParser:
    """The JAX ``fervit-predict`` flags, unchanged."""
    p = argparse.ArgumentParser(
        description="Offline batch FER prediction over image files")
    p.add_argument("--checkpoint_path", default=None,
                   help="FER checkpoint (the port's own or a JAX trainer's "
                        "msgpack file); mutually exclusive with --exported")
    p.add_argument("--exported", default=None,
                   help="AOT artifact directory (python -m "
                        "fer_vit_tpu_torch.export): reloads the exported "
                        "pipeline without model code; mutually exclusive "
                        "with --checkpoint_path")
    p.add_argument("--input", default=None, nargs="+",
                   help="image files and/or directories (recursive)")
    p.add_argument("--packed", default=None,
                   help="pre-decoded uint8 image pack directory "
                        "(python -m fer_vit_tpu_torch.data.image_packs): "
                        "the decode-free input path; mutually exclusive "
                        "with --input")
    p.add_argument("--output", default=None,
                   help="write predictions JSON here (default: stdout)")
    p.add_argument("--psp_weights", default=None,
                   help="converted pSp encoder .npz or pSp .pt (required "
                        "for latent-space checkpoints)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--top_k", type=int, default=1)
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="batches kept in flight on the device (overlaps "
                        "transfer and compute with the fetch of results)")
    _add_dp_flag(p)
    return p


def _add_dp_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument("--dp_devices", type=int, default=1,
                   help="shard request batches over this many devices "
                        "(data-parallel; -1 = all devices, 1 = no mesh)")


def _mesh_from_flag(dp_devices: int, device: DeviceLike = None):
    """The data-parallel mesh ``--dp_devices`` asks for over the visible
    devices of ``device``'s type (every card; the CPU is one device), or
    None for 1."""
    if dp_devices == 1:
        return None
    if dp_devices < 1 and dp_devices != -1:
        raise SystemExit(
            f"--dp_devices must be a positive device count or -1 (all "
            f"devices), got {dp_devices}")
    from fer_vit_tpu_torch.core.mesh import (MeshConfig, make_mesh,
                                             visible_devices)

    devices = visible_devices(device)
    n = len(devices) if dp_devices == -1 else dp_devices
    return make_mesh(MeshConfig(data=n, model=1), devices)


def _predictor_from_args(args, device: DeviceLike = None) -> Predictor:
    exported = getattr(args, "exported", None)
    if (args.checkpoint_path is None) == (exported is None):
        raise SystemExit(
            "pass exactly one of --checkpoint_path or --exported")
    depth = getattr(args, "pipeline_depth", 2)
    if exported is not None:
        if getattr(args, "dp_devices", 1) != 1:
            raise SystemExit(
                "--exported is a closed single-device program and cannot "
                "shard over --dp_devices; use --checkpoint_path for "
                "data-parallel serving")
        return Predictor.from_exported(exported, pipeline_depth=depth,
                                       device=device)
    mesh = _mesh_from_flag(args.dp_devices, device)
    return Predictor.from_checkpoint(
        args.checkpoint_path, psp_weights=args.psp_weights,
        batch_size=args.batch_size, mesh=mesh, pipeline_depth=depth,
        device=None if mesh is not None else device)


def predict_main(args, device: DeviceLike = None) -> dict:
    """The predict CLI: predictions for every image under ``--input`` (or
    in the ``--packed`` pack) as the JAX CLI's report ``{checkpoint, model,
    num_images, decode_failures, predictions: [{path, label, label_name,
    decode_ok, top_k}]}``, written to ``--output`` or printed. ``device``
    defaults to CUDA."""
    if (args.input is None) == (getattr(args, "packed", None) is None):
        raise SystemExit("pass exactly one of --input or --packed")
    predictor = _predictor_from_args(args, device)
    if args.packed is not None:
        from fer_vit_tpu_torch.data.image_packs import read_manifest

        manifest = read_manifest(args.packed)
        paths = manifest["paths"]
        decode_ok = np.asarray(manifest["decode_ok"], bool)
        labels, probs = predictor.predict_packed(args.packed)
    else:
        from fer_vit_tpu_torch.data.image_pipeline import collect_inputs

        paths = collect_inputs(args.input)
        if not paths:
            raise SystemExit("no images found under --input")
        labels, probs, decode_ok = predictor.predict_files(
            paths, return_decode_ok=True)
    top_k = max(1, args.top_k)
    predictions = []
    for path, label, prob, ok in zip(paths, labels, probs, decode_ok):
        order = np.argsort(prob)[::-1][:top_k]
        predictions.append({
            "path": path,
            "label": int(label),
            "label_name": _label_name(int(label)),
            # False: the decoder black-filled this file (corrupt or
            # unreadable), so its row says nothing about a face
            "decode_ok": bool(ok),
            "top_k": [{"label": int(j), "label_name": _label_name(int(j)),
                       "prob": float(prob[j])} for j in order],
        })
    failures = [p for p, ok in zip(paths, decode_ok) if not ok]
    report = {
        "checkpoint": args.checkpoint_path or getattr(args, "exported",
                                                      None),
        "model": predictor.describe(),
        "num_images": len(paths),
        "decode_failures": failures,
        "predictions": predictions,
    }
    if failures:
        print(f"WARNING: {len(failures)} file(s) failed to decode "
              f"(black-filled; see report['decode_failures'])")
    text = json.dumps(report, indent=2)
    if args.output:
        os.makedirs(os.path.dirname(args.output) or ".", exist_ok=True)
        with open(args.output, "w") as f:
            f.write(text + "\n")
        print(f"wrote {len(paths)} predictions to {args.output}")
    else:
        print(text)
    return report


def build_reconstruct_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Reconstruct faces through the whole pSp model (encoder "
                    "and StyleGAN2 decoder) into a uint8 image pack")
    p.add_argument("--psp_weights", required=True,
                   help="pSp .pt (the encoder, latent_avg and the decoder), "
                        "or a converted pSp encoder .npz with "
                        "--decoder_weights")
    p.add_argument("--decoder_weights", default=None,
                   help="converted generator .npz (python -m "
                        "fer_vit_tpu_torch.encoders.convert_stylegan2) or a "
                        "generator .pt; default: the --psp_weights .pt")
    p.add_argument("--input", default=None, nargs="+",
                   help="image files and/or directories (recursive)")
    p.add_argument("--packed", default=None,
                   help="pre-decoded uint8 image pack directory; mutually "
                        "exclusive with --input")
    p.add_argument("--output", required=True,
                   help="image pack directory to write the reconstructions "
                        "to (predict --packed reads it)")
    p.add_argument("--output_size", type=int, default=256,
                   help="side of the answers (pSp's face_pool: 256)")
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--pipeline_depth", type=int, default=2,
                   help="batches kept in flight on the device")
    _add_dp_flag(p)
    return p


def reconstruct_main(args, device: DeviceLike = None) -> dict:
    """The reconstruct CLI: every image under ``--input`` (or in the
    ``--packed`` pack) through :meth:`Predictor.from_psp`'s route, written
    as an image pack to ``--output`` with the inputs' paths, labels (from a
    pack) and ``decode_ok`` flags. Returns the pack's manifest. ``device``
    defaults to CUDA."""
    from fer_vit_tpu_torch.data.image_packs import (read_manifest,
                                                    write_array_pack)

    if (args.input is None) == (args.packed is None):
        raise SystemExit("pass exactly one of --input or --packed")
    mesh = _mesh_from_flag(args.dp_devices, device)
    predictor = Predictor.from_psp(
        args.psp_weights, decoder_weights=args.decoder_weights,
        batch_size=args.batch_size, mesh=mesh,
        pipeline_depth=args.pipeline_depth, output_size=args.output_size,
        device=None if mesh is not None else device)
    labels = None
    if args.packed is not None:
        manifest = read_manifest(args.packed)
        paths, labels = manifest["paths"], manifest["labels"]
        decode_ok = manifest["decode_ok"]
        images = predictor.predict_packed(args.packed)
    else:
        from fer_vit_tpu_torch.data.image_pipeline import collect_inputs

        paths = collect_inputs(args.input)
        if not paths:
            raise SystemExit("no images found under --input")
        images, decode_ok = predictor.predict_files(paths,
                                                    return_decode_ok=True)
    manifest = write_array_pack(images, args.output, paths,
                                decode_ok=decode_ok, labels=labels)
    print(f"wrote {len(paths)} reconstructions "
          f"({predictor.describe()['model']}) to {args.output}")
    return manifest


def build_serve_parser() -> argparse.ArgumentParser:
    """The JAX ``fervit-serve`` flags, unchanged."""
    p = argparse.ArgumentParser(
        description="FER inference HTTP server with dynamic batching")
    p.add_argument("--checkpoint_path", default=None,
                   help="FER checkpoint (the port's own or a JAX trainer's "
                        "msgpack file); mutually exclusive with --exported")
    p.add_argument("--exported", default=None,
                   help="AOT artifact directory (python -m "
                        "fer_vit_tpu_torch.export); mutually exclusive with "
                        "--checkpoint_path")
    p.add_argument("--psp_weights", default=None,
                   help="converted pSp encoder .npz or pSp .pt (required "
                        "for latent-space checkpoints)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--batch_size", type=int, default=64,
                   help="device batch size")
    p.add_argument("--max_batch", type=int, default=None,
                   help="max requests coalesced per device call "
                        "(default: batch_size)")
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="batching window after the first queued request")
    p.add_argument("--max_queue", type=int, default=None,
                   help="pending-request bound before 429 load shedding "
                        "(default: 8 * max_batch)")
    p.add_argument("--submit_timeout", type=float, default=30.0,
                   help="per-request wall-clock bound in seconds before "
                        "a 503 is returned")
    _add_dp_flag(p)
    return p


def serve_main(args, device: DeviceLike = None) -> None:
    """The server CLI: load, warm up, serve until interrupted. ``device``
    defaults to CUDA."""
    predictor = _predictor_from_args(args, device)
    print(f"warming up {predictor.describe()} ...")
    predictor.warmup()
    server = make_server(predictor, host=args.host, port=args.port,
                         max_batch=args.max_batch,
                         max_wait_ms=args.max_wait_ms, quiet=False,
                         max_queue=args.max_queue,
                         submit_timeout=args.submit_timeout)
    print(f"serving on http://{args.host}:{server.server_port} "
          f"(POST /predict, POST /predict_batch, GET /healthz)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.batcher.close()
        server.server_close()


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "serve":
        serve_main(build_serve_parser().parse_args(sys.argv[2:]))
    else:
        predict_main(build_predict_parser().parse_args())
