"""Batch inference: images -> (labels, probs), and the predict CLI.

Port of ``fer_vit_tpu/serve.py``'s ``Predictor``, with its two routes: the
latent route (preprocess -> pSp encode -> classify, for classifiers over w+
codes) and the image route (ImageNet normalisation -> ImageViT or TimmViT);
both end in an f32 softmax and argmax, at one fixed batch size. Requests of
any length are cut into chunks padded to ``batch_size``, and up to
``pipeline_depth`` chunks are in flight: CUDA work is queued without
waiting, and fetching an older chunk's results to the host is the only
wait. The answers do not depend on the depth.

:meth:`Predictor.from_checkpoint` loads a trained checkpoint (the port's own,
a JAX trainer's msgpack file or a reference-format torch file) and routes
it by its config;
:meth:`Predictor.predict_files` decodes image files on a background thread
and :meth:`Predictor.predict_packed` reads pre-decoded packs
(:mod:`fer_vit_tpu_torch.data.image_packs`). The offline predict CLI, with
the JAX CLI's flags and report::

    python -m fer_vit_tpu_torch.serve --checkpoint_path best_model.pt \
        --psp_weights psp.npz --input faces/ --output preds.json

The HTTP server, ``--exported`` and ``--dp_devices`` other than 1 are not
ported yet (ROADMAP.md queue 1 item 7).
"""

from __future__ import annotations

import argparse
import json
import os
from collections import deque
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from fer_vit_tpu_torch import EMOTION_NAMES, NUM_CLASSES
from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device
from fer_vit_tpu_torch.data.image_pipeline import IMAGE_EXTS, normalize_images
from fer_vit_tpu_torch.encoders.psp import preprocess_images, to_unit_floats

NOT_PORTED_ITEM_7 = ("{} is not ported yet (ROADMAP.md queue 1 item 7, "
                     "serving and scale-out)")


def _label_name(label: int) -> str:
    return (EMOTION_NAMES[label] if 0 <= label < len(EMOTION_NAMES)
            else str(label))


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

    @classmethod
    def from_checkpoint(cls, checkpoint_path: str, *,
                        psp_weights: Optional[str] = None, psp=None,
                        batch_size: int = 64,
                        dtype: Optional[torch.dtype] = None,
                        pipeline_depth: int = 2,
                        device: DeviceLike = None) -> "Predictor":
        """Load a trained checkpoint (the port's own, a JAX trainer's
        msgpack file or a reference-format torch file;
        :func:`fer_vit_tpu_torch.eval.evaluate_model.load_model`) and route
        it: image configs take the image route,
        latent configs the pSp route, which needs ``psp`` or
        ``psp_weights`` (a converted pSp ``.npz`` in the JAX package's
        layout, or a pSp ``.pt`` checkpoint). ``dtype`` is the compute dtype
        of the classifier and the encoder (None: bf16 on CUDA, f32 on the
        CPU); ``device`` defaults to CUDA."""
        from fer_vit_tpu_torch.eval.evaluate_model import (is_image_config,
                                                           load_model)

        device = resolve_device(device)
        model, config = load_model(checkpoint_path, dtype=dtype)
        model_config = config.get("model", config)
        if is_image_config(model_config):
            return cls(model, batch_size=batch_size, image_route=True,
                       input_size=model_config.get("img_size", 224),
                       pipeline_depth=pipeline_depth, device=device)
        if psp is None:
            if psp_weights is None:
                raise ValueError(
                    "this is a latent-space checkpoint; pass "
                    "psp_weights=<converted pSp .npz, or a pSp .pt> "
                    "(convert the torch checkpoint via "
                    "fer_vit_tpu/encoders/convert_psp.py)")
            from fer_vit_tpu_torch.data.generate_latents import load_encoder

            psp = load_encoder(psp_weights, device, dtype=dtype)
        return cls(model, psp=psp, batch_size=batch_size,
                   pipeline_depth=pipeline_depth, device=device)

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

        out = self._run_pipelined(batches())
        if return_decode_ok:
            ok = (np.concatenate(ok_out) if ok_out
                  else np.zeros((0,), bool))
            return out + (ok,)
        return out

    def predict_packed(self, pack_dir: str,
                       prefetch: int = 2) -> Tuple[np.ndarray, np.ndarray]:
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
        return self._run_pipelined(
            iter_packed_batches(pack_dir, self.batch_size,
                                prefetch=prefetch))

    def warmup(self) -> None:
        """Build the kernels and warm the libraries before serving."""
        self.predict(np.zeros((1, self.input_size, self.input_size, 3),
                              np.uint8))


# -- the predict CLI -----------------------------------------------------------


def _collect_inputs(inputs: Sequence[str]) -> List[str]:
    """Files and/or directories (recursive) -> ordered unique image paths."""
    out: List[str] = []
    seen = set()

    def add(path: str) -> None:
        if path not in seen:
            seen.add(path)
            out.append(path)

    for item in inputs:
        if os.path.isdir(item):
            for root, dirs, files in os.walk(item):
                dirs.sort()  # deterministic traversal across filesystems
                for name in sorted(files):
                    if name.lower().endswith(IMAGE_EXTS):
                        add(os.path.join(root, name))
        elif os.path.isfile(item):
            add(item)
        else:
            raise FileNotFoundError(f"--input entry not found: {item}")
    return out


def build_predict_parser() -> argparse.ArgumentParser:
    """The JAX ``fervit-predict`` flags, unchanged."""
    p = argparse.ArgumentParser(
        description="Offline batch FER prediction over image files")
    p.add_argument("--checkpoint_path", default=None,
                   help="FER checkpoint (the port's own or a JAX trainer's "
                        "msgpack file); mutually exclusive with --exported")
    p.add_argument("--exported", default=None,
                   help="AOT artifact directory (not ported yet); "
                        "mutually exclusive with --checkpoint_path")
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
    p.add_argument("--dp_devices", type=int, default=1,
                   help="shard request batches over this many devices "
                        "(only 1 is ported yet)")
    return p


def _predictor_from_args(args, device: DeviceLike = None) -> Predictor:
    exported = getattr(args, "exported", None)
    if (args.checkpoint_path is None) == (exported is None):
        raise SystemExit(
            "pass exactly one of --checkpoint_path or --exported")
    if exported is not None:
        raise SystemExit(NOT_PORTED_ITEM_7.format("--exported"))
    if getattr(args, "dp_devices", 1) != 1:
        raise SystemExit(NOT_PORTED_ITEM_7.format(
            f"--dp_devices {args.dp_devices} (data-parallel serving)"))
    return Predictor.from_checkpoint(
        args.checkpoint_path, psp_weights=args.psp_weights,
        batch_size=args.batch_size,
        pipeline_depth=getattr(args, "pipeline_depth", 2), device=device)


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
        paths = _collect_inputs(args.input)
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
        "checkpoint": args.checkpoint_path,
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


if __name__ == "__main__":
    import sys

    if len(sys.argv) > 1 and sys.argv[1] == "serve":
        raise SystemExit(NOT_PORTED_ITEM_7.format("the HTTP server"))
    predict_main(build_predict_parser().parse_args())
