"""Evaluate a trained ImageViT (or TimmViT) checkpoint on a class-dir image
set.

Port of ``fer_vit_tpu/eval/evaluate_image_vit.py`` (reference:
eval/evaluate_image_vit.py): the size presets (tiny/small/base) override the
raw dims saved in the config, and ``use_pretrained`` builds the timm
architecture (:mod:`fer_vit_tpu_torch.models.kinds`). The images are
decoded once by
:class:`~fer_vit_tpu_torch.data.image_pipeline.ImageStore` at the
checkpoint's size and normalised on the device
(:func:`~fer_vit_tpu_torch.data.image_pipeline.normalize_images`); from 128
tokens on, ImageViT's attention runs the fused attention kernel. The
figures and both JSON files are the latent evaluator's
(:mod:`fer_vit_tpu_torch.eval.evaluate_model`).

CLI (the reference's flags; ``--img_size 0`` takes the checkpoint's size,
``--device`` picks the device, CUDA unless ``cpu``)::

    python -m fer_vit_tpu_torch.eval.evaluate_image_vit \
        --checkpoint_path best_model.pt --test_dir faces/test
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import torch

from fer_vit_tpu_torch import EMOTION_NAMES
from fer_vit_tpu_torch.core.dtypes import resolve_device
from fer_vit_tpu_torch.eval.evaluate_model import (_plots, predict_arrays,
                                                   results_summary,
                                                   write_json)
from fer_vit_tpu_torch.interop import checkpoints
from fer_vit_tpu_torch.utils.metrics import (classification_report,
                                             metrics_from_confusion)


def load_model(checkpoint_path: str, dtype: Optional[torch.dtype] = None):
    """-> (model, config, img_size), through
    :func:`fer_vit_tpu_torch.interop.checkpoints.load_model` (the port's
    own, the JAX trainers' and reference-format checkpoints)."""
    model, config = checkpoints.load_model(checkpoint_path, dtype=dtype)
    model_config = config.get("model", config)
    return model, config, model_config.get("img_size", 224)


def build_parser() -> argparse.ArgumentParser:
    """The reference's CLI; ``--img_size 0`` means the checkpoint's size
    and ``--device`` selects the device (CUDA unless ``cpu``)."""
    parser = argparse.ArgumentParser(description="Evaluate ImageViT")
    parser.add_argument("--checkpoint_path", required=True)
    parser.add_argument("--test_dir", required=True)
    parser.add_argument("--output_dir", default="eval_results")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default) or cpu")
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--img_size", type=int, default=0,
                        help="expected eval resolution; must match the "
                             "checkpoint's img_size (0 = auto from the "
                             "checkpoint)")
    return parser


def main(args) -> dict:
    from fer_vit_tpu_torch.data.image_pipeline import (ImageStore,
                                                       normalize_images)

    dev = resolve_device(args.device)
    os.makedirs(args.output_dir, exist_ok=True)
    model, config, img_size = load_model(args.checkpoint_path)
    if getattr(args, "img_size", 0):
        if args.img_size != img_size:
            # the learned position table is fixed at the training
            # resolution's token count
            raise SystemExit(
                f"--img_size {args.img_size} != checkpoint img_size "
                f"{img_size}: ImageViT's pos-embedding is fixed at the "
                "training resolution; use --img_size 0 (auto).")
        img_size = args.img_size
    store = ImageStore.load(args.test_dir, img_size)
    preds, probs, cm = predict_arrays(model, store.images, store.labels,
                                      args.batch_size, dev,
                                      transform=normalize_images)

    m = metrics_from_confusion(cm)
    names = [n.capitalize() for n in EMOTION_NAMES]
    print("\nClassification Report:")
    print(classification_report(cm, names))
    _plots(cm, probs, preds, store.labels, args.output_dir)

    report = {
        "checkpoint": args.checkpoint_path, "test_dir": args.test_dir,
        "num_samples": len(store), "accuracy": m["accuracy"],
        "f1_macro": m["f1_macro"], "f1_weighted": m["f1_weighted"],
        "config": config,
    }
    write_json(os.path.join(args.output_dir, "evaluation_report.json"),
               report)
    write_json(os.path.join(args.output_dir, "evaluation_results.json"),
               results_summary(cm, config, args.checkpoint_path, len(store)))
    return report


if __name__ == "__main__":
    main(build_parser().parse_args())
