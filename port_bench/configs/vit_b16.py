"""ViT-Base/16 at 224 px on the image route: its weights, the program
built from them, its spans, its operations, and its plain reference.

Weights are drawn from the seed on the device (:mod:`port_bench.core.
weights`), with the spreads of the reference ImageViT's init: the patch
conv U(+-1/sqrt(768)); CLS, positions, the layers' Linears and the head
with std 0.02 (as U(+-0.02 sqrt(3))); ``in_proj_weight`` xavier-uniform;
LayerNorms near identity; small random biases. The program is the port's
``ImageViT`` built on the meta device and loaded with them.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from port_bench.core.weights import seeded_state
from port_bench.reference import bounds, transformer

STD02 = 0.02 * math.sqrt(3.0)

# The shapes of the harness's CPU tests: ``SMALL`` for every test that runs
# the cell, ``CONTROL_SHAPES`` where the fp8 controls' gaps have to show
# (ViT-Base's widths with two layers on 64 px).
SMALL = {
    "input_size": 32,
    "classifier": {"img_size": 32, "patch_size": 16, "embed_dim": 32,
                   "depth": 1, "heads": 2, "mlp_dim": 64, "num_classes": 7,
                   "dropout": 0.1}}
CONTROL_SHAPES = {
    "input_size": 64,
    "classifier": {"img_size": 64, "patch_size": 16, "embed_dim": 768,
                   "depth": 2, "heads": 12, "mlp_dim": 3072,
                   "num_classes": 7, "dropout": 0.1}}


def _model(spec: dict):
    from fer_vit_tpu_torch.models import ImageViT

    c = spec["classifier"]
    return ImageViT(img_size=c["img_size"], patch_size=c["patch_size"],
                    embed_dim=c["embed_dim"], depth=c["depth"],
                    heads=c["heads"], mlp_dim=c["mlp_dim"],
                    num_classes=c["num_classes"], dropout=c["dropout"])


def _spec(spec: dict) -> Dict[str, tuple]:
    with torch.device("meta"):
        sd = _model(spec).state_dict()
    d = spec["classifier"]["embed_dim"]
    out = {}
    for k, v in sd.items():
        shape = tuple(v.shape)
        if k == "patch_embed.proj.weight":
            b = 1.0 / math.sqrt(math.prod(shape[1:]))
            out[k] = (shape, -b, b)
        elif k.endswith("in_proj_weight"):
            b = math.sqrt(6.0 / (4 * d))
            out[k] = (shape, -b, b)
        elif ".norm" in k or k.startswith("norm."):
            out[k] = (shape, 0.9, 1.1) if k.endswith("weight") else (
                shape, -0.05, 0.05)
        elif k.endswith("bias"):
            out[k] = (shape, -0.02, 0.02)
        else:
            out[k] = (shape, -STD02, STD02)
    return out


def weights(spec: dict, seed: int, device: torch.device) -> dict:
    return {"classifier": seeded_state(_spec(spec), seed, device, 4)}


def predictor(spec: dict, w: dict, device: torch.device, batch_size: int,
              pipeline_depth: int):
    from fer_vit_tpu_torch.serve import Predictor

    with torch.device("meta"):
        model = _model(spec)
    model = model.to_empty(device=device)
    model.load_state_dict(w["classifier"])
    return Predictor(model, batch_size=batch_size, image_route=True,
                     input_size=spec["input_size"],
                     pipeline_depth=pipeline_depth, device=device)


def add_spans(spans, predictor) -> None:
    """Ranges around the classifier and each layer's attention module."""
    spans.module(predictor.model, "classifier")
    for i, layer in enumerate(predictor.model.transformer.layers):
        spans.module(layer.self_attn, f"attention.{i}")


def attention_least_ms(spec: dict, batch: int) -> float:
    c = spec["classifier"]
    n = (c["img_size"] // c["patch_size"]) ** 2 + 1
    return c["depth"] * bounds.least_ms(
        bounds.attention_bound_ms(batch, n, c["embed_dim"], c["heads"]))


def flops_per_image(spec: dict) -> float:
    c = spec["classifier"]
    p, d = c["patch_size"], c["embed_dim"]
    patches = (c["img_size"] // p) ** 2
    n = patches + 1
    f = 2.0 * patches * (p * p * 3) * d
    f += c["depth"] * (bounds.attention_flops(1, n, d, c["heads"])
                       + 2.0 * n * 2 * d * c["mlp_dim"])
    return f + 2.0 * d * c["num_classes"]


def reference(spec: dict, w: dict, images_uint8: torch.Tensor,
              precision: Optional[str] = None) -> dict:
    c = spec["classifier"]
    logits = transformer.image_vit_logits(
        w["classifier"], images_uint8, patch=c["patch_size"],
        depth=c["depth"], heads=c["heads"], precision=precision)
    return {"probs": torch.softmax(logits, dim=-1)}
