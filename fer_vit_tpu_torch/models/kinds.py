"""Which classifier a checkpoint's model config describes, and that
classifier built with fresh weights: the config discrimination of
``fer_vit_tpu/eval/evaluate_model.py`` and ``evaluate_image_vit.py``
(reference: eval/evaluate_model.py:50-114). An ExpressionAwareViT config
has ``model_size`` and builds the plain HybridLatentViT, as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch

from fer_vit_tpu_torch.models import (ImageViT, LatentViT, LatentViTv2,
                                      create_hybrid_latent_vit,
                                      create_latent_cnn, create_timm_vit)
from fer_vit_tpu_torch.models.image_vit import PRESETS


def is_image_config(model_config: dict) -> bool:
    """The image-vs-latent discrimination every checkpoint router uses."""
    return "img_size" in model_config or "patch_size" in model_config


def model_kind(model_config: dict) -> str:
    """``timm_vit`` (an image config with ``use_pretrained``),
    ``image_vit`` (other image configs), ``hybrid_latent_vit``
    (``model_size``), ``latent_cnn`` (``model_type``), ``latent_vit_v2``
    (``use_lwn/spe/leam`` flags) or ``latent_vit``, told apart in the JAX
    ``model_from_config``'s order."""
    if is_image_config(model_config):
        return ("timm_vit" if model_config.get("use_pretrained")
                else "image_vit")
    if "model_size" in model_config:
        return "hybrid_latent_vit"
    if "model_type" in model_config:
        return "latent_cnn"
    if any(model_config.get(k) for k in
           ("use_lwn", "use_spe", "use_leam", "use_lwn_residual")):
        return "latent_vit_v2"
    return "latent_vit"


def model_from_config(model_config: dict,
                      dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
    """The classifier a model config describes, with fresh weights;
    ``dtype`` is its compute dtype (None: bf16 on CUDA, f32 elsewhere)."""
    model_config = dict(model_config)
    model_config.setdefault("num_classes", 7)
    kind = model_kind(model_config)
    if kind == "timm_vit":
        model, _ = create_timm_vit(
            model_config.get("model_size", "small"),
            num_classes=model_config["num_classes"],
            img_size=model_config.get("img_size", 224), dtype=dtype)
        return model
    if kind == "image_vit":
        # a preset overrides the raw dims saved beside it; "custom" takes
        # them, each defaulting to ViT-Small's
        dims = PRESETS.get(model_config.get("model_size"), {
            k: model_config.get(k, v) for k, v in PRESETS["small"].items()})
        return ImageViT(img_size=model_config.get("img_size", 224),
                        patch_size=model_config.get("patch_size", 16),
                        num_classes=model_config["num_classes"],
                        dropout=model_config.get("dropout", 0.1),
                        dtype=dtype, **dims)
    if kind == "hybrid_latent_vit":
        return create_hybrid_latent_vit(
            latent_dim=model_config.get("latent_dim", 512),
            seq_len=model_config.get("seq_len", 18),
            model_size=model_config.get("model_size", "small"),
            num_classes=model_config["num_classes"],
            use_adapter=bool(model_config.get("use_adapter")),
            adapter_dim=model_config.get("adapter_dim") or 64,
            dtype=dtype,
        )
    if kind == "latent_cnn":
        return create_latent_cnn(
            model_config["model_type"],
            latent_dim=model_config.get("latent_dim", 512),
            seq_len=model_config.get("seq_len", 18),
            num_classes=model_config["num_classes"],
            dropout=model_config.get("dropout", 0.3),
            dtype=dtype,
        )
    common = dict(
        latent_dim=model_config.get("latent_dim", 512),
        seq_len=model_config.get("seq_len", 18),
        embed_dim=model_config.get("embed_dim", 512),
        depth=model_config.get("depth", 6),
        heads=model_config.get("heads", 8),
        mlp_dim=model_config.get("mlp_dim", 2048),
        num_classes=model_config["num_classes"],
        dropout=model_config.get("dropout", 0.1),
        dtype=dtype,
    )
    if kind == "latent_vit_v2":
        return LatentViTv2(
            use_lwn=bool(model_config.get("use_lwn")),
            use_lwn_residual=bool(model_config.get("use_lwn_residual")),
            use_spe=bool(model_config.get("use_spe")),
            use_leam=bool(model_config.get("use_leam")),
            **common,
        )
    return LatentViT(**common)
