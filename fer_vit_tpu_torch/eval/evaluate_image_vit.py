"""Load a trained ImageViT (or TimmViT) checkpoint.

Port of the loader of ``fer_vit_tpu/eval/evaluate_image_vit.py``: the size
presets (tiny/small/base) override the raw dims saved in the config, and
``use_pretrained`` builds the timm architecture. The evaluator CLI is not
ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from fer_vit_tpu_torch.models import ImageViT
from fer_vit_tpu_torch.models.timm_vit import create_timm_vit

SIZE_PRESETS = {
    "tiny": dict(embed_dim=192, depth=12, heads=3, mlp_dim=768),
    "small": dict(embed_dim=384, depth=12, heads=6, mlp_dim=1536),
    "base": dict(embed_dim=768, depth=12, heads=12, mlp_dim=3072),
}


def model_from_config(model_config: dict,
                      dtype: Optional[torch.dtype] = None) -> torch.nn.Module:
    model_config = dict(model_config)
    model_config.setdefault("num_classes", 7)
    if model_config.get("use_pretrained"):
        model, _ = create_timm_vit(
            model_config.get("model_size", "small"),
            num_classes=model_config["num_classes"],
            img_size=model_config.get("img_size", 224), dtype=dtype)
        return model
    preset = SIZE_PRESETS.get(model_config.get("model_size", "custom"), {})
    return ImageViT(
        img_size=model_config.get("img_size", 224),
        patch_size=model_config.get("patch_size", 16),
        embed_dim=preset.get("embed_dim", model_config.get("embed_dim", 384)),
        depth=preset.get("depth", model_config.get("depth", 12)),
        heads=preset.get("heads", model_config.get("heads", 6)),
        mlp_dim=preset.get("mlp_dim", model_config.get("mlp_dim", 1536)),
        num_classes=model_config["num_classes"],
        dropout=model_config.get("dropout", 0.1),
        dtype=dtype,
    )


def load_model(checkpoint_path: str, dtype: Optional[torch.dtype] = None):
    """-> (model, config, img_size), through
    :func:`fer_vit_tpu_torch.eval.evaluate_model.load_model` (both
    containers; reference-format torch files raise)."""
    from fer_vit_tpu_torch.eval.evaluate_model import load_model as load

    model, config = load(checkpoint_path, dtype=dtype)
    model_config = config.get("model", config)
    return model, config, model_config.get("img_size", 224)
