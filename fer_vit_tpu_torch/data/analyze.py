"""Dataset analysis, a sample-grid figure and a single-image predictor.

Port of ``fer_vit_tpu/data/analyze.py`` (the legacy utilities of the
reference's ``preprocessing.py``:201-291): per-split class counts, a
sample-grid figure, and a single-image emotion predictor on the ViT-B/16
fine-tune, the timm-architecture :class:`~fer_vit_tpu_torch.models.TimmViT`
that :mod:`fer_vit_tpu_torch.train.vit_fer` trains. Its attention is the
plain version, as the JAX TimmViT's.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from fer_vit_tpu_torch import EMOTION_NAMES
from fer_vit_tpu_torch.core.dtypes import DeviceLike, resolve_device
from fer_vit_tpu_torch.data.image_pipeline import IMAGE_EXTS
from fer_vit_tpu_torch.interop.checkpoints import is_torch_checkpoint


def analyze_fer2013_dataset(root_dir: str, splits=("train", "test")
                            ) -> Dict[str, Dict[str, int]]:
    """Per-split, per-class sample counts (reference:
    preprocessing.py:201-224).

    Prints the same report layout and returns {split: {emotion: count}}.
    """
    print("=== FER2013 dataset analysis ===\n")
    out: Dict[str, Dict[str, int]] = {}
    for split in splits:
        split_path = os.path.join(root_dir, split)
        if not os.path.exists(split_path):
            continue
        print(f"{split.upper()} data:")
        counts: Dict[str, int] = {}
        total = 0
        for emotion in EMOTION_NAMES:
            emotion_path = os.path.join(split_path, emotion)
            if os.path.exists(emotion_path):
                n = len([f for f in os.listdir(emotion_path)
                         if f.lower().endswith(IMAGE_EXTS)])
                print(f"  {emotion.capitalize()}: {n}")
                counts[emotion] = n
                total += n
        print(f"  Total: {total}\n")
        out[split] = counts
    return out


def visualize_fer2013_samples(store, num_samples: int = 8,
                              figsize=(12, 8), out_path: Optional[str] = None,
                              seed: int = 0):
    """Sample-grid figure (reference: preprocessing.py:226-257).

    ``store`` is an :class:`fer_vit_tpu_torch.data.image_pipeline.ImageStore`
    (uint8 images and labels). Saves to ``out_path`` if given, else shows
    it interactively.
    """
    import matplotlib

    if out_path is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rng = np.random.default_rng(seed)
    indices = rng.choice(len(store), size=min(num_samples, len(store)),
                         replace=False)
    ncols = 4
    nrows = (len(indices) + ncols - 1) // ncols
    fig, axes = plt.subplots(nrows, ncols, figsize=figsize)
    axes = np.atleast_1d(axes).ravel()
    for ax in axes[len(indices):]:
        ax.axis("off")
    for ax, idx in zip(axes, indices):
        img = np.asarray(store.images[int(idx)])
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        ax.imshow(img)
        ax.set_title(EMOTION_NAMES[int(store.labels[int(idx)])].capitalize())
        ax.axis("off")
    fig.tight_layout()
    if out_path is not None:
        fig.savefig(out_path, dpi=120)
        plt.close(fig)
        return out_path
    plt.show()
    return fig


def _vit_fer_state_dict(model_path: str) -> Dict[str, torch.Tensor]:
    """The model weights of a ``vit_fer`` ``last_model.pt``: the port's
    (``torch.save`` of ``{epoch, state: {model, optimizer}, ...}``) or the
    JAX trainer's (Flax msgpack of ``{epoch, state: <TrainState bytes>,
    ...}``)."""
    if is_torch_checkpoint(model_path):
        payload = torch.load(model_path, map_location="cpu",
                             weights_only=True)
        return payload["state"]["model"]
    from fer_vit_tpu_torch.interop.flax_msgpack import msgpack_restore
    from fer_vit_tpu_torch.interop.from_jax import (
        timm_vit_state_dict_from_jax)

    with open(model_path, "rb") as f:
        payload = msgpack_restore(f.read())
    state = payload["state"] if "state" in payload else payload
    restored = msgpack_restore(state) if isinstance(state, bytes) else state
    params = restored["params"] if "params" in restored else restored
    return timm_vit_state_dict_from_jax(params)


def create_fer2013_inference_function(
    model_path: str, model_size: str = "base", img_size: int = 224,
    device: DeviceLike = None, dtype: Optional[torch.dtype] = None,
) -> Callable[[str], Dict]:
    """Single-image emotion predictor (reference: preprocessing.py:258-291).

    ``model_path``: a ``last_model.pt`` written by the port's or the JAX
    package's ``vit_fer``, or a converted timm ``.npz`` (raw pretrained
    weights; the 7-class head stays fresh, from seed 0). Returns
    ``predict(image_path) -> {'emotion', 'confidence', 'probabilities'}``.
    ``device`` defaults to CUDA; ``dtype`` is the compute dtype (None: bf16
    on CUDA, f32 on the CPU)."""
    from PIL import Image

    from fer_vit_tpu_torch.models.timm_vit import create_timm_vit

    dev = resolve_device(device)
    is_npz = model_path.endswith(".npz")
    model, patch = create_timm_vit(
        model_size, num_classes=7, img_size=img_size,
        pretrained_npz=model_path if is_npz else None, dtype=dtype,
        generator=torch.Generator().manual_seed(0))
    if patch is not None:
        patch(model)
    else:
        model.load_state_dict(_vit_fer_state_dict(model_path), strict=True)
    model = model.to(dev).eval()

    def predict(image_path: str) -> Dict:
        img = Image.open(image_path).convert("RGB").resize(
            (img_size, img_size))
        x = torch.from_numpy(np.asarray(img, np.float32)[None]).to(dev)
        x = (x / 255.0 - 0.5) / 0.5  # the reference ViT transform
        with torch.inference_mode():
            probs = torch.softmax(model(x).float(), dim=-1)[0].cpu().numpy()
        pred = int(probs.argmax())
        return {
            "emotion": EMOTION_NAMES[pred].capitalize(),
            "confidence": float(probs[pred]),
            "probabilities": {
                EMOTION_NAMES[i].capitalize(): float(p)
                for i, p in enumerate(probs)
            },
        }

    return predict
